"""Expression IR -> PyTorch lowering: the subset of trino_tpu/ops/expr_lower.py
that the ported queries reach.

Lowered here: column refs, constants, the six comparisons (numeric, date,
decimal at a common scale, int128 two-limb, and varchar equality/order on
dictionary codes), ``and``/``or`` with Kleene logic, and
``add``/``sub``/``mul``/``div`` over decimals (with the reference's
rescaling, value-range bounds and the int128 path where a bound cannot
prove an int64 fit), floats and integers. Any other expression kind raises
NotImplementedError naming itself.

A lowered value is ``LoweredVal(vals, valid, dictionary, bound, hi)``;
``valid`` is a bool tensor or None (all valid). Data-dependent errors
(division by zero, decimal overflow) are collected as flags on the context
and raised after execution, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.dictionary import NULL_CODE, Dictionary
from trino_tpu_torch.data.page import Column, to_device, torch_dtype
from trino_tpu_torch.sql import ir

DIVISION_BY_ZERO = "DIVISION_BY_ZERO"
DECIMAL_OVERFLOW = "DECIMAL_OVERFLOW"


@dataclasses.dataclass
class LoweredVal:
    vals: torch.Tensor
    valid: Optional[torch.Tensor]  # bool tensor; None = all valid
    dictionary: Optional[Dictionary] = None
    # static bound on |stored value| (Python int; None = unknown) from
    # column stats, propagated by interval arithmetic: lets decimal ops
    # skip the int128 path when every intermediate provably fits int64
    bound: Optional[int] = None
    hi: Optional[torch.Tensor] = None  # long-decimal high limb


class LowerCtx:
    """Input columns, the page's selection mask, the device, and collected
    error conditions (which fire only for valid, selected rows)."""

    def __init__(self, columns: List[Column], num_rows: int,
                 sel: Optional[torch.Tensor], device):
        self.columns = columns
        self.num_rows = num_rows
        self.sel = sel
        self.device = device
        self.errors: List[Tuple[str, torch.Tensor]] = []

    def add_error(self, code: str, cond: torch.Tensor, live: Optional[torch.Tensor]):
        if live is not None:
            cond = cond & live
        if self.sel is not None:
            cond = cond & self.sel
        self.errors.append((code, cond.any()))


def and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def lower(expr: ir.Expr, ctx: LowerCtx) -> LoweredVal:
    if isinstance(expr, ir.ColumnRef):
        col = ctx.columns[expr.index]
        if col.type.is_nested:
            raise NotImplementedError(f"lowering a {col.type} column")
        valid = None if col.nulls is None else ~col.nulls
        bound = None
        if col.vrange is not None and not col.values.dtype.is_floating_point:
            bound = max(abs(int(col.vrange[0])), abs(int(col.vrange[1])))
        return LoweredVal(col.values, valid, col.dictionary, bound, hi=col.hi)
    if isinstance(expr, ir.Constant):
        return _lower_constant(expr, ctx)
    if isinstance(expr, ir.Call):
        fn = FUNCTIONS.get(expr.name)
        if fn is None:
            raise NotImplementedError(f"scalar function not ported: {expr.name}")
        return fn(ctx, expr)
    raise NotImplementedError(f"expression not ported: {type(expr).__name__}")


def _const_array(ctx: LowerCtx, np_dtype, value) -> torch.Tensor:
    return torch.full((ctx.num_rows,), value, dtype=torch_dtype(np_dtype),
                      device=ctx.device)


def _lower_constant(expr: ir.Constant, ctx: LowerCtx) -> LoweredVal:
    t = expr.type
    if t.is_nested:
        raise NotImplementedError(f"{t} constant")
    if expr.value is None:
        dtype = t.np_dtype if t.np_dtype is not None else np.dtype(np.int32)
        return LoweredVal(
            _const_array(ctx, dtype, 0),
            torch.zeros((ctx.num_rows,), dtype=torch.bool, device=ctx.device), None)
    if t.is_varchar:
        return LoweredVal(_const_array(ctx, np.int32, 0), None, Dictionary([expr.value]))
    bound = None
    if not (t.is_floating or t == T.BOOLEAN):
        bound = abs(int(expr.value))
    return LoweredVal(_const_array(ctx, t.np_dtype, expr.value), None, None, bound)


def _align_varchar(a: LoweredVal, b: LoweredVal, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bring two varchar values onto one code space (dictionaries are
    order-preserving, so codes compare like strings)."""
    if a.dictionary is b.dictionary or a.dictionary.values == b.dictionary.values:
        return a.vals, b.vals
    merged = a.dictionary.merge(b.dictionary)

    def recode(lv: LoweredVal) -> torch.Tensor:
        t = np.asarray(lv.dictionary.recode_table(merged))
        table = to_device(t if len(t) else np.array([NULL_CODE], np.int32), device)
        codes = lv.vals
        return torch.where(codes >= 0, table[codes.long().clamp(min=0)],
                           torch.full_like(codes, NULL_CODE))

    return recode(a), recode(b)


def as_i128(lv: LoweredVal):
    """LoweredVal -> (hi, lo) int128 limbs (sign-extending when narrow)."""
    lo = lv.vals.to(torch.int64)
    hi = lv.hi if lv.hi is not None else (lo >> 63)
    return hi, lo


def _comparison(op: Callable) -> Callable:
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = lower(expr.args[0], ctx)
        b = lower(expr.args[1], ctx)
        at, bt = expr.args[0].type, expr.args[1].type
        if a.hi is not None or b.hi is not None:
            # two-limb operand(s): compare as int128 at the common scale
            from trino_tpu_torch.ops import int128 as i128

            if at.is_floating or bt.is_floating:
                raise NotImplementedError("comparing a long decimal with a float")
            s = max(_scale_of(at), _scale_of(bt))
            a128 = i128.rescale(as_i128(a), _scale_of(at), s)
            b128 = i128.rescale(as_i128(b), _scale_of(bt), s)
            cmp = i128.compare(a128, b128)
            return LoweredVal(op(cmp, torch.zeros_like(cmp)), and_valid(a.valid, b.valid))
        if at.is_varchar and bt.is_varchar:
            av, bv = _align_varchar(a, b, ctx.device)
        elif at.is_nested or bt.is_nested or at.is_varchar or bt.is_varchar:
            raise NotImplementedError(f"comparing {at} with {bt}")
        else:
            av, bv = _numeric_align(a.vals, at, b.vals, bt)
        return LoweredVal(op(av, bv), and_valid(a.valid, b.valid))

    return fn


def _numeric_align(av, at: T.Type, bv, bt: T.Type):
    """Bring two numeric/date values to one comparable representation."""
    if at.is_timestamp or bt.is_timestamp:
        raise NotImplementedError(f"comparing {at} with {bt}")
    if at.is_decimal or bt.is_decimal:
        sa, sb = _scale_of(at), _scale_of(bt)
        if at.is_floating or bt.is_floating:
            fa = av.to(torch.float64) / (10.0**sa) if at.is_decimal else av
            fb = bv.to(torch.float64) / (10.0**sb) if bt.is_decimal else bv
            return fa.to(torch.float64), fb.to(torch.float64)
        s = max(sa, sb)
        return (av.to(torch.int64) * (10 ** (s - sa)),
                bv.to(torch.int64) * (10 ** (s - sb)))
    if at.is_floating != bt.is_floating:
        return av.to(torch.float64), bv.to(torch.float64)
    return av, bv


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _rescale_decimal(v: torch.Tensor, from_scale: int, to_scale: int) -> torch.Tensor:
    if to_scale == from_scale:
        return v
    if to_scale > from_scale:
        return v * (10 ** (to_scale - from_scale))
    # round half-up away from zero (Trino decimal rescale semantics)
    div = 10 ** (from_scale - to_scale)
    return torch.sign(v) * _floordiv(torch.abs(v) + div // 2, div)


def _scale_of(t: T.Type) -> int:
    return t.scale if isinstance(t, T.DecimalType) else 0


def _prec_of(t: T.Type) -> int:
    if isinstance(t, T.DecimalType):
        return t.precision
    return {"tinyint": 3, "smallint": 5, "integer": 10}.get(t.name, 19)


def _finish128(ctx, out128, valid, rt: T.Type, bound=None) -> LoweredVal:
    """Finish an int128 result: flag DECIMAL_OVERFLOW past 10^p, store
    two-limb for p > 18 and narrow to int64 for short results."""
    from trino_tpu_torch.ops import int128 as i128

    p = min(_prec_of(rt), 38)
    limit = 10**p
    (ahi, alo), _ = i128.abs128(out128)
    lo_bits = limit & (2**64 - 1)
    lo_signed = lo_bits - 2**64 if lo_bits >= 2**63 else lo_bits
    lim = (torch.full_like(ahi, limit >> 64), torch.full_like(alo, lo_signed))
    over = i128.compare((ahi, alo), lim) >= 0
    ctx.add_error(DECIMAL_OVERFLOW, over, valid)
    if p > 18:
        return LoweredVal(out128[1], valid, None, bound, hi=out128[0])
    return LoweredVal(i128.to_int64(out128), valid, None, bound)


def _rescaled_bound(bound: int, from_scale: int, to_scale: int) -> int:
    if to_scale >= from_scale:
        return bound * 10 ** (to_scale - from_scale)
    return bound // 10 ** (from_scale - to_scale) + 1


_INT64_SAFE = 2**62  # int128-skip threshold: proven intermediates below this


def _decimal_arith(name: str, ctx: LowerCtx, a: LoweredVal, b: LoweredVal,
                   at: T.Type, bt: T.Type, rt: T.Type, valid) -> LoweredVal:
    from trino_tpu_torch.ops import int128 as i128

    av, bv = a.vals, b.vals
    ba, bb = a.bound, b.bound
    rs = _scale_of(rt)
    sa, sb = _scale_of(at), _scale_of(bt)
    pa, pb = _prec_of(at), _prec_of(bt)
    two_limb_in = a.hi is not None or b.hi is not None
    have_bounds = ba is not None and bb is not None and not two_limb_in
    out_bound = None
    if name in ("add", "sub"):
        need128 = two_limb_in or max(pa + (rs - sa), pb + (rs - sb)) > 18
        if have_bounds:
            s = _rescaled_bound(ba, sa, rs) + _rescaled_bound(bb, sb, rs)
            if not need128 or s < _INT64_SAFE:
                need128 = False
                out_bound = s
        if need128:
            a128, ova = i128.rescale_checked(as_i128(a), sa, rs)
            b128, ovb = i128.rescale_checked(as_i128(b), sb, rs)
            ctx.add_error(DECIMAL_OVERFLOW, ova | ovb, valid)
            out128 = i128.add(a128, b128) if name == "add" else i128.sub(a128, b128)
            return _finish128(ctx, out128, valid, rt)
        av = _rescale_decimal(av.to(torch.int64), sa, rs)
        bv = _rescale_decimal(bv.to(torch.int64), sb, rs)
        return LoweredVal(av + bv if name == "add" else av - bv, valid, None, out_bound)
    if name == "mul":
        need128 = two_limb_in or pa + pb + 1 > 18
        if have_bounds:
            prod_bound = ba * bb * (10 ** max(rs - sa - sb, 0))
            if prod_bound < _INT64_SAFE:
                need128 = False
                out_bound = _rescaled_bound(ba * bb, sa + sb, rs)
        if need128:
            if two_limb_in:
                raise NotImplementedError("multiplying long decimals")
            prod = i128.mul_int64(av.to(torch.int64), bv.to(torch.int64))
            return _finish128(ctx, i128.rescale(prod, sa + sb, rs), valid, rt)
        out = _rescale_decimal(av.to(torch.int64) * bv.to(torch.int64), sa + sb, rs)
        return LoweredVal(out, valid, None, out_bound)
    if name == "div":
        if b.hi is not None:
            raise NotImplementedError("dividing by a long decimal")
        ctx.add_error(DIVISION_BY_ZERO, bv == 0, valid)
        shift = rs - sa + sb
        den64 = torch.where(bv == 0, torch.ones_like(bv), bv).to(torch.int64)
        need128 = two_limb_in or pa + shift > 18
        if need128 and have_bounds and ba * 10 ** max(shift, 0) < _INT64_SAFE:
            need128 = False
            out_bound = ba * 10 ** max(shift, 0)
        if need128:
            # 128-bit numerator / 64-bit divisor, half-up
            num128, ovn = i128.rescale_checked(as_i128(a), 0, shift)
            ctx.add_error(DECIMAL_OVERFLOW, ovn, valid)
            (nhi, nlo), nneg = i128.abs128(num128)
            dabs = torch.abs(den64)
            q, r = i128.divmod_u64_arr((nhi, nlo), dabs)
            up = i128._uge(r * 2, dabs)
            q = i128.add(q, (torch.zeros_like(q[0]), up.to(torch.int64)))
            negq = i128.neg(q)
            flip = nneg ^ (den64 < 0)
            out128 = (torch.where(flip, negq[0], q[0]), torch.where(flip, negq[1], q[1]))
            return _finish128(ctx, out128, valid, rt)
        num = av.to(torch.int64) * (10 ** shift)
        q = _floordiv(torch.abs(num) + _floordiv(torch.abs(den64), 2), torch.abs(den64))
        return LoweredVal(torch.sign(num) * torch.sign(den64) * q, valid, None, out_bound)
    raise NotImplementedError(f"decimal {name}")


def _arith(name: str):
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = lower(expr.args[0], ctx)
        b = lower(expr.args[1], ctx)
        at, bt, rt = expr.args[0].type, expr.args[1].type, expr.type
        valid = and_valid(a.valid, b.valid)
        if rt.is_decimal and not (at.is_floating or bt.is_floating):
            return _decimal_arith(name, ctx, a, b, at, bt, rt, valid)
        av, bv = a.vals, b.vals
        if rt.is_floating:
            fdt = torch.float64 if rt == T.DOUBLE else torch.float32
            fa = av.to(torch.float64) / (10.0 ** _scale_of(at)) if at.is_decimal else av
            fb = bv.to(torch.float64) / (10.0 ** _scale_of(bt)) if bt.is_decimal else bv
            fa, fb = fa.to(fdt), fb.to(fdt)
            out = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                   "div": torch.div}[name](fa, fb)
            return LoweredVal(out, valid)
        # integer kinds (and date +/- integer days)
        dt = torch_dtype(rt.np_dtype)
        av, bv = av.to(dt), bv.to(dt)
        have = a.bound is not None and b.bound is not None
        if name in ("add", "sub"):
            out = av + bv if name == "add" else av - bv
            bound = a.bound + b.bound if have else None
        elif name == "mul":
            out = av * bv
            bound = a.bound * b.bound if have else None
        else:
            ctx.add_error(DIVISION_BY_ZERO, bv == 0, valid)
            den = torch.where(bv == 0, torch.ones_like(bv), bv)
            out = torch.sign(av) * torch.sign(den) * _floordiv(torch.abs(av), torch.abs(den))
            bound = a.bound if have else None
        return LoweredVal(out, valid, None, bound)

    return fn


def _lower_and(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """Kleene AND: FALSE dominates NULL."""
    a = lower(expr.args[0], ctx)
    b = lower(expr.args[1], ctx)
    if a.valid is None and b.valid is None:
        return LoweredVal(a.vals & b.vals, None)
    a_valid = a.valid if a.valid is not None else torch.ones_like(a.vals)
    b_valid = b.valid if b.valid is not None else torch.ones_like(b.vals)
    known_false = ((~a.vals) & a_valid) | ((~b.vals) & b_valid)
    return LoweredVal((a.vals | ~a_valid) & (b.vals | ~b_valid),
                      known_false | (a_valid & b_valid))


def _lower_or(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """Kleene OR: TRUE dominates NULL."""
    a = lower(expr.args[0], ctx)
    b = lower(expr.args[1], ctx)
    if a.valid is None and b.valid is None:
        return LoweredVal(a.vals | b.vals, None)
    a_valid = a.valid if a.valid is not None else torch.ones_like(a.vals)
    b_valid = b.valid if b.valid is not None else torch.ones_like(b.vals)
    known_true = (a.vals & a_valid) | (b.vals & b_valid)
    return LoweredVal(known_true, known_true | (a_valid & b_valid))


FUNCTIONS: Dict[str, Callable[..., LoweredVal]] = {
    "eq": _comparison(lambda a, b: a == b),
    "ne": _comparison(lambda a, b: a != b),
    "lt": _comparison(lambda a, b: a < b),
    "le": _comparison(lambda a, b: a <= b),
    "gt": _comparison(lambda a, b: a > b),
    "ge": _comparison(lambda a, b: a >= b),
    "add": _arith("add"),
    "sub": _arith("sub"),
    "mul": _arith("mul"),
    "div": _arith("div"),
    "and": _lower_and,
    "or": _lower_or,
}
