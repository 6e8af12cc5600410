"""Expression IR -> PyTorch lowering: the subset of trino_tpu/ops/expr_lower.py
that the ported queries reach.

Lowered here: column refs, constants, searched CASE, the six comparisons
(numeric, date, decimal at a common scale, int128 two-limb, and varchar
equality/order on dictionary codes), ``and``/``or``/``not`` with Kleene
logic, ``between`` and ``in_list``, ``add``/``sub``/``mul``/``div`` over
decimals (with the reference's rescaling, value-range bounds and the
int128 path where a bound cannot prove an int64 fit), floats and integers,
``extract_year`` and ``date_add_months`` on dates, ``negate``, the
double functions ``sqrt``, ``ln``, ``log``, ``log10``, ``exp`` and
``power``, ``sign``, ``round``, ``ceil``/``floor``, ``greatest``/``least``,
and the
dictionary-first ``like`` and ``substring``: the string work runs on the
host once over the vocabulary, and each row is one gather by code on the
device. Any other expression kind raises NotImplementedError naming
itself.

A lowered value is ``LoweredVal(vals, valid, dictionary, bound, hi)``;
``valid`` is a bool tensor or None (all valid). Data-dependent errors
(division by zero, decimal overflow) are collected as flags on the context
and raised after execution, as in the reference.
"""
from __future__ import annotations

import dataclasses
import operator
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.dictionary import NULL_CODE, Dictionary
from trino_tpu_torch.data.page import Column, to_device, torch_dtype
from trino_tpu_torch.ops import datetime_ops as dt
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
    if isinstance(expr, ir.Case):
        return _lower_case(expr, ctx)
    if isinstance(expr, ir.Cast):
        return _lower_cast(expr, ctx)
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


def _lower_cast(expr: ir.Cast, ctx: LowerCtx) -> LoweredVal:
    """The numeric, decimal, typed-NULL and varchar-to-varchar casts of the
    reference's ``_lower_cast`` (what UPDATE's type-keeping rewrite and
    INSERT coercions produce). Timestamp, varbinary and to-varchar casts
    are not ported."""
    a = lower(expr.value, ctx)
    ft, tt = expr.value.type, expr.type
    if ft == tt:
        return a
    if ft == T.UNKNOWN and not tt.is_nested:
        # typed NULL: every row invalid, representation per target type
        dtype = tt.np_dtype if tt.np_dtype is not None else np.dtype(np.int32)
        return LoweredVal(
            _const_array(ctx, dtype, 0),
            torch.zeros((ctx.num_rows,), dtype=torch.bool, device=ctx.device),
            Dictionary([]) if tt.is_varchar else None)
    if isinstance(tt, T.TimestampType) or isinstance(ft, T.TimestampType):
        raise NotImplementedError(f"cast {ft} -> {tt} is not ported")
    if tt.is_floating:
        if a.hi is not None:
            raise NotImplementedError(f"cast of a two-limb {ft} to {tt} is not ported")
        v = a.vals.to(torch.float64)
        if ft.is_decimal:
            v = v / (10.0 ** _scale_of(ft))
        return LoweredVal(v.to(torch_dtype(tt.np_dtype)), a.valid, None)
    if tt.is_decimal:
        rs = _scale_of(tt)
        if a.hi is not None:
            from trino_tpu_torch.ops import int128 as i128

            out128, ov = i128.rescale_checked(as_i128(a), _scale_of(ft), rs)
            ctx.add_error(DECIMAL_OVERFLOW, ov, a.valid)
            return _finish128(ctx, out128, a.valid, tt)
        if ft.is_floating:
            scaled = a.vals.to(torch.float64) * (10.0**rs)
            # half away from zero, not round-half-to-even
            v = (torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5)).to(torch.int64)
            bound = None
        elif ft.is_decimal:
            v = _rescale_decimal(a.vals.to(torch.int64), _scale_of(ft), rs)
            bound = None if a.bound is None else _rescaled_bound(a.bound, _scale_of(ft), rs)
        else:
            v = a.vals.to(torch.int64) * (10**rs)
            bound = None if a.bound is None else a.bound * 10**rs
        return LoweredVal(v, a.valid, None, bound)
    if tt.is_integer_kind:
        if ft.is_decimal:
            if a.hi is not None:
                raise NotImplementedError(f"cast of a two-limb {ft} to {tt} is not ported")
            v = _rescale_decimal(a.vals.to(torch.int64), _scale_of(ft), 0)
            bound = None if a.bound is None else _rescaled_bound(a.bound, _scale_of(ft), 0)
        elif ft.is_floating:
            v = torch.sign(a.vals) * torch.floor(torch.abs(a.vals) + 0.5)
            bound = None
        else:
            v = a.vals
            bound = a.bound
        return LoweredVal(v.to(torch_dtype(tt.np_dtype)), a.valid, None, bound)
    if tt.is_varchar:
        if ft.is_varchar and not ft.is_varbinary and not tt.is_varbinary:
            return LoweredVal(a.vals, a.valid, a.dictionary)  # same codes
        raise NotImplementedError(f"cast {ft} -> {tt} is not ported")
    if tt == T.DATE and ft.is_varchar:
        raise NotImplementedError(f"cast {ft} -> {tt} is not ported")
    return LoweredVal(a.vals.to(torch_dtype(tt.np_dtype)), a.valid, a.dictionary)


def _align_varchar(a: LoweredVal, b: LoweredVal, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bring two varchar values onto one code space (dictionaries are
    order-preserving, so codes compare like strings)."""
    if a.dictionary is b.dictionary or a.dictionary.values == b.dictionary.values:
        return a.vals, b.vals
    merged = a.dictionary.merge(b.dictionary)
    return tuple(_code_lut(lv, lv.dictionary.recode_table(merged), NULL_CODE, device)
                 for lv in (a, b))


def as_i128(lv: LoweredVal):
    """LoweredVal -> (hi, lo) int128 limbs (sign-extending when narrow)."""
    lo = lv.vals.to(torch.int64)
    hi = lv.hi if lv.hi is not None else (lo >> 63)
    return hi, lo


def _compare(ctx: LowerCtx, op: Callable, a: LoweredVal, at: T.Type,
             b: LoweredVal, bt: T.Type) -> LoweredVal:
    """``op`` over two lowered operands of SQL types ``at`` and ``bt``."""
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


def _comparison(op: Callable) -> Callable:
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a, b = expr.args
        return _compare(ctx, op, lower(a, ctx), a.type, lower(b, ctx), b.type)

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
                prod, ovm = i128.mul_checked(as_i128(a), as_i128(b))
                ctx.add_error(DECIMAL_OVERFLOW, ovm, valid)
            else:
                prod = i128.mul_int64(av.to(torch.int64), bv.to(torch.int64))
            return _finish128(ctx, i128.rescale(prod, sa + sb, rs), valid, rt)
        out = _rescale_decimal(av.to(torch.int64) * bv.to(torch.int64), sa + sb, rs)
        return LoweredVal(out, valid, None, out_bound)
    if name == "div":
        shift = rs - sa + sb
        if b.hi is not None:
            # two-limb divisor: full 128/128 long division, half-up
            bh, bl = as_i128(b)
            is_zero = (bh == 0) & (bl == 0)
            ctx.add_error(DIVISION_BY_ZERO, is_zero, valid)
            num128, ovn = i128.rescale_checked(as_i128(a), 0, shift)
            ctx.add_error(DECIMAL_OVERFLOW, ovn, valid)
            nabs, nneg = i128.abs128(num128)
            dabs, dneg = i128.abs128((bh, torch.where(is_zero, torch.ones_like(bl), bl)))
            q, r = i128.divmod_u128(nabs, dabs)
            r2 = i128.add(r, r)  # round half away from zero: 2r >= d
            up = i128._ult(dabs[0], r2[0]) | ((r2[0] == dabs[0]) & i128._uge(r2[1], dabs[1]))
            q = i128.add(q, (torch.zeros_like(q[0]), up.to(torch.int64)))
            negq = i128.neg(q)
            flip = nneg ^ dneg
            out128 = (torch.where(flip, negq[0], q[0]), torch.where(flip, negq[1], q[1]))
            return _finish128(ctx, out128, valid, rt)
        ctx.add_error(DIVISION_BY_ZERO, bv == 0, valid)
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


def _lower_not(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    return LoweredVal(~a.vals, a.valid)


def _lower_is_null(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    if a.valid is None:
        return LoweredVal(torch.zeros((ctx.num_rows,), dtype=torch.bool, device=ctx.device),
                          None, None)
    return LoweredVal(~a.valid, None, None)


def _lower_between(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x, lo, hi = expr.args
    xl = lower(x, ctx)  # once: x may be host vocabulary work (substring)
    ge = _compare(ctx, operator.ge, xl, x.type, lower(lo, ctx), lo.type)
    le = _compare(ctx, operator.le, xl, x.type, lower(hi, ctx), hi.type)
    return LoweredVal(ge.vals & le.vals, and_valid(ge.valid, le.valid))


def _lower_in_list(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """x IN (c1, ..., cn): TRUE if any item matches; NULL if none matches
    and x or a list item is NULL; else FALSE. x is lowered once, not once
    per item: it may be host vocabulary work (Q22's substring)."""
    hits = None
    any_null_item = False
    x = expr.args[0]
    xl = lower(x, ctx)
    for item in expr.args[1:]:
        if isinstance(item, ir.Constant) and item.value is None:
            any_null_item = True
            continue
        eq = _compare(ctx, operator.eq, xl, x.type, lower(item, ctx), item.type)
        h = eq.vals if eq.valid is None else eq.vals & eq.valid
        hits = h if hits is None else hits | h
    if hits is None:
        hits = torch.zeros((ctx.num_rows,), dtype=torch.bool, device=ctx.device)
    x_null = torch.zeros_like(hits) if xl.valid is None else ~xl.valid
    unknown = (~hits) & (x_null | any_null_item)
    return LoweredVal(hits, ~unknown if (any_null_item or xl.valid is not None) else None)


def _code_lut(x: LoweredVal, lut: np.ndarray, miss, device) -> torch.Tensor:
    """Per-row gather of a host table indexed by dictionary code; NULL
    codes read ``miss``."""
    table = to_device(lut if len(lut) else np.full((1,), miss, lut.dtype), device)
    codes = x.vals.long()
    got = table[codes.clamp(0, max(len(lut) - 1, 0))]
    return torch.where(codes >= 0, got, torch.full_like(got, miss))


def _lower_like(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """LIKE on dictionary-coded varchar: the pattern runs on the host once
    over the vocabulary, and the device gathers the boolean table by code."""
    x = lower(expr.args[0], ctx)
    pat = expr.args[1]
    if not isinstance(pat, ir.Constant) or x.dictionary is None:
        raise NotImplementedError("LIKE with a non-literal pattern")
    rx = re.compile(_like_to_regex(pat.value), re.S)
    lut = np.array([rx.fullmatch(v) is not None for v in x.dictionary.values], dtype=bool)
    return LoweredVal(_code_lut(x, lut, False, ctx.device), x.valid)


def _like_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)


def _vocab_transform(ctx: LowerCtx, x: LoweredVal, fn) -> LoweredVal:
    """A host string -> string function applied once over the vocabulary,
    an order-preserving dictionary rebuilt from the results, and the codes
    recoded on the device by one gather."""
    mapped = [fn(v) for v in x.dictionary.values]
    d_new = Dictionary.build(mapped)
    lut = np.array([d_new.code_of(m) for m in mapped], dtype=np.int32)
    return LoweredVal(_code_lut(x, lut, NULL_CODE, ctx.device), x.valid, d_new)


def _sql_substring(v: str, start: int, length: Optional[int]) -> str:
    """Trino substr: 1-based; start 0 or out of range gives ''; a negative
    start counts from the end; the length bounds the window from the
    normalized start."""
    n = len(v)
    if start == 0:
        return ""
    if start > 0:
        if start > n:
            return ""
        i = start - 1
    else:
        if -start > n:
            return ""
        i = n + start
    end = n if length is None else min(n, i + max(length, 0))
    return v[i:end]


def _lower_substring(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    consts = expr.args[1:]
    if x.dictionary is None or not all(isinstance(c, ir.Constant) for c in consts):
        raise NotImplementedError("substring with non-literal bounds")
    start = int(consts[0].value)
    length = int(consts[1].value) if len(consts) > 1 else None
    return _vocab_transform(ctx, x, lambda v: _sql_substring(v, start, length))


def _lower_extract_year(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    t = expr.args[0].type
    if t != T.DATE:
        raise NotImplementedError(f"extract(year) over {t}")
    return LoweredVal(dt.extract_year(a.vals), a.valid)


def _lower_date_add_months(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    n = lower(expr.args[1], ctx)
    t = expr.args[0].type
    if t != T.DATE:
        raise NotImplementedError(f"date_add_months over {t}")
    out = dt.add_months(a.vals, n.vals).to(torch.int32)
    return LoweredVal(out, and_valid(a.valid, n.valid))


def _unify_branch_dicts(branches, device):
    """Branch values recoded onto one merged vocabulary (CASE results must
    agree on codes; literal and column dictionaries differ). Returns
    (recoded branches, merged dictionary)."""
    merged = None
    for v in branches:
        if v is None or v.dictionary is None:
            continue
        if merged is None:
            merged = v.dictionary
        elif merged.values != v.dictionary.values:
            merged = merged.merge(v.dictionary)
    if merged is None:
        return branches, None

    def recode(v):
        if v is None or v.dictionary is None or v.dictionary.values == merged.values:
            return v
        tbl = v.dictionary.recode_table(merged)
        return LoweredVal(_code_lut(v, tbl, NULL_CODE, device), v.valid, merged, hi=v.hi)

    return [recode(v) for v in branches], merged


def _lower_case(expr: ir.Case, ctx: LowerCtx) -> LoweredVal:
    """Searched CASE: the first WHEN whose condition is TRUE wins; no
    match and no ELSE gives NULL."""
    dtype = torch_dtype(expr.type.np_dtype)
    n = ctx.num_rows
    vals = torch.zeros((n,), dtype=dtype, device=ctx.device)
    valid = torch.zeros((n,), dtype=torch.bool, device=ctx.device)
    decided = torch.zeros_like(valid)
    true = torch.ones_like(valid)
    dictionary = None
    hi = None  # grows when any branch carries a two-limb long decimal
    conds = [lower(c, ctx) for c, _ in expr.whens]
    branch_vals = [lower(v, ctx) for _, v in expr.whens]
    default_l = lower(expr.default, ctx) if expr.default is not None else None
    if expr.type.is_varchar:
        unified, dictionary = _unify_branch_dicts(branch_vals + [default_l], ctx.device)
        branch_vals, default_l = unified[:-1], unified[-1]
    for c, v in zip(conds, branch_vals):
        cv = c.vals if c.valid is None else c.vals & c.valid
        take = cv & ~decided
        if v.hi is not None and hi is None:
            hi = vals.to(torch.int64) >> 63  # promote the branches so far
        if hi is not None:
            vh, vl = as_i128(v)
            vals = torch.where(take, vl, vals.to(torch.int64))
            hi = torch.where(take, vh, hi)
        else:
            vals = torch.where(take, v.vals.to(dtype), vals)
        valid = torch.where(take, v.valid if v.valid is not None else true, valid)
        decided = decided | take
    if default_l is not None:
        d = default_l
        if d.hi is not None and hi is None:
            hi = vals.to(torch.int64) >> 63
        if hi is not None:
            dh, dl = as_i128(d)
            vals = torch.where(decided, vals.to(torch.int64), dl)
            hi = torch.where(decided, hi, dh)
        else:
            vals = torch.where(decided, vals, d.vals.to(dtype))
        valid = torch.where(decided, valid, d.valid if d.valid is not None else true)
    return LoweredVal(vals, valid, dictionary, hi=hi)


def _arg_double(ctx: LowerCtx, arg: ir.Expr) -> LoweredVal:
    a = lower(arg, ctx)
    v = a.vals.to(torch.float64)
    if arg.type.is_decimal:
        v = v / (10.0 ** arg.type.scale)
    return LoweredVal(v, a.valid, None)


def _lower_math1(op):
    """Unary double math (sqrt, ln, log10, exp): a decimal argument converts
    through its scale; domain violations give NaN or inf."""

    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = _arg_double(ctx, expr.args[0])
        return LoweredVal(op(a.vals), a.valid, None)

    return fn


def _lower_log_b(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """log(base, x)."""
    b = _arg_double(ctx, expr.args[0])
    x = _arg_double(ctx, expr.args[1])
    return LoweredVal(torch.log(x.vals) / torch.log(b.vals), and_valid(b.valid, x.valid), None)


def _lower_power(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = _arg_double(ctx, expr.args[0])
    b = _arg_double(ctx, expr.args[1])
    return LoweredVal(torch.pow(a.vals, b.vals), and_valid(a.valid, b.valid), None)


def _lower_sign(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    if expr.args[0].type.is_floating:
        return LoweredVal(torch.sign(a.vals.to(torch.float64)), a.valid, None)
    return LoweredVal(torch.sign(a.vals).to(torch.int64), a.valid, None)


def _round_int_half_away(v: torch.Tensor, div: int) -> torch.Tensor:
    """Integers rounded to a multiple of ``div``, half away from zero."""
    v = v.to(torch.int64)
    return torch.sign(v) * _floordiv(torch.abs(v) + div // 2, div) * div


def _lower_round(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """round(x[, d]), half away from zero; ``d`` must be a literal."""
    a = lower(expr.args[0], ctx)
    t = expr.args[0].type
    d = 0
    if len(expr.args) > 1:
        if not isinstance(expr.args[1], ir.Constant):
            raise NotImplementedError("round() digits must be a literal")
        d = int(expr.args[1].value)
    if t.is_floating:
        factor = 10.0 ** d
        scaled = a.vals.to(torch.float64) * factor
        return LoweredVal(torch.sign(scaled) * torch.floor(torch.abs(scaled) + 0.5) / factor,
                          a.valid, None)
    if t.is_decimal:
        if d >= t.scale:
            return a
        return LoweredVal(_round_int_half_away(a.vals, 10 ** (t.scale - d)), a.valid, None)
    if d >= 0:
        return a  # integers are whole already
    return LoweredVal(_round_int_half_away(a.vals, 10 ** (-d)).to(a.vals.dtype), a.valid, None)


def _lower_ceil_floor(is_ceil: bool):
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = lower(expr.args[0], ctx)
        t = expr.args[0].type
        if t.is_floating:
            op = torch.ceil if is_ceil else torch.floor
            return LoweredVal(op(a.vals.to(torch.float64)), a.valid, None)
        if t.is_decimal and t.scale > 0:
            div = 10 ** t.scale
            v = a.vals.to(torch.int64)
            q = -_floordiv(-v, div) if is_ceil else _floordiv(v, div)
            return LoweredVal(q * div, a.valid, None)
        return a

    return fn


def _lower_extremum(is_greatest: bool):
    """greatest/least: NULL if any argument is NULL. Varchar operands move
    onto one merged (order-preserving) dictionary first."""

    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        parts = [lower(a, ctx) for a in expr.args]
        op = torch.maximum if is_greatest else torch.minimum
        if expr.type.is_varchar:
            acc = parts[0]
            for p in parts[1:]:
                av, bv = _align_varchar(acc, p, ctx.device)
                merged = (acc.dictionary if acc.dictionary.values == p.dictionary.values
                          else acc.dictionary.merge(p.dictionary))
                acc = LoweredVal(op(av, bv), and_valid(acc.valid, p.valid), merged)
            return acc
        out, valid = parts[0].vals, parts[0].valid
        for p in parts[1:]:
            dt = torch.promote_types(out.dtype, p.vals.dtype)
            out = op(out.to(dt), p.vals.to(dt))
            valid = and_valid(valid, p.valid)
        return LoweredVal(out, valid, None)

    return fn


def _lower_negate(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    if a.hi is not None:
        from trino_tpu_torch.ops import int128 as i128

        nhi, nlo = i128.neg(as_i128(a))
        return LoweredVal(nlo, a.valid, None, hi=nhi)
    return LoweredVal(-a.vals, a.valid, None)


FUNCTIONS: Dict[str, Callable[..., LoweredVal]] = {
    "eq": _comparison(operator.eq),
    "ne": _comparison(operator.ne),
    "lt": _comparison(operator.lt),
    "le": _comparison(operator.le),
    "gt": _comparison(operator.gt),
    "ge": _comparison(operator.ge),
    "add": _arith("add"),
    "sub": _arith("sub"),
    "mul": _arith("mul"),
    "div": _arith("div"),
    "and": _lower_and,
    "or": _lower_or,
    "not": _lower_not,
    "is_null": _lower_is_null,
    "between": _lower_between,
    "in_list": _lower_in_list,
    "like": _lower_like,
    "substring": _lower_substring,
    "extract_year": _lower_extract_year,
    "date_add_months": _lower_date_add_months,
    "negate": _lower_negate,
    "sqrt": _lower_math1(torch.sqrt),
    "ln": _lower_math1(torch.log),
    "log_b": _lower_log_b,
    "log10": _lower_math1(torch.log10),
    "exp": _lower_math1(torch.exp),
    "power": _lower_power,
    "sign": _lower_sign,
    "round": _lower_round,
    "ceil": _lower_ceil_floor(True),
    "ceiling": _lower_ceil_floor(True),
    "floor": _lower_ceil_floor(False),
    "greatest": _lower_extremum(True),
    "least": _lower_extremum(False),
}
