"""Expression IR -> PyTorch lowering: the port of trino_tpu/ops/expr_lower.py
for every scalar expression over flat types.

Lowered here: column refs, constants, searched CASE, casts (numeric,
decimal, typed NULL, timestamp precision and date <-> timestamp, and
varchar <-> varbinary re-encoding), the six comparisons (numeric, date and
timestamp at a common precision, decimal at a common scale, int128
two-limb, and varchar order on dictionary codes), Kleene
``and``/``or``/``not``, ``between``, ``in_list``, the arithmetic
``add``/``sub``/``mul``/``div``/``mod`` over decimals (with the
reference's rescaling, value-range bounds and the int128 path), floats and
integers, and the scalar function families: math (``abs``, ``sign``,
rounding, ``truncate``, the exponential, logarithm and trigonometric
functions, ``greatest``/``least``, the float classes), bitwise on int64
patterns, ``coalesce``/``nullif``, date and timestamp (every ``extract``
field, ``date_trunc``, the differences, ``date_format``/``date_parse``,
the day and month names), the strings, the JSON scalars, varbinary
(hex, utf8, md5, sha256) and ``random``/``now``/``current_date``; and
the nested types: the array, map and row constructors, field access,
subscripts and ``element_at``, ``cardinality``, ``contains``,
``array_position``, ``array_min``/``max``/``sum``, ``map_keys``/``values``,
array equality and the lambdas (``transform``, ``any``/``all``/``none_match``),
over ``ops/array_ops.py``.

String work is dictionary-first: a function runs on the host once for each
distinct value of the vocabulary (or once a day of a bounded table of
days), and each row is one gather by code on the device. An expression
the reference does not lower raises NotImplementedError naming itself.

A lowered value is ``LoweredVal(vals, valid, dictionary, bound, hi,
children)``; a nested value holds per-row lengths in ``vals`` and the
flattened element values in ``children``, as ``Column`` does;
``valid`` is a bool tensor or None (all valid). Data-dependent errors
(division by zero, overflow, an invalid function argument) are collected as
flags on the context and raised after execution, as in the reference.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import operator
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.dictionary import NULL_CODE, Dictionary, VocabBytes
from trino_tpu_torch.data.page import Column, to_device, torch_dtype
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.ops import array_ops as A
from trino_tpu_torch.ops import datetime_ops as dt
from trino_tpu_torch.sql import ir

DIVISION_BY_ZERO = "DIVISION_BY_ZERO"
DECIMAL_OVERFLOW = "DECIMAL_OVERFLOW"
NUMERIC_OVERFLOW = "NUMERIC_VALUE_OUT_OF_RANGE"
INVALID_FUNCTION_ARGUMENT = "INVALID_FUNCTION_ARGUMENT"


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
    # nested values: the flattened children (array: [elements], map:
    # [keys, values], row: the fields), as data/page.py Column.children
    children: Optional[List["LoweredVal"]] = None


class LowerCtx:
    """Input columns, the page's selection mask, the device, the session's
    random generator, and collected error conditions (which fire only for
    valid, selected rows)."""

    def __init__(self, columns: List[Column], num_rows: int,
                 sel: Optional[torch.Tensor], device, generator=None):
        self.columns = columns
        self.num_rows = num_rows
        self.sel = sel
        self.device = device
        self.generator = generator
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
        valid = None if col.nulls is None else ~col.nulls
        bound = None
        if col.vrange is not None and not col.values.dtype.is_floating_point:
            bound = max(abs(int(col.vrange[0])), abs(int(col.vrange[1])))
        children = None
        if col.children is not None:
            # one level, as the reference: a child's own children and high
            # limb are not carried
            children = [LoweredVal(k.values, None if k.nulls is None else ~k.nulls,
                                   k.dictionary) for k in col.children]
        return LoweredVal(col.values, valid, col.dictionary, bound, hi=col.hi,
                          children=children)
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


def _all_null(ctx: LowerCtx) -> torch.Tensor:
    return torch.zeros((ctx.num_rows,), dtype=torch.bool, device=ctx.device)


def _lower_constant(expr: ir.Constant, ctx: LowerCtx) -> LoweredVal:
    t = expr.type
    if expr.value is None:
        dtype = t.np_dtype if t.np_dtype is not None else np.dtype(np.int32)
        children = None
        if t.is_nested:
            children = [
                LoweredVal(torch.zeros((0,), dtype=torch_dtype(ct.np_dtype or np.int64),
                                       device=ctx.device),
                           None, Dictionary([]) if ct.is_varchar else None)
                for ct in T.type_children(t)]
        return LoweredVal(_const_array(ctx, dtype, 0), _all_null(ctx), None,
                          children=children)
    if t.is_varchar:
        return LoweredVal(_const_array(ctx, np.int32, 0), None, Dictionary([expr.value]))
    bound = None
    if not (t.is_floating or t == T.BOOLEAN):
        bound = abs(int(expr.value))
    return LoweredVal(_const_array(ctx, t.np_dtype, expr.value), None, None, bound)


def _typed_null_nested(ctx: LowerCtx, tt: T.Type) -> LoweredVal:
    """A typed NULL of a nested type: every row NULL; a row's fields have
    its rows, an array's or map's children are empty."""
    def null_child(ct: T.Type, n: int) -> LoweredVal:
        kids = ([null_child(k, n if isinstance(ct, T.RowType) else 0)
                 for k in T.type_children(ct)] if ct.is_nested else None)
        if ct.is_varchar:
            vals = torch.full((n,), NULL_CODE, dtype=torch.int32, device=ctx.device)
        else:
            vals = torch.zeros((n,), dtype=torch_dtype(ct.np_dtype or np.int32),
                               device=ctx.device)
        return LoweredVal(vals, torch.zeros((n,), dtype=torch.bool, device=ctx.device),
                          Dictionary([]) if ct.is_varchar else None, children=kids)

    n = ctx.num_rows
    flat_n = n if isinstance(tt, T.RowType) else 0
    return LoweredVal(_const_array(ctx, tt.np_dtype or np.dtype(np.int32), 0), _all_null(ctx),
                      None, children=[null_child(k, flat_n) for k in T.type_children(tt)])


def _lower_cast(expr: ir.Cast, ctx: LowerCtx) -> LoweredVal:
    """The reference's ``_lower_cast`` for flat types. Casts of a
    non-varchar value to varchar and of a varchar to a date are refused, as
    in the reference."""
    a = lower(expr.value, ctx)
    ft, tt = expr.value.type, expr.type
    if ft == tt:
        return a
    if ft == T.UNKNOWN and tt.is_nested:
        return _typed_null_nested(ctx, tt)
    if ft == T.UNKNOWN:
        # typed NULL: every row invalid, representation per target type
        dtype = tt.np_dtype if tt.np_dtype is not None else np.dtype(np.int32)
        return LoweredVal(_const_array(ctx, dtype, 0), _all_null(ctx),
                          Dictionary([]) if tt.is_varchar else None)
    if isinstance(tt, T.TimestampType):
        if isinstance(ft, T.TimestampType):
            # precision rescale, half up as a decimal rescale; the
            # with-time-zone flip keeps the UTC storage
            v = _rescale_decimal(a.vals.to(torch.int64), ft.precision, tt.precision)
            return LoweredVal(v, a.valid, None)
        if ft == T.DATE:
            return LoweredVal(a.vals.to(torch.int64) * (86_400 * 10**tt.precision),
                              a.valid, None)
        raise NotImplementedError(f"cast {ft} -> {tt} is not ported")
    if tt == T.DATE and isinstance(ft, T.TimestampType):
        unit = 86_400 * 10**ft.precision
        return LoweredVal(_floordiv(a.vals.to(torch.int64), unit).to(torch.int32),
                          a.valid, None)
    if tt.is_floating:
        if a.hi is not None:
            return LoweredVal(_to_float128(a, ft).to(torch_dtype(tt.np_dtype)), a.valid, None)
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
                from trino_tpu_torch.ops import int128 as i128

                out128 = i128.rescale(as_i128(a), _scale_of(ft), 0)
                ctx.add_error(NUMERIC_OVERFLOW, ~i128.fits_int64(out128), a.valid)
                return LoweredVal(i128.to_int64(out128).to(torch_dtype(tt.np_dtype)),
                                  a.valid, None)
            v = _rescale_decimal(a.vals.to(torch.int64), _scale_of(ft), 0)
            bound = None if a.bound is None else _rescaled_bound(a.bound, _scale_of(ft), 0)
        elif ft.is_floating:
            v = torch.sign(a.vals) * torch.floor(torch.abs(a.vals) + 0.5)
            bound = None
        else:
            v = a.vals
            bound = a.bound
        return LoweredVal(v.to(torch_dtype(tt.np_dtype)), a.valid, None, bound)
    if tt == T.DATE and ft.is_varchar:
        raise NotImplementedError(f"cast {ft} -> {tt} is not ported")
    if tt.is_varchar:
        # varbinary rides the dictionary as hex text: a cast re-encodes
        # through the vocabulary (UTF-8 both ways)
        if ft.is_varbinary and not tt.is_varbinary:
            return _vocab_transform(ctx, a, _utf8_of_hex)
        if ft.is_varchar and not ft.is_varbinary and tt.is_varbinary:
            return _vocab_transform(ctx, a, lambda s: s.encode().hex())
        if ft.is_varchar:  # varchar(n) <-> varchar: the same codes
            return LoweredVal(a.vals, a.valid, a.dictionary)
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


def _to_float128(lv: LoweredVal, t: T.Type) -> torch.Tensor:
    """A two-limb (or plain) numeric value -> float64 at its decimal scale.
    The low word converts as unsigned: its two 32-bit halves are exact in
    float64, so their sum rounds once, as a uint64 conversion does."""
    if lv.hi is None:
        v = lv.vals.to(torch.float64)
    else:
        from trino_tpu_torch.ops import int128 as i128

        lo = lv.vals.to(torch.int64)
        ulo = (i128._lsr(lo, 32).to(torch.float64) * float(2**32)
               + (lo & i128._MASK32).to(torch.float64))
        v = lv.hi.to(torch.float64) * float(2**64) + ulo
    if t.is_decimal:
        v = v / (10.0 ** _scale_of(t))
    return v


def _compare(ctx: LowerCtx, op: Callable, a: LoweredVal, at: T.Type,
             b: LoweredVal, bt: T.Type) -> LoweredVal:
    """``op`` over two lowered operands of SQL types ``at`` and ``bt``. Two
    arrays compare for equality whatever ``op`` (negated for ``ne``), as in
    the reference; the analyzer refuses their ordering comparisons."""
    if at.is_array and bt.is_array:
        out = _array_equal(a, b, ctx.device)
        return LoweredVal(~out.vals, out.valid) if op is operator.ne else out
    if a.hi is not None or b.hi is not None:
        # two-limb operand(s): compare as int128 at the common scale
        from trino_tpu_torch.ops import int128 as i128

        if at.is_floating or bt.is_floating:
            return LoweredVal(op(_to_float128(a, at), _to_float128(b, bt)),
                              and_valid(a.valid, b.valid))
        s = max(_scale_of(at), _scale_of(bt))
        a128 = i128.rescale(as_i128(a), _scale_of(at), s)
        b128 = i128.rescale(as_i128(b), _scale_of(bt), s)
        cmp = i128.compare(a128, b128)
        return LoweredVal(op(cmp, torch.zeros_like(cmp)), and_valid(a.valid, b.valid))
    if at.is_varchar and bt.is_varchar:
        av, bv = _align_varchar(a, b, ctx.device)
    elif at.is_varchar or bt.is_varchar:
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
    """Bring two numeric/date/timestamp values to one comparable
    representation."""
    if at.is_timestamp or bt.is_timestamp:
        # timestamps compare at the larger precision; a date is the UTC
        # midnight of its day
        p = max(t.precision for t in (at, bt) if isinstance(t, T.TimestampType))

        def up(v, t):
            if t == T.DATE:
                return v.to(torch.int64) * (86_400 * 10**p)
            if not isinstance(t, T.TimestampType):
                raise NotImplementedError(f"comparing {at} with {bt}")
            return v.to(torch.int64) * (10 ** (p - t.precision))

        return up(av, at), up(bv, bt)
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


def _trunc_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SQL ``%`` on integers as the reference computes it:
    ``sign(a) * (|a| mod |b|)``, with no truncating division (which
    traps on INT64_MIN / -1 on the CPU)."""
    return torch.sign(a) * torch.remainder(torch.abs(a), torch.abs(b))


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
    if name == "mod":
        if two_limb_in:
            # no limb kernel: the low words, with a deferred overflow flag
            # where a value does not fit them
            for opnd in (a, b):
                if opnd.hi is not None:
                    lo64 = opnd.vals.to(torch.int64)
                    ctx.add_error(DECIMAL_OVERFLOW, opnd.hi != (lo64 >> 63), valid)
        s = max(sa, sb)
        av = _rescale_decimal(av.to(torch.int64), sa, s)
        bv = _rescale_decimal(bv.to(torch.int64), sb, s)
        ctx.add_error(DIVISION_BY_ZERO, bv == 0, valid)
        out = _rescale_decimal(_trunc_mod(av, torch.where(bv == 0, torch.ones_like(bv), bv)),
                               s, rs)
        if have_bounds:
            bound_s = min(_rescaled_bound(ba, sa, s), _rescaled_bound(bb, sb, s))
            out_bound = _rescaled_bound(bound_s, s, rs)
        return LoweredVal(out, valid, None, out_bound)
    raise NotImplementedError(f"decimal {name}")


def _float_mod(fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """The reference's float ``%``: ``a - b * trunc(a / b)``, NaN for a
    zero divisor (not ``fmod``, whose bits can differ)."""
    return torch.where(fb != 0, fa - fb * torch.trunc(fa / fb),
                       torch.full_like(fa, float("nan")))


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
                   "div": torch.div, "mod": _float_mod}[name](fa, fb)
            return LoweredVal(out, valid)
        # integer kinds (and date +/- integer days)
        dt_ = torch_dtype(rt.np_dtype)
        av, bv = av.to(dt_), bv.to(dt_)
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
            if name == "div":
                out = torch.sign(av) * torch.sign(den) * _floordiv(torch.abs(av), torch.abs(den))
                bound = a.bound if have else None
            else:
                out = _trunc_mod(av, den)
                bound = min(a.bound, b.bound) if have else None
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
        return LoweredVal(_all_null(ctx), None, None)
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
        hits = _all_null(ctx)
    x_null = torch.zeros_like(hits) if xl.valid is None else ~xl.valid
    unknown = (~hits) & (x_null | any_null_item)
    return LoweredVal(hits, ~unknown if (any_null_item or xl.valid is not None) else None)


# ------------------------------------------------------------------ strings
# A varchar function is a dictionary transform: the host applies it once to
# each vocabulary entry, and the device gathers by code. Every gather clamps
# its index as the reference's does, and a NULL code (-1) reads the
# reference's fill value.


def _host_pass(fn, entries: int, **attributes):
    """A host pass of ``fn`` over a vocabulary or a table of days of
    ``entries`` values: the ``exec/host-pass`` span, whose seconds go to
    SCALAR_HOST_SECONDS. ``fn`` is named by the lowering that made it
    (``substring`` for ``_lower_substring``'s inner function); ``attributes``
    go to the span."""
    name = getattr(fn, "__qualname__", type(fn).__name__).split(".<locals>")[0]
    return tracing.timed("exec/host-pass", M.SCALAR_HOST_SECONDS, detail=True,
                         fn=name.removeprefix("_lower_"), entries=entries, **attributes)


def _code_lut(x: LoweredVal, lut: np.ndarray, miss, device) -> torch.Tensor:
    """Per-row gather of a host table indexed by dictionary code; NULL
    codes read ``miss``."""
    table = to_device(lut if len(lut) else np.full((1,), miss, lut.dtype), device)
    codes = x.vals.long()
    got = table[codes.clamp(0, max(len(lut) - 1, 0))]
    return torch.where(codes >= 0, got, torch.full_like(got, miss))


def _vocab_codes(ctx: LowerCtx, x: LoweredVal, mapped: List[Optional[str]]):
    """(recoded codes, new dictionary) for the per-entry results
    ``mapped``: an order-preserving dictionary built from them, and one
    gather on the device. A None result decodes as NULL."""
    d_new = Dictionary.build(mapped)
    lut = np.array([d_new.code_of(m) for m in mapped], dtype=np.int32)
    return _code_lut(x, lut, NULL_CODE, ctx.device), d_new


def _vocab_transform(ctx: LowerCtx, x: LoweredVal, fn, **attributes) -> LoweredVal:
    """A host string -> string function applied once over the vocabulary,
    an order-preserving dictionary rebuilt from the results, and the codes
    recoded on the device by one gather. ``attributes`` go to the span."""
    with _host_pass(fn, len(x.dictionary.values), **attributes):
        mapped = [fn(v) for v in x.dictionary.values]
        codes, d_new = _vocab_codes(ctx, x, mapped)
    return LoweredVal(codes, x.valid, d_new)


def _vocab_transform_where(ctx: LowerCtx, x: LoweredVal, fn) -> LoweredVal:
    """As ``_vocab_transform`` for a function that may have no answer:
    ``fn`` returns (string, present) and a row whose entry is not present
    is NULL. One host pass gives both tables."""
    with _host_pass(fn, len(x.dictionary.values)):
        res = [fn(v) for v in x.dictionary.values]
        codes, d_new = _vocab_codes(ctx, x, [s for s, _ in res])
        has = np.array([h for _, h in res], dtype=np.bool_)
    present = _code_lut(x, has, False, ctx.device)
    return LoweredVal(codes, and_valid(x.valid, present), d_new)


def _vocab_lut(ctx: LowerCtx, x: LoweredVal, fn, np_dtype) -> LoweredVal:
    """varchar -> scalar by a table of the host function's result for each
    vocabulary entry; NULL codes read zero."""
    with _host_pass(fn, len(x.dictionary.values)):
        lut = np.array([fn(v) for v in x.dictionary.values], dtype=np_dtype)
    return LoweredVal(_code_lut(x, lut, lut.dtype.type(0).item(), ctx.device), x.valid, None)


def _const_str_args(expr: ir.Call, start: int, stop: Optional[int] = None) -> List[str]:
    out = []
    for a in expr.args[start:stop]:
        if not (isinstance(a, ir.Constant) and isinstance(a.value, str)):
            raise NotImplementedError(
                f"{expr.name}: pattern arguments must be varchar literals")
        out.append(a.value)
    return out


def _const_int_arg(expr: ir.Call, i: int, what: str) -> int:
    a = expr.args[i]
    if not isinstance(a, ir.Constant):
        raise NotImplementedError(f"{expr.name}: the {what} must be a literal")
    return int(a.value)


def _lower_like(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """LIKE on dictionary-coded varchar: the pattern runs on the host once
    over the vocabulary, and the device gathers the boolean table by code."""
    x = lower(expr.args[0], ctx)
    pat = expr.args[1]
    if not isinstance(pat, ir.Constant) or x.dictionary is None:
        raise NotImplementedError("LIKE with a non-literal pattern")
    rx = re.compile(_like_to_regex(pat.value), re.S)
    return _vocab_lut(ctx, x, lambda v: rx.fullmatch(v) is not None, np.bool_)


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


def _substring_table(vocab: VocabBytes, start: int, length: Optional[int]):
    """``_sql_substring`` over every entry of an ASCII vocabulary in one
    numpy pass: (the dictionary of the distinct results, each entry's code
    in it as int32). Each entry's window comes from its length, gathered
    into zero-padded rows as wide as the longest result; one ``np.unique``
    over the rows gives the results in bytewise order, which is the
    dictionary's order for ASCII, and each entry's index among them."""
    n = vocab.lengths
    widest = int(n.max()) if len(n) else 0
    # bounds past every entry act as those just past the longest one, so
    # the int64 arithmetic below cannot overflow
    start = max(min(start, widest + 1), -widest - 1)
    if start > 0:
        i = np.full_like(n, start - 1)
    elif start < 0:
        i = n + start
    else:
        i = n  # start 0: an empty window at every entry
    take = n - i
    if length is not None:
        take = np.minimum(take, max(min(length, widest), 0))
    take = np.where(i >= 0, np.maximum(take, 0), 0)  # a start past either end gives ''
    first = vocab.offsets[:-1] + i
    k = int(take.max()) if len(take) else 0
    rows = np.zeros((len(n), max(k, 1)), dtype=np.uint8)
    for j in range(k):  # one column of result bytes at a time
        at = np.clip(first + j, 0, len(vocab.data) - 1)
        rows[:, j] = np.where(take > j, vocab.data[at], 0)
    results, codes = np.unique(rows.view(f"S{rows.shape[1]}")[:, 0], return_inverse=True)
    return Dictionary([r.decode("ascii") for r in results.tolist()]), codes.astype(np.int32)


def _lower_substring(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """One host pass over the vocabulary: vectorized over its bytes where
    every character is one byte and no entry holds a NUL, else one
    ``_sql_substring`` call an entry."""
    x = lower(expr.args[0], ctx)
    consts = expr.args[1:]
    if x.dictionary is None or not all(isinstance(c, ir.Constant) for c in consts):
        raise NotImplementedError("substring with non-literal bounds")
    start = int(consts[0].value)
    length = int(consts[1].value) if len(consts) > 1 else None

    def substring(v):
        return _sql_substring(v, start, length)

    vocab = x.dictionary.byte_form()
    if not vocab.ascii:
        M.SUBSTRING_ENTRY_PASSES.inc()
        return _vocab_transform(ctx, x, substring, path="entries")
    M.SUBSTRING_VECTOR_PASSES.inc()
    with _host_pass(substring, len(x.dictionary.values), path="vector"):
        d_new, table = _substring_table(vocab, start, length)
        codes = _code_lut(x, table, NULL_CODE, ctx.device)
    return LoweredVal(codes, x.valid, d_new)


def _lower_str_fn(pyfn) -> Callable:
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        return _vocab_transform(ctx, lower(expr.args[0], ctx), pyfn)

    return fn


def _lower_replace(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    frm, to = (_const_str_args(expr, 1) + [""])[:2]
    return _vocab_transform(ctx, x, lambda v: v.replace(frm, to))


def _lower_reverse(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    return _vocab_transform(ctx, lower(expr.args[0], ctx), lambda v: v[::-1])


def _lower_strpos(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    (sub,) = _const_str_args(expr, 1)
    return _vocab_lut(ctx, x, lambda v: v.find(sub) + 1, np.int64)


def _lower_starts_with(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    (prefix,) = _const_str_args(expr, 1)
    return _vocab_lut(ctx, x, lambda v: v.startswith(prefix), np.bool_)


def _lower_length(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    if expr.args[0].type.is_varbinary:
        # the dictionary holds hex: two digits a byte
        return _vocab_lut(ctx, x, lambda s: len(s) // 2, np.int64)
    return _vocab_lut(ctx, x, len, np.int64)


def _lower_concat(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """concat where at most one argument is a column (a vocabulary
    transform); two or more varchar columns are refused, as in the
    reference (it needs a product of dictionaries)."""
    if any(isinstance(a, ir.Constant) and a.value is None for a in expr.args):
        # a NULL argument makes every row NULL
        return LoweredVal(_const_array(ctx, np.int32, 0), _all_null(ctx), Dictionary([""]))
    col_args = [a for a in expr.args if not isinstance(a, ir.Constant)]
    if not col_args:
        s = "".join(_concat_text(a) for a in expr.args)
        return LoweredVal(_const_array(ctx, np.int32, 0), None, Dictionary([s]))
    if len(col_args) > 1:
        raise NotImplementedError("concat of multiple varchar columns")
    (col_e,) = col_args
    i = expr.args.index(col_e)
    pre = "".join(_concat_text(a) for a in expr.args[:i])
    post = "".join(_concat_text(a) for a in expr.args[i + 1:])
    return _vocab_transform(ctx, lower(col_e, ctx), lambda v: pre + v + post)


def _concat_text(a: ir.Constant) -> str:
    """A constant concat argument as its cast-to-varchar text: scaled
    integers print as decimals, epoch days as ISO dates."""
    if isinstance(a.value, str):
        return a.value
    if isinstance(a.value, bool):
        return "true" if a.value else "false"
    t = a.type
    if t.is_decimal:
        from decimal import Decimal

        return str(Decimal(int(a.value)).scaleb(-t.scale))
    if t == T.DATE:
        return (datetime.date(1970, 1, 1) + datetime.timedelta(days=int(a.value))).isoformat()
    return str(a.value)


def _lower_regexp(kind: str):
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        x = lower(expr.args[0], ctx)
        pattern = re.compile(_const_str_args(expr, 1, 2)[0])
        if kind == "like":
            return _vocab_lut(ctx, x, lambda v: pattern.search(v) is not None, np.bool_)
        if kind == "count":
            return _vocab_lut(ctx, x, lambda v: len(pattern.findall(v)), np.int64)
        if kind == "extract":
            group = _const_int_arg(expr, 2, "regexp group") if len(expr.args) == 3 else 0

            def ext(v):
                m = pattern.search(v)
                # no match is NULL, not ''
                return (m.group(group), True) if m else ("", False)

            return _vocab_transform_where(ctx, x, ext)
        repl = _const_str_args(expr, 2)[0] if len(expr.args) == 3 else ""
        repl_py = re.sub(r"\$(\d+)", r"\\\1", repl)  # $1 -> \1 (Trino syntax)
        return _vocab_transform(ctx, x, lambda v: pattern.sub(repl_py, v))

    return fn


def _lower_pad(left: bool):
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        x = lower(expr.args[0], ctx)
        size = _const_int_arg(expr, 1, "pad size")
        pad = _const_str_args(expr, 2)[0] if len(expr.args) == 3 else " "

        def dopad(v):
            if len(v) >= size:
                return v[:size]
            fill = (pad * size)[: size - len(v)]
            return fill + v if left else v + fill

        return _vocab_transform(ctx, x, dopad)

    return fn


def _lower_split_part(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    (delim,) = _const_str_args(expr, 1, 2)
    idx = _const_int_arg(expr, 2, "split_part index")

    def part(v):
        parts = v.split(delim)
        if 1 <= idx <= len(parts):
            return parts[idx - 1], True
        return "", False  # an index out of range is NULL

    return _vocab_transform_where(ctx, x, part)


def _lower_translate(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    frm, to = _const_str_args(expr, 1)
    table = {ord(f): (to[i] if i < len(to) else None) for i, f in enumerate(frm)}
    return _vocab_transform(ctx, x, lambda v: v.translate(table))


def _lower_repeat_str(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    k = _const_int_arg(expr, 1, "repeat count")
    return _vocab_transform(ctx, x, lambda v: v * k)


def _lower_chr(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = expr.args[0]
    if isinstance(a, ir.Constant):
        return LoweredVal(_const_array(ctx, np.int32, 0), None,
                          Dictionary([chr(int(a.value))]))
    raise NotImplementedError("chr() over a column (value-dependent vocabulary)")


def _lower_codepoint(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    return _vocab_lut(ctx, lower(expr.args[0], ctx), lambda v: ord(v[0]) if v else 0, np.int64)


def _levenshtein(v: str, other: str) -> int:
    if not v:
        return len(other)
    prev = list(range(len(other) + 1))
    for i, cv in enumerate(v, 1):
        cur = [i]
        for j, co in enumerate(other, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (cv != co)))
        prev = cur
    return prev[-1]


def _lower_str_distance(kind: str):
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        x = lower(expr.args[0], ctx)
        other = _const_str_args(expr, 1)[0]
        if kind == "hamming":
            def dist(v):
                if len(v) != len(other):
                    return -1  # strings of different lengths: an error
                return sum(a != b for a, b in zip(v, other))
        else:
            def dist(v):
                return _levenshtein(v, other)

        out = _vocab_lut(ctx, x, dist, np.int64)
        if kind == "hamming":
            ctx.add_error(INVALID_FUNCTION_ARGUMENT, out.vals < 0, out.valid)
        return out

    return fn


def _json_scalar(v: str, steps) -> Optional[str]:
    try:
        cur = json.loads(v)
    except (ValueError, TypeError):
        return None
    for s in steps:
        if isinstance(s, int):
            if not isinstance(cur, list) or not -len(cur) <= s < len(cur):
                return None
        elif not isinstance(cur, dict) or s not in cur:
            return None
        cur = cur[s]
    if cur is None or isinstance(cur, (dict, list)):
        return None  # json_extract_scalar: scalars only
    if isinstance(cur, bool):
        return "true" if cur else "false"
    return str(cur)


def _lower_json_extract_scalar(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    steps = _parse_json_path(_const_str_args(expr, 1)[0])

    def ext(v):
        got = _json_scalar(v, steps)
        return (got or "", got is not None)

    return _vocab_transform_where(ctx, x, ext)


def _parse_json_path(path: str):
    """The JSON path subset $.a.b[0]['c']: the lax mode's field and
    subscript steps."""
    steps = []
    s = path.strip()
    if not s.startswith("$"):
        raise NotImplementedError(f"json path must start with $: {path!r}")
    s = s[1:]
    token = re.compile(r"\.(\w+)|\[(\d+)\]|\['([^']*)'\]|\[\"([^\"]*)\"\]")
    pos = 0
    while pos < len(s):
        m = token.match(s, pos)
        if not m:
            raise NotImplementedError(f"unsupported json path step at {s[pos:]!r}")
        if m.group(1) is not None:
            steps.append(m.group(1))
        elif m.group(2) is not None:
            steps.append(int(m.group(2)))
        else:
            steps.append(m.group(3) if m.group(3) is not None else m.group(4))
        pos = m.end()
    return steps


def _lower_json_array_length(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)

    def ln(v):
        try:
            arr = json.loads(v)
        except (ValueError, TypeError):
            return -1
        return len(arr) if isinstance(arr, list) else -1

    out = _vocab_lut(ctx, x, ln, np.int64)
    return LoweredVal(out.vals, and_valid(out.valid, out.vals >= 0), None)


# ---------------------------------------------------------------- varbinary


def _utf8_of_hex(h: str) -> str:
    return bytes.fromhex(h).decode(errors="replace")


def _lower_binary_fn(kind: str):
    """The varbinary family over the hex dictionary: each function is a
    vocabulary transform."""

    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        x = lower(expr.args[0], ctx)
        if kind == "to_hex":
            return _vocab_transform(ctx, x, str.upper)
        if kind == "from_hex":
            return _lower_from_hex(ctx, x)
        if kind == "to_utf8":
            return _vocab_transform(ctx, x, lambda s: s.encode().hex())
        if kind == "from_utf8":
            return _vocab_transform(ctx, x, _utf8_of_hex)
        digest = {"md5": hashlib.md5, "sha256": hashlib.sha256}[kind]
        return _vocab_transform(ctx, x, lambda h: digest(bytes.fromhex(h)).hexdigest())

    return fn


def _lower_from_hex(ctx: LowerCtx, x: LoweredVal) -> LoweredVal:
    """from_hex over the whole vocabulary, which may hold entries no live
    row reaches: a bad entry becomes a NULL slot, and a deferred
    INVALID_FUNCTION_ARGUMENT fires only where a live row references it."""
    bad_codes = []

    def conv(i_s):
        i, s = i_s
        try:
            return bytes.fromhex(s).hex()
        except ValueError:
            bad_codes.append(i)
            return ""

    with _host_pass(conv, len(x.dictionary.values)):
        mapped = [conv(i_s) for i_s in enumerate(x.dictionary.values)]
        codes, d_new = _vocab_codes(ctx, x, mapped)
    if not bad_codes:
        return LoweredVal(codes, x.valid, d_new)
    bad = torch.isin(x.vals, to_device(np.array(bad_codes, np.int32), ctx.device))
    ctx.add_error(INVALID_FUNCTION_ARGUMENT, bad, x.valid)
    valid = (x.valid if x.valid is not None else torch.ones_like(bad)) & ~bad
    return LoweredVal(codes, valid, d_new)


# ------------------------------------------------------------ date and time


def _lower_coalesce(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """The first non-NULL argument. Varchar arguments go onto one merged
    dictionary first, as CASE's branches do: the reference keeps the first
    argument's dictionary and decodes the others' codes against it."""
    parts = [lower(expr.args[0], ctx)]
    if parts[0].valid is None:
        return parts[0]
    parts += [lower(e, ctx) for e in expr.args[1:]]
    dictionary = None
    if expr.type.is_varchar:
        parts, dictionary = _unify_branch_dicts(parts, ctx.device)
    acc = parts[0]
    for nxt in parts[1:]:
        hi = None
        if acc.hi is not None or nxt.hi is not None:
            ah, al = as_i128(acc)
            bh, bl = as_i128(nxt)
            vals = torch.where(acc.valid, al, bl)
            hi = torch.where(acc.valid, ah, bh)
        else:
            dt_ = torch.promote_types(acc.vals.dtype, nxt.vals.dtype)
            vals = torch.where(acc.valid, acc.vals.to(dt_), nxt.vals.to(dt_))
        nxt_valid = nxt.valid if nxt.valid is not None else torch.ones_like(acc.valid)
        acc = LoweredVal(vals, acc.valid | nxt_valid,
                         dictionary or acc.dictionary or nxt.dictionary, hi=hi)
    return acc


def _ts_split(vals: torch.Tensor, t: T.Type):
    """Timestamp storage -> (epoch days, the in-day remainder in units,
    units a second). Floor division keeps instants before 1970 on their
    day."""
    unit = 10 ** t.precision
    day = 86_400 * unit
    v = vals.to(torch.int64)
    days = _floordiv(v, day)
    return days.to(torch.int32), v - days * day, unit


def _lower_extract(field: str):
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = lower(expr.args[0], ctx)
        t = expr.args[0].type
        days = a.vals
        if isinstance(t, T.TimestampType):
            days, rem, unit = _ts_split(a.vals, t)
            secs = _floordiv(rem, unit)
            if field == "hour":
                return LoweredVal(_floordiv(secs, 3600), a.valid, None)
            if field == "minute":
                return LoweredVal(torch.remainder(_floordiv(secs, 60), 60), a.valid, None)
            if field == "second":
                return LoweredVal(torch.remainder(secs, 60), a.valid, None)
        elif field in ("hour", "minute", "second"):
            raise NotImplementedError(f"extract({field}) over {t}")
        return LoweredVal(getattr(dt, f"extract_{field}")(days), a.valid, None)

    return fn


def _lower_date_add_months(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    n = lower(expr.args[1], ctx)
    t = expr.args[0].type
    valid = and_valid(a.valid, n.valid)
    if isinstance(t, T.TimestampType):
        # the day moves through the calendar; the time of day stays
        days, rem, unit = _ts_split(a.vals, t)
        out = dt.add_months(days, n.vals) * (86_400 * unit) + rem
        return LoweredVal(out, valid, None)
    return LoweredVal(dt.add_months(a.vals, n.vals).to(torch.int32), valid, None)


def _lower_diff_units(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """date_diff in whole units of ``per`` storage steps (days of a date,
    units of a timestamp), truncated toward zero."""
    a = lower(expr.args[0], ctx)
    b = lower(expr.args[1], ctx)
    per = int(expr.args[2].value)
    d = b.vals.to(torch.int64) - a.vals.to(torch.int64)
    q = torch.sign(d) * _floordiv(torch.abs(d), per)
    return LoweredVal(q, and_valid(a.valid, b.valid), None)


def _lower_months_between(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """Whole calendar months from a to b, a partial last month not
    counted, divided by the unit (12 for years). The day-of-month compare
    clamps to each end's month length, so Jan 31 -> Feb 29 is one month."""
    a = lower(expr.args[0], ctx)
    b = lower(expr.args[1], ctx)
    mul = int(expr.args[2].value)
    ya, ma, da = dt.civil_from_days(a.vals)
    yb, mb, db = dt.civil_from_days(b.vals)
    months = (yb - ya) * 12 + (mb - ma)
    da_in_b = torch.minimum(da, dt.days_in_month(yb, mb))
    db_in_a = torch.minimum(db, dt.days_in_month(ya, ma))
    months = months - ((months > 0) & (db < da_in_b)).to(torch.int64)
    months = months + ((months < 0) & (db_in_a > da)).to(torch.int64)
    q = torch.sign(months) * _floordiv(torch.abs(months), mul)
    return LoweredVal(q, and_valid(a.valid, b.valid), None)


def _lower_seconds_to_ts3(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    ms = a.vals.to(torch.float64) * 1000.0
    v = (torch.sign(ms) * torch.floor(torch.abs(ms) + 0.5)).to(torch.int64)
    return LoweredVal(v, a.valid, None)


def _lower_date_trunc(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    (unit,) = _const_str_args(expr, 0, 1)
    a = lower(expr.args[1], ctx)
    return LoweredVal(dt.trunc_date(a.vals, unit.lower()).to(torch.int32), a.valid, None)


_MYSQL_FMT = {  # date_format's MySQL specifiers -> strftime's
    "%Y": "%Y", "%y": "%y", "%m": "%m", "%d": "%d", "%e": "%-d",
    "%H": "%H", "%i": "%M", "%s": "%S", "%f": "%f", "%W": "%A",
    "%a": "%a", "%b": "%b", "%M": "%B", "%j": "%j", "%%": "%%",
}


def _mysql_to_py_fmt(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            spec = fmt[i: i + 2]
            out.append(_MYSQL_FMT.get(spec, spec))
            i += 2
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


_DAY_TABLE_RANGE = (-25567, 47847)  # 1900-01-01 .. 2100-12-31


def _date_lut(ctx: LowerCtx, x: LoweredVal, pyfn) -> LoweredVal:
    """date (epoch days) -> string through a table of days, bounded by the
    column's static value range or 1900..2100: the value is the code. A
    live date outside the table raises INVALID_FUNCTION_ARGUMENT (the
    table is an implementation bound, not a semantic one)."""
    lo, hi = _DAY_TABLE_RANGE
    if x.bound is not None:
        lo, hi = max(-x.bound, lo), min(x.bound, hi)
    epoch = datetime.date(1970, 1, 1)
    with _host_pass(pyfn, hi - lo + 1):
        strings = [pyfn(epoch + datetime.timedelta(days=d)) for d in range(lo, hi + 1)]
        d_new = Dictionary.build(strings)
        lut = to_device(np.array([d_new.code_of(s) for s in strings], dtype=np.int32),
                        ctx.device)
    idx = (x.vals.to(torch.int64) - lo).clamp(0, lut.shape[0] - 1)
    in_range = (x.vals >= lo) & (x.vals <= hi)
    ctx.add_error(INVALID_FUNCTION_ARGUMENT, ~in_range, x.valid)
    return LoweredVal(lut[idx], and_valid(x.valid, in_range), d_new)


def _lower_date_format(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    fmt = _mysql_to_py_fmt(_const_str_args(expr, 1)[0])
    if expr.args[0].type == T.TIMESTAMP:
        raise NotImplementedError("date_format over timestamps (use a date)")
    return _date_lut(ctx, x, lambda d: d.strftime(fmt))


_BAD_DATE = -(10**9)


def _lower_date_parse(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    fmt = _mysql_to_py_fmt(_const_str_args(expr, 1)[0])
    epoch = datetime.date(1970, 1, 1)

    def parse(v):
        try:
            return (datetime.datetime.strptime(v, fmt).date() - epoch).days
        except ValueError:
            return _BAD_DATE

    out = _vocab_lut(ctx, x, parse, np.int32)
    ctx.add_error(INVALID_FUNCTION_ARGUMENT, out.vals == _BAD_DATE, out.valid)
    return out


def _lower_day_name(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    return _date_lut(ctx, lower(expr.args[0], ctx), lambda d: d.strftime("%A"))


def _lower_month_name(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    return _date_lut(ctx, lower(expr.args[0], ctx), lambda d: d.strftime("%B"))


def _lower_last_day_of_month(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x = lower(expr.args[0], ctx)
    y, m, d = dt.civil_from_days(x.vals)
    days = x.vals.to(torch.int32)
    last = days - d.to(torch.int32) + dt.days_in_month(y, m).to(torch.int32)
    return LoweredVal(last, x.valid, None)


def _unify_branch_dicts(branches, device):
    """Branch values recoded onto one merged vocabulary (CASE and coalesce
    results must agree on codes; literal and column dictionaries differ).
    Returns (recoded branches, merged dictionary)."""
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
        return LoweredVal(_code_lut(v, tbl, NULL_CODE, device), v.valid, merged, hi=v.hi,
                          children=v.children)

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


# --------------------------------------------------------------------- math


def _arg_double(ctx: LowerCtx, arg: ir.Expr) -> LoweredVal:
    a = lower(arg, ctx)
    v = a.vals.to(torch.float64)
    if arg.type.is_decimal:
        v = v / (10.0 ** arg.type.scale)
    return LoweredVal(v, a.valid, None)


def _lower_math1(op):
    """Unary double math: a decimal argument converts through its scale;
    domain violations give NaN or inf."""

    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = _arg_double(ctx, expr.args[0])
        return LoweredVal(op(a.vals), a.valid, None)

    return fn


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no cbrt op): |x|^(1/3) with x's sign, then
    one Newton step y - (y - x/y^2)/3, which brings exact cubes to their
    root (27 -> 3). Zeros, infinities and NaN keep the first estimate."""
    y = torch.copysign(torch.pow(torch.abs(x), 1.0 / 3.0), x)
    ok = torch.isfinite(y) & (y != 0)
    ys = torch.where(ok, y, torch.ones_like(y))
    return torch.where(ok, ys - (ys - x / (ys * ys)) / 3.0, y)


_POW10_RANGE = (-307, 308)  # 10^k as a normal double
_POW10 = np.array([float(f"1e{k}") for k in range(_POW10_RANGE[0], _POW10_RANGE[1] + 1)])


def _log10(x: torch.Tensor) -> torch.Tensor:
    """log10 with exact powers of ten: the device's log10 need not be
    correctly rounded there (the reference's host numpy is: log10(1000) is
    3), so where the rounded result k has 10^k equal to the input, the
    result is k. The nearest double to 10^k has k as its correctly rounded
    log10 for every normal k, so this changes only results that drifted.
    All on the device: one table of 616 doubles, a gather and a select."""
    r = torch.log10(x)
    k = torch.round(torch.nan_to_num(r, nan=0.0, posinf=0.0, neginf=0.0))
    k = k.clamp(*_POW10_RANGE)
    hit = to_device(_POW10, x.device)[k.to(torch.int64) - _POW10_RANGE[0]] == x
    return torch.where(hit, k, r)


def _lower_log_b(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """log(base, x)."""
    b = _arg_double(ctx, expr.args[0])
    x = _arg_double(ctx, expr.args[1])
    return LoweredVal(torch.log(x.vals) / torch.log(b.vals), and_valid(b.valid, x.valid), None)


def _lower_power(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = _arg_double(ctx, expr.args[0])
    b = _arg_double(ctx, expr.args[1])
    return LoweredVal(torch.pow(a.vals, b.vals), and_valid(a.valid, b.valid), None)


def _lower_atan2(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = _arg_double(ctx, expr.args[0])
    b = _arg_double(ctx, expr.args[1])
    return LoweredVal(torch.atan2(a.vals, b.vals), and_valid(a.valid, b.valid), None)


def _lower_sign(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    if expr.args[0].type.is_floating:
        v = a.vals.to(torch.float64)
        # torch.sign gives 0 for NaN and +0 for -0; SQL's sign (and the
        # reference's) gives the argument back for both
        return LoweredVal(torch.where(torch.isnan(v) | (v == 0), v, torch.sign(v)),
                          a.valid, None)
    return LoweredVal(torch.sign(a.vals).to(torch.int64), a.valid, None)


def _lower_abs(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    if a.hi is not None:
        from trino_tpu_torch.ops import int128 as i128

        (ahi, alo), _ = i128.abs128(as_i128(a))
        return LoweredVal(alo, a.valid, None, hi=ahi)
    return LoweredVal(torch.abs(a.vals), a.valid, None)


def _lower_nullif(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    x, y = expr.args
    a = lower(x, ctx)
    eq = _compare(ctx, operator.eq, a, x.type, lower(y, ctx), y.type)
    hit = eq.vals if eq.valid is None else eq.vals & eq.valid
    return LoweredVal(a.vals, ~hit if a.valid is None else a.valid & ~hit,
                      a.dictionary, hi=a.hi)


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


def _lower_truncate(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """truncate(x[, d]): the digits past d decimal places dropped, toward
    zero."""
    a = lower(expr.args[0], ctx)
    t = expr.args[0].type
    d = _const_int_arg(expr, 1, "digits") if len(expr.args) == 2 else 0
    if t.is_floating:
        p = 10.0 ** d
        return LoweredVal(torch.trunc(a.vals * p) / p, a.valid, None)
    if t.is_decimal:
        p = 10 ** max(t.scale - d, 0)
        v = a.vals
        q = torch.where(v >= 0, _floordiv(v, p), -_floordiv(-v, p))
        return LoweredVal(q * p, a.valid, None)
    return LoweredVal(a.vals, a.valid, None)


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
            dt_ = torch.promote_types(out.dtype, p.vals.dtype)
            out = op(out.to(dt_), p.vals.to(dt_))
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


def _lower_bitwise(op: str):
    """Bitwise functions on int64 patterns. A right shift is logical (the
    sign-extended bits masked off); a shift of 64 or more gives 0 and a
    negative one is an invalid argument."""

    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = lower(expr.args[0], ctx)
        av = a.vals.to(torch.int64)
        if op == "not":
            return LoweredVal(~av, a.valid, None)
        b = lower(expr.args[1], ctx)
        bv = b.vals.to(torch.int64)
        valid = and_valid(a.valid, b.valid)
        if op in ("and", "or", "xor"):
            return LoweredVal({"and": operator.and_, "or": operator.or_,
                               "xor": operator.xor}[op](av, bv), valid, None)
        ctx.add_error(INVALID_FUNCTION_ARGUMENT, bv < 0, valid)
        in_range = (bv >= 0) & (bv < 64)
        sh = bv.clamp(0, 63)
        if op == "lshift":
            out = av << sh
        else:
            # keep the low 64 - sh bits of the arithmetic shift
            out = (av >> sh) & ~((torch.full_like(sh, -1) << (63 - sh)) << 1)
        return LoweredVal(torch.where(in_range, out, torch.zeros_like(out)), valid, None)

    return fn


_POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def _lower_bit_count(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """Set bits of the int64 pattern: a byte table over its eight bytes."""
    a = lower(expr.args[0], ctx)
    v = a.vals.to(torch.int64)
    lut = to_device(_POPCOUNT8, v.device)
    cnt = torch.zeros_like(v)
    for shift in range(0, 64, 8):
        cnt = cnt + lut[(v >> shift) & 0xFF]
    return LoweredVal(cnt, a.valid, None)


def _lower_float_class(kind: str):
    op = {"nan": torch.isnan, "finite": torch.isfinite, "inf": torch.isinf}[kind]

    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = lower(expr.args[0], ctx)
        return LoweredVal(op(a.vals.to(torch.float64)), a.valid, None)

    return fn


# ----------------------------------------------------- nondeterministic


def _lower_random(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """random() -> double in [0, 1), one draw a row on the context's device
    from the session's generator."""
    vals = torch.rand((ctx.num_rows,), dtype=torch.float64, device=ctx.device,
                      generator=ctx.generator)
    return LoweredVal(vals, None, None)


def _lower_now(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """now() -> timestamp(3): one instant an evaluation."""
    v = int(time.time() * 1000)
    return LoweredVal(_const_array(ctx, np.int64, v), None, None, abs(v))


def _lower_current_date(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    days = int(time.time() // 86_400)
    return LoweredVal(_const_array(ctx, np.int32, days), None, None, days)


# ------------------------------------------------------------ nested types
# arrays, maps and rows (ops/array_ops.py); reference: the array/map section
# of trino_tpu/ops/expr_lower.py


def _array_equal(a: LoweredVal, b: LoweredVal, device) -> LoweredVal:
    """SQL array equality: a length mismatch is false; so is any definite
    element mismatch; else NULL if a compared pair holds a NULL; else true.
    Runs over the left flat layout with clamped gathers into the right's."""
    a_len = a.vals.to(torch.int32)
    b_len = b.vals.to(torch.int32)
    a_off = A.offsets_from_lengths(a_len)
    b_off = A.offsets_from_lengths(b_len)
    ae, be = a.children[0], b.children[0]
    av, bv = ae.vals, be.vals
    if ae.dictionary is not None and be.dictionary is not None:
        av, bv = _align_varchar(LoweredVal(av, None, ae.dictionary),
                                LoweredVal(bv, None, be.dictionary), device)
    flat_n = int(av.shape[0])
    lens_eq = a_len == b_len
    if flat_n == 0:
        return LoweredVal(lens_eq, and_valid(a.valid, b.valid))
    rowid = A.rowid_of_flat(a_off, flat_n).long()
    row = _row_index(rowid, a_len)
    pos = torch.arange(flat_n, dtype=torch.int32, device=av.device) - a_off[rowid]
    active = (pos < a_len[row]) & lens_eq[row]
    bn = max(int(bv.shape[0]), 1)
    b_idx = (b_off[rowid] + pos).clamp(0, bn - 1).long()
    b_at = A.nonempty(bv)[b_idx]
    ones = torch.ones((flat_n,), dtype=torch.bool, device=av.device)
    a_ok = ae.valid if ae.valid is not None else ones
    b_ok = A.nonempty(be.valid)[b_idx] if be.valid is not None else ones
    if av.dtype != b_at.dtype:
        dt_ = torch.promote_types(av.dtype, b_at.dtype)
        av, b_at = av.to(dt_), b_at.to(dt_)
    mismatch = active & a_ok & b_ok & (av != b_at)
    nullpair = active & (~a_ok | ~b_ok)
    any_mismatch = A.count_in_ranges(a_off, mismatch) > 0
    any_nullpair = A.count_in_ranges(a_off, nullpair) > 0
    vals = lens_eq & ~any_mismatch
    indeterminate = vals & any_nullpair
    return LoweredVal(vals, and_valid(and_valid(a.valid, b.valid), ~indeterminate))


def _row_index(rowid: torch.Tensor, per_row: torch.Tensor) -> torch.Tensor:
    """``rowid`` clamped to the rows of ``per_row``: flat elements past the
    last row's range (a map aggregate's dead entries) read the last row, as
    JAX's clamping gather does; offsets, one longer, take ``rowid`` as it
    is."""
    return rowid.clamp(max=max(int(per_row.shape[0]) - 1, 0))


def _lower_row_ctor(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """ROW(a, b, ...): one child per field, with the parent's rows. The
    row itself is never NULL; field NULLs live in the children."""
    items = [lower(a, ctx) for a in expr.args]
    return LoweredVal(torch.zeros((ctx.num_rows,), dtype=torch.int8, device=ctx.device),
                      None, None, children=items)


def _lower_row_field(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """row[i] (a 1-based constant ordinal); a NULL row makes the field
    NULL."""
    base = lower(expr.args[0], ctx)
    idx_e = expr.args[1]
    assert isinstance(idx_e, ir.Constant)
    field = base.children[int(idx_e.value) - 1]
    return LoweredVal(field.vals, and_valid(base.valid, field.valid), field.dictionary,
                      children=field.children, hi=field.hi)


def _recode_onto(x: LoweredVal, target: Optional[Dictionary], device) -> torch.Tensor:
    """``x``'s codes in ``target``'s code space (a varchar probe against a
    flat child's dictionary); other values unchanged."""
    if x.dictionary is None or target is None or x.dictionary.values == target.values:
        return x.vals
    return _code_lut(x, x.dictionary.recode_table(target), NULL_CODE, device)


def _lower_array_ctor(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """ARRAY[e1, ..., ek]: every row holds k elements, flattened row-major;
    varchar items go onto one merged dictionary and the element dtype is
    the items' promoted dtype."""
    k = len(expr.args)
    n = ctx.num_rows
    lengths = torch.full((n,), k, dtype=torch.int32, device=ctx.device)
    if k == 0:
        elem = LoweredVal(torch.zeros((0,), dtype=torch.int64, device=ctx.device), None, None)
        return LoweredVal(lengths, None, children=[elem])
    items = [lower(a, ctx) for a in expr.args]
    if any(it.children is not None for it in items):
        raise NotImplementedError("nested array constructors not supported")
    d = None
    present = [it.dictionary for it in items if it.dictionary is not None]
    if present:
        # a NULL literal lowers without a dictionary: it adds no vocabulary
        # and its codes become NULL_CODE
        d = present[0]
        for dc in present[1:]:
            if dc.values != d.values:
                d = d.merge(dc)

        def recoded(it):
            if it.dictionary is not None and it.dictionary.values == d.values:
                return it
            table = (it.dictionary.recode_table(d) if it.dictionary is not None
                     else np.array([NULL_CODE], np.int32))
            codes = _code_lut(it, table, NULL_CODE, ctx.device)
            if it.valid is not None:
                codes = torch.where(it.valid, codes, torch.full_like(codes, NULL_CODE))
            return LoweredVal(codes, it.valid, d)

        items = [recoded(it) for it in items]
    element = getattr(expr.type, "element", None)
    if d is None and element is not None and element.is_varchar:
        d = Dictionary([])  # an all-NULL varchar array literal
    dt_ = items[0].vals.dtype
    for it in items[1:]:
        dt_ = torch.promote_types(dt_, it.vals.dtype)
    flat = torch.stack([it.vals.to(dt_) for it in items], dim=1).reshape(-1)
    fvalid = None
    if any(it.valid is not None for it in items):
        ones = torch.ones((n,), dtype=torch.bool, device=ctx.device)
        fvalid = torch.stack([it.valid if it.valid is not None else ones for it in items],
                             dim=1).reshape(-1)
    return LoweredVal(lengths, None, children=[LoweredVal(flat, fvalid, d)])


def _nested_parts(a: LoweredVal):
    """(lengths, offsets) of a nested value. The raw lengths describe the
    flat layout even under NULL rows."""
    lens = a.vals.to(torch.int32)
    return lens, A.offsets_from_lengths(lens)


def _lower_cardinality(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a = lower(expr.args[0], ctx)
    return LoweredVal(a.vals.to(torch.int64), a.valid, None)


def _lower_subscript(strict: bool, is_map: bool):
    """a[i] / element_at(a, i) over arrays (1-based, negative from the end)
    and maps (the first entry whose key equals). The strict forms raise
    INVALID_FUNCTION_ARGUMENT for a live row out of bounds or without the
    key; element_at gives NULL."""
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = lower(expr.args[0], ctx)
        key = lower(expr.args[1], ctx)
        lens, offsets = _nested_parts(a)
        if is_map:
            kflat, vflat = a.children
            flat_n = int(kflat.vals.shape[0])
            rowid = A.rowid_of_flat(offsets, flat_n).long()
            kv = _recode_onto(key, kflat.dictionary, ctx.device)
            match = kflat.vals == kv[_row_index(rowid, kv)]
            idx1 = A.first_match_index(offsets, match)
            found = idx1 > 0
            vals, _ = A.gather_at(offsets, lens, vflat.vals, idx1)
            evalid = None
            if vflat.valid is not None:
                evalid, _ = A.gather_at(offsets, lens, vflat.valid, idx1)
            missing, dictionary = ~found, vflat.dictionary
            valid = and_valid(and_valid(a.valid, key.valid), and_valid(found, evalid))
        else:
            eflat = a.children[0]
            vals, in_bounds = A.gather_at(offsets, lens, eflat.vals, key.vals)
            evalid = None
            if eflat.valid is not None:
                evalid, _ = A.gather_at(offsets, lens, eflat.valid, key.vals)
            missing, dictionary = ~in_bounds, eflat.dictionary
            valid = and_valid(and_valid(a.valid, key.valid), and_valid(in_bounds, evalid))
        if strict:
            ones = torch.ones_like(missing)
            base_ok = a.valid if a.valid is not None else ones
            kok = key.valid if key.valid is not None else ones
            ctx.add_error(INVALID_FUNCTION_ARGUMENT, missing & base_ok & kok, None)
        return LoweredVal(vals, valid, dictionary)

    return fn


def _flat_match(ctx: LowerCtx, expr: ir.Call):
    """(array value, probe, offsets, flat element matches) of
    contains/array_position: each element compared with its row's probe;
    a NULL element never matches."""
    a = lower(expr.args[0], ctx)
    x = lower(expr.args[1], ctx)
    _lens, offsets = _nested_parts(a)
    eflat = a.children[0]
    rowid = A.rowid_of_flat(offsets, int(eflat.vals.shape[0])).long()
    xv = _recode_onto(x, eflat.dictionary, ctx.device)
    match = eflat.vals == xv[_row_index(rowid, xv)]
    if eflat.valid is not None:
        match = match & eflat.valid
    return a, x, offsets, match


def _lower_contains(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """contains(a, x): true if found; else NULL if the array holds a NULL
    element; else false."""
    a, x, offsets, match = _flat_match(ctx, expr)
    found = A.count_in_ranges(offsets, match) > 0
    evalid = a.children[0].valid
    valid = and_valid(a.valid, x.valid)
    if evalid is not None:
        has_null_elem = A.count_in_ranges(offsets, ~evalid) > 0
        valid = and_valid(valid, found | ~has_null_elem)
    return LoweredVal(found, valid, None)


def _lower_array_position(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    a, x, offsets, match = _flat_match(ctx, expr)
    idx1 = A.first_match_index(offsets, match)
    return LoweredVal(idx1.to(torch.int64), and_valid(a.valid, x.valid), None)


def _lower_array_reduce(kind: str):
    """array_sum (NULL elements skipped, NULL for an empty array) and
    array_min/array_max (a segment min/max over the flat child, NULL when
    no element is valid)."""
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = lower(expr.args[0], ctx)
        lens, offsets = _nested_parts(a)
        eflat = a.children[0]
        empty = lens == 0
        x = eflat.vals
        if kind == "sum":
            if eflat.valid is not None:
                x = torch.where(eflat.valid, x, torch.zeros_like(x))
            return LoweredVal(A.segment_reduce_by_range(offsets, x),
                              and_valid(a.valid, ~empty), None)
        flat_n = int(x.shape[0])
        n = ctx.num_rows
        if x.dtype.is_floating_point:
            sentinel = float("inf") if kind == "min" else float("-inf")
        else:
            info = torch.iinfo(x.dtype)
            sentinel = info.max if kind == "min" else info.min
        if eflat.valid is not None:
            x = torch.where(eflat.valid, x, torch.full_like(x, sentinel))
        out = torch.full((n,), sentinel, dtype=x.dtype, device=x.device)
        if flat_n:
            rowid = A.rowid_of_flat(offsets, flat_n).long()
            # elements past the last row's range drop, as a segment
            # reduction drops out-of-range segment ids
            x = torch.where(rowid < n, x, torch.full_like(x, sentinel))
            out.scatter_reduce_(0, rowid.clamp(max=n - 1), x,
                                "amin" if kind == "min" else "amax")
        has_valid = (A.count_in_ranges(offsets, eflat.valid) > 0
                     if eflat.valid is not None else ~empty)
        return LoweredVal(out, and_valid(a.valid, has_valid), eflat.dictionary)

    return fn


def _lower_map_part(which: int):
    """map_keys (0) / map_values (1): the map's lengths over one child."""
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        a = lower(expr.args[0], ctx)
        return LoweredVal(a.vals.to(torch.int32), a.valid, children=[a.children[which]])

    return fn


def _lower_lambda_over_flat(ctx: LowerCtx, arr: LoweredVal, lam: "ir.Lambda",
                            elem_type) -> LoweredVal:
    """A lambda body over an array's flattened child: the element column is
    channel 0 of a fresh context whose row space is the flat space (with
    the outer context's device and generator), one pass over every element
    of every row. An empty child lowers over one dummy row, cut after."""
    child = arr.children[0]
    flat_n = int(child.vals.shape[0])
    elem_col = Column(
        elem_type,
        A.nonempty(child.vals),
        None if child.valid is None else (
            ~child.valid if flat_n else torch.zeros((1,), dtype=torch.bool,
                                                     device=child.vals.device)),
        child.dictionary,
    )
    inner = LowerCtx([elem_col], max(flat_n, 1), None, ctx.device, ctx.generator)
    out = lower(lam.body, inner)
    ctx.errors.extend(inner.errors)
    if flat_n == 0:
        out = LoweredVal(out.vals[:0], None if out.valid is None else out.valid[:0],
                         out.dictionary)
    return out


def _lower_transform(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    arr = lower(expr.args[0], ctx)
    out = _lower_lambda_over_flat(ctx, arr, expr.args[1], expr.args[0].type.element)
    return LoweredVal(arr.vals.to(torch.int32), arr.valid,
                      children=[LoweredVal(out.vals, out.valid, out.dictionary)])


def _lower_match(kind: str):
    """any_match / all_match / none_match, three-valued: any is true if an
    element is true, NULL if none is true but one is unknown; all is false
    if an element is false, NULL if the rest hold an unknown; none is not
    any. An empty array gives false for any and true for all and none."""
    def fn(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
        arr = lower(expr.args[0], ctx)
        out = _lower_lambda_over_flat(ctx, arr, expr.args[1], expr.args[0].type.element)
        _lens, offsets = _nested_parts(arr)
        known = out.valid
        n_unknown = A.count_in_ranges(offsets, ~known) if known is not None else None
        if kind in ("any", "none"):
            flat_true = out.vals if known is None else out.vals & known
            hit = A.count_in_ranges(offsets, flat_true) > 0
            valid = arr.valid if n_unknown is None else and_valid(
                arr.valid, hit | (n_unknown == 0))
            return LoweredVal(hit if kind == "any" else ~hit, valid, None)
        flat_false = ~out.vals if known is None else ~out.vals & known
        any_false = A.count_in_ranges(offsets, flat_false) > 0
        valid = arr.valid if n_unknown is None else and_valid(
            arr.valid, any_false | (n_unknown == 0))
        return LoweredVal(~any_false, valid, None)

    return fn


def _lower_map_ctor(ctx: LowerCtx, expr: ir.Call) -> LoweredVal:
    """map(keys, values): key and value arrays of unequal length raise
    INVALID_FUNCTION_ARGUMENT."""
    ka = lower(expr.args[0], ctx)
    va = lower(expr.args[1], ctx)
    mismatch = ka.vals.to(torch.int32) != va.vals.to(torch.int32)
    ctx.add_error(INVALID_FUNCTION_ARGUMENT, mismatch, and_valid(ka.valid, va.valid))
    return LoweredVal(ka.vals.to(torch.int32), and_valid(ka.valid, va.valid),
                      children=[ka.children[0], va.children[0]])


FUNCTIONS: Dict[str, Callable[..., LoweredVal]] = {
    "random": _lower_random,
    "now": _lower_now,
    "current_date": _lower_current_date,
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
    "mod": _arith("mod"),
    "negate": _lower_negate,
    "abs": _lower_abs,
    "and": _lower_and,
    "or": _lower_or,
    "not": _lower_not,
    "is_null": _lower_is_null,
    "between": _lower_between,
    "in_list": _lower_in_list,
    "like": _lower_like,
    "coalesce": _lower_coalesce,
    "nullif": _lower_nullif,
    "substring": _lower_substring,
    "lower": _lower_str_fn(str.lower),
    "upper": _lower_str_fn(str.upper),
    "trim": _lower_str_fn(str.strip),
    "ltrim": _lower_str_fn(str.lstrip),
    "rtrim": _lower_str_fn(str.rstrip),
    "length": _lower_length,
    "to_hex": _lower_binary_fn("to_hex"),
    "from_hex": _lower_binary_fn("from_hex"),
    "to_utf8": _lower_binary_fn("to_utf8"),
    "from_utf8": _lower_binary_fn("from_utf8"),
    "md5": _lower_binary_fn("md5"),
    "sha256": _lower_binary_fn("sha256"),
    "concat": _lower_concat,
    "sqrt": _lower_math1(torch.sqrt),
    "cbrt": _lower_math1(_cbrt),
    "ln": _lower_math1(torch.log),
    "log_b": _lower_log_b,
    "log2": _lower_math1(torch.log2),
    "log10": _lower_math1(_log10),
    "exp": _lower_math1(torch.exp),
    "power": _lower_power,
    "sign": _lower_sign,
    "round": _lower_round,
    "ceil": _lower_ceil_floor(True),
    "ceiling": _lower_ceil_floor(True),
    "floor": _lower_ceil_floor(False),
    "greatest": _lower_extremum(True),
    "least": _lower_extremum(False),
    "extract_year": _lower_extract("year"),
    "extract_month": _lower_extract("month"),
    "extract_hour": _lower_extract("hour"),
    "extract_minute": _lower_extract("minute"),
    "extract_second": _lower_extract("second"),
    "extract_day": _lower_extract("day"),
    "extract_quarter": _lower_extract("quarter"),
    "extract_dow": _lower_extract("dow"),
    "extract_doy": _lower_extract("doy"),
    "extract_week": _lower_extract("week"),
    "date_add_months": _lower_date_add_months,
    "date_diff_days": _lower_diff_units,
    "ts_diff_units": _lower_diff_units,
    "months_between": _lower_months_between,
    "seconds_to_ts3": _lower_seconds_to_ts3,
    "date_trunc": _lower_date_trunc,
    "replace": _lower_replace,
    "reverse": _lower_reverse,
    "strpos": _lower_strpos,
    "starts_with": _lower_starts_with,
    "sin": _lower_math1(torch.sin),
    "cos": _lower_math1(torch.cos),
    "tan": _lower_math1(torch.tan),
    "asin": _lower_math1(torch.asin),
    "acos": _lower_math1(torch.acos),
    "atan": _lower_math1(torch.atan),
    "sinh": _lower_math1(torch.sinh),
    "cosh": _lower_math1(torch.cosh),
    "tanh": _lower_math1(torch.tanh),
    "degrees": _lower_math1(torch.rad2deg),
    "radians": _lower_math1(torch.deg2rad),
    "atan2": _lower_atan2,
    "truncate": _lower_truncate,
    "regexp_like": _lower_regexp("like"),
    "regexp_extract": _lower_regexp("extract"),
    "regexp_replace": _lower_regexp("replace"),
    "regexp_count": _lower_regexp("count"),
    "lpad": _lower_pad(True),
    "rpad": _lower_pad(False),
    "split_part": _lower_split_part,
    "translate": _lower_translate,
    "repeat_str": _lower_repeat_str,
    "chr": _lower_chr,
    "codepoint": _lower_codepoint,
    "hamming_distance": _lower_str_distance("hamming"),
    "levenshtein_distance": _lower_str_distance("levenshtein"),
    "json_extract_scalar": _lower_json_extract_scalar,
    "json_array_length": _lower_json_array_length,
    "date_format": _lower_date_format,
    "date_parse": _lower_date_parse,
    "day_name": _lower_day_name,
    "month_name": _lower_month_name,
    "last_day_of_month": _lower_last_day_of_month,
    "bitwise_and": _lower_bitwise("and"),
    "bitwise_or": _lower_bitwise("or"),
    "bitwise_xor": _lower_bitwise("xor"),
    "bitwise_not": _lower_bitwise("not"),
    "bitwise_left_shift": _lower_bitwise("lshift"),
    "bitwise_right_shift": _lower_bitwise("rshift"),
    "bit_count": _lower_bit_count,
    "is_nan": _lower_float_class("nan"),
    "is_finite": _lower_float_class("finite"),
    "is_infinite": _lower_float_class("inf"),
    "row_ctor": _lower_row_ctor,
    "row_field": _lower_row_field,
    "array_ctor": _lower_array_ctor,
    "cardinality": _lower_cardinality,
    "subscript": _lower_subscript(strict=True, is_map=False),
    "element_at": _lower_subscript(strict=False, is_map=False),
    "map_subscript": _lower_subscript(strict=True, is_map=True),
    "map_element_at": _lower_subscript(strict=False, is_map=True),
    "contains": _lower_contains,
    "array_position": _lower_array_position,
    "array_min": _lower_array_reduce("min"),
    "array_max": _lower_array_reduce("max"),
    "array_sum": _lower_array_reduce("sum"),
    "map_keys": _lower_map_part(0),
    "map_values": _lower_map_part(1),
    "map_ctor": _lower_map_ctor,
    "transform": _lower_transform,
    "any_match": _lower_match("any"),
    "all_match": _lower_match("all"),
    "none_match": _lower_match("none"),
}
