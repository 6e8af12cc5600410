"""Int128 limb arithmetic for long decimals: the port of
trino_tpu/ops/int128.py.

A value is a pair of int64 tensors ``(hi, lo)``: ``lo`` carries the low 64
bits as a raw bit pattern (read unsigned), ``hi`` the high 64 bits with the
sign. The reference computes on uint64 words; PyTorch has no ``+``, ``>>``,
``<``, ``//`` or ``%`` for uint64, so every word here is int64 and the
unsigned operations are emulated:

- addition, subtraction and multiplication wrap mod 2^64 in int64 exactly
  as in uint64 (same bit patterns);
- unsigned compares flip the sign bit of both sides (``_ult``, ``_uge``);
- logical right shifts mask off the sign-extended bits (``_lsr``).
"""
from __future__ import annotations

from typing import Tuple

import torch

I128 = Tuple[torch.Tensor, torch.Tensor]  # (hi int64, lo int64 bit pattern)

_MASK32 = 0xFFFFFFFF
_SIGN = -(2**63)


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _uge(a: torch.Tensor, b) -> torch.Tensor:
    return ~_ult(a, b)


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 bit pattern by 0 <= k < 64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def is_negative(a: I128) -> torch.Tensor:
    return a[0] < 0


def neg(a: I128) -> I128:
    hi, lo = a
    nlo = ~lo + 1
    # ~lo + 1 == 0 only when lo == 0 (then the +1 carries into hi)
    nhi = ~hi + (nlo == 0).to(torch.int64)
    return nhi, nlo


def add(a: I128, b: I128) -> I128:
    hi1, lo1 = a
    hi2, lo2 = b
    lo = lo1 + lo2
    carry = _ult(lo, lo1).to(torch.int64)
    return hi1 + hi2 + carry, lo


def sub(a: I128, b: I128) -> I128:
    return add(a, neg(b))


def abs128(a: I128) -> Tuple[I128, torch.Tensor]:
    """(|a|, was_negative)."""
    n = is_negative(a)
    na = neg(a)
    return (torch.where(n, na[0], a[0]), torch.where(n, na[1], a[1])), n


def _mul_u64(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 128-bit product of two unsigned 64-bit patterns -> (hi, lo)."""
    x0, x1 = x & _MASK32, _lsr(x, 32)
    y0, y1 = y & _MASK32, _lsr(y, 32)
    ll = x0 * y0
    m1 = x1 * y0
    m2 = x0 * y1
    hh = x1 * y1
    t = _lsr(ll, 32) + (m1 & _MASK32) + (m2 & _MASK32)
    lo = (ll & _MASK32) | (t << 32)
    hi = hh + _lsr(m1, 32) + _lsr(m2, 32) + _lsr(t, 32)
    return hi, lo


def mul_int64(x: torch.Tensor, y: torch.Tensor) -> I128:
    """Exact signed product of two int64 arrays."""
    sx = x < 0
    sy = y < 0
    ax = torch.where(sx, -x, x)
    ay = torch.where(sy, -y, y)
    res = _mul_u64(ax, ay)
    nres = neg(res)
    flip = sx ^ sy
    return torch.where(flip, nres[0], res[0]), torch.where(flip, nres[1], res[1])


def mul_small_checked(a: I128, m: int) -> Tuple[I128, torch.Tensor]:
    """(a * m, overflowed) for a small non-negative Python int m < 2^63:
    flags rows whose |a|*m exceeds 2^127 - 1."""
    (ahi, alo), n = abs128(a)
    mm = torch.full_like(alo, m)
    phi, plo = _mul_u64(alo, mm)
    hh_hi, hh_lo = _mul_u64(ahi, mm)  # high-limb product, 128-bit
    hi2 = phi + hh_lo
    overflow = (hh_hi != 0) | _ult(hi2, phi) | (hi2 < 0)  # >= 2^127
    res = (hi2, plo)
    nres = neg(res)
    return (torch.where(n, nres[0], res[0]), torch.where(n, nres[1], res[1])), overflow


def _divmod_core(hi: torch.Tensor, lo: torch.Tensor, dd: torch.Tensor):
    """Unsigned (hi, lo) divided by ``dd`` (0 < dd < 2^63, hi < 2^63 — the
    callers divide absolute values): divide the high word, then
    shift-subtract over the low word (64 vector steps)."""
    q_hi = torch.div(hi, dd, rounding_mode="floor")
    r = torch.remainder(hi, dd)  # < dd <= 2^63: doubling stays below 2^64
    q_lo = torch.zeros_like(lo)
    for i in range(63, -1, -1):
        bit = _lsr(lo, i) & 1
        r = (r << 1) | bit
        ge = _uge(r, dd)
        r = torch.where(ge, r - dd, r)
        q_lo = q_lo | (ge.to(torch.int64) << i)
    return (q_hi, q_lo), r


def divmod_u64(a: I128, d: int) -> Tuple[I128, torch.Tensor]:
    """Unsigned division of a non-negative int128 by a Python int d < 2^63."""
    return _divmod_core(a[0], a[1], torch.full_like(a[1], d))


def divmod_u64_arr(a: I128, d: torch.Tensor) -> Tuple[I128, torch.Tensor]:
    """Unsigned division of a non-negative int128 by a positive int64 array."""
    return _divmod_core(a[0], a[1], d.to(torch.int64))


def div_round_small(a: I128, d: int) -> I128:
    """a / d with HALF-UP rounding away from zero, d a positive int < 2^63."""
    (ahi, alo), n = abs128(a)
    q, r = divmod_u64((ahi, alo), d)
    round_up = _uge(r, (d + 1) // 2)
    q = add(q, (torch.zeros_like(q[0]), round_up.to(torch.int64)))
    nq = neg(q)
    return torch.where(n, nq[0], q[0]), torch.where(n, nq[1], q[1])


def compare(a: I128, b: I128) -> torch.Tensor:
    """-1 / 0 / 1 signed comparison (int8)."""
    hi1, lo1 = a
    hi2, lo2 = b
    lt = (hi1 < hi2) | ((hi1 == hi2) & _ult(lo1, lo2))
    gt = (hi1 > hi2) | ((hi1 == hi2) & _ult(lo2, lo1))
    one = torch.ones_like(hi1, dtype=torch.int8)
    return torch.where(lt, -one, torch.where(gt, one, torch.zeros_like(one)))


def to_int64(a: I128) -> torch.Tensor:
    """Low 64 bits as signed (the caller flags values past int64)."""
    return a[1]


def rescale(a: I128, from_scale: int, to_scale: int) -> I128:
    out, _ = rescale_checked(a, from_scale, to_scale)
    return out


def rescale_checked(a: I128, from_scale: int, to_scale: int) -> Tuple[I128, torch.Tensor]:
    """Multiply/divide by powers of ten (half-up on scale-down) + a per-row
    overflow flag for the scale-up direction."""
    if to_scale == from_scale:
        return a, torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    if to_scale > from_scale:
        out = a
        overflow = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
        k = to_scale - from_scale
        while k > 0:  # 10^18 fits the small-multiplier bound
            step = min(k, 18)
            out, ovf = mul_small_checked(out, 10 ** step)
            overflow = overflow | ovf
            k -= step
        return out, overflow
    out = a
    k = from_scale - to_scale
    while k > 18:
        out, _ = divmod_u64_signed_trunc(out, 10 ** 18)
        k -= 18
    return div_round_small(out, 10 ** k), torch.zeros(
        a[0].shape, dtype=torch.bool, device=a[0].device)


def divmod_u64_signed_trunc(a: I128, d: int) -> Tuple[I128, torch.Tensor]:
    """Truncating signed division by positive d (no rounding)."""
    (ahi, alo), n = abs128(a)
    q, r = divmod_u64((ahi, alo), d)
    nq = neg(q)
    return (torch.where(n, nq[0], q[0]), torch.where(n, nq[1], q[1])), r
