"""Aggregate accumulation over a GroupLayout: the port of the
trino_tpu/ops/aggregate.py calls the ported queries reach — count, sum
(int64 and the exact int128 limb sum), avg through ``finish_avg``, min,
max and count(DISTINCT).

Argument and mask arrays are in LAYOUT SPACE (segments.seg_sum), except
for ``agg_count_distinct``, which re-groups and takes original-order
arguments.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.ops import int128 as i128
from trino_tpu_torch.ops import segments as seg

Lowered = Tuple[torch.Tensor, Optional[torch.Tensor]]
GroupLayout = seg.GroupLayout


def _live(sel: Optional[torch.Tensor], valid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if sel is None:
        return valid
    if valid is None:
        return sel
    return sel & valid


def agg_count_star(layout: GroupLayout, sel: Optional[torch.Tensor]):
    return seg.seg_count(layout, sel), None


def agg_count(layout: GroupLayout, arg: Lowered, sel):
    _, valid = arg
    return seg.seg_count(layout, _live(sel, valid)), None


def agg_sum(layout: GroupLayout, arg: Lowered, sel, out_dtype: torch.dtype):
    vals, valid = arg
    m = _live(sel, valid)
    total = seg.seg_sum(layout, vals, m, out_dtype)
    cnt = seg.seg_count(layout, m)
    # SQL: sum of an empty/all-null group is NULL
    return total, cnt > 0


def agg_sum_128(layout: GroupLayout, lo: torch.Tensor, hi: Optional[torch.Tensor],
                valid: Optional[torch.Tensor], sel):
    """Exact int128 grouped sum via 32-bit limbs: each value's 128-bit
    two's-complement pattern splits into four unsigned 32-bit limbs whose
    per-slot sums are exact in int64 (< 2^31 rows), and a carry-propagating
    recombination rebuilds (hi, lo) mod 2^128.

    Returns ((hi, lo) int64 slot arrays, non_empty mask)."""
    m = _live(sel, valid)
    lo64 = lo.to(torch.int64)
    hi64 = hi if hi is not None else (lo64 >> 63)
    m32 = 0xFFFFFFFF
    limbs = [lo64 & m32, i128._lsr(lo64, 32), hi64 & m32, i128._lsr(hi64, 32)]
    sums = [seg.seg_sum(layout, limb, m, torch.int64) for limb in limbs]
    t0 = sums[0]
    w0 = t0 & m32
    t1 = sums[1] + i128._lsr(t0, 32)
    w1 = t1 & m32
    t2 = sums[2] + i128._lsr(t1, 32)
    w2 = t2 & m32
    t3 = sums[3] + i128._lsr(t2, 32)
    w3 = t3 & m32
    out_lo = w0 | (w1 << 32)
    out_hi = w2 | (w3 << 32)
    cnt = seg.seg_count(layout, m)
    return (out_hi, out_lo), cnt > 0


def agg_count_distinct(layout: GroupLayout, arg: Lowered, sel):
    """count(DISTINCT x) per group: re-group on (gid, x) pairs, then count
    the distinct pairs back into the outer group. The inner grouping sorts
    by (outer gid, x), so the outer gid of each distinct pair is
    non-decreasing across inner slots: a monotonic segment sum."""
    from trino_tpu_torch.ops import groupby as gb

    vals, valid = arg
    n = vals.shape[0]
    live = _live(sel, valid)
    outer_gids = layout.gids_orig()
    order, gid_sorted, num_inner, _ = gb.group_plan([(outer_gids, None), (vals, None)], live)
    inner = seg.sorted_layout(order, gid_sorted, num_inner)
    inner_live = torch.arange(n, device=vals.device) < num_inner
    # outer gid per inner slot; dead slots pushed past every real group
    outer_of_slot = torch.where(
        inner_live, outer_gids[inner.rep.long().clamp(0, n - 1)].to(torch.int32),
        torch.full((n,), layout.capacity, dtype=torch.int32, device=vals.device))
    cnt = seg.monotonic_segment_sum(inner_live.to(torch.int64), outer_of_slot,
                                    layout.capacity)
    return cnt, None


def agg_min(layout: GroupLayout, arg: Lowered, sel):
    return _agg_minmax(layout, arg, sel, is_min=True)


def agg_max(layout: GroupLayout, arg: Lowered, sel):
    return _agg_minmax(layout, arg, sel, is_min=False)


def _agg_minmax(layout: GroupLayout, arg: Lowered, sel, is_min: bool):
    vals, valid = arg
    m = _live(sel, valid)
    out = seg.seg_minmax(layout, vals, m, is_min)
    cnt = seg.seg_count(layout, m)
    return out, cnt > 0


def finish_avg(sum_vals: torch.Tensor, cnt: torch.Tensor, out_type: T.Type):
    """avg final step from (sum, count) state. Decimal avg rounds half-up
    at the input scale; numeric avg is a double division."""
    valid = cnt > 0
    safe = torch.where(valid, cnt, torch.ones_like(cnt))
    if out_type.is_decimal:
        s = torch.abs(sum_vals)
        q = torch.div(s + torch.div(safe, 2, rounding_mode="floor"), safe,
                      rounding_mode="floor")
        return torch.sign(sum_vals) * q, valid
    return sum_vals.to(torch.float64) / safe, valid
