"""Segment reductions over a grouping layout: the port of
trino_tpu/ops/segments.py.

Two layouts:

- **direct**: group keys are small perfect indices (dictionary codes /
  booleans); per-group values come from an unrolled masked-reduction loop
  over the (small, static) capacity.
- **sorted**: rows are permuted group-contiguous (ops/groupby.py); integer
  sums are cumsum-then-boundary-difference (exact: wraparound cancels mod
  2^64), min/max come from a (group, value) sort.

Float sums use ``index_add_``, the counterpart of the reference's
``jax.ops.segment_sum``. On CUDA it accumulates with atomics, so float
sums may differ in the last bits from run to run; a deterministic
segmented float sum is later work. No float sum is on the ported query
path (Q17/Q18 sum decimals, which are integers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from trino_tpu_torch.ops import ranks

Lowered = Tuple[torch.Tensor, Optional[torch.Tensor]]

# Above this capacity the unrolled masked loop stops making sense and the
# sort-based layout wins.
DIRECT_CAPACITY_MAX = 128


@dataclasses.dataclass
class GroupLayout:
    """Grouping structure shared by every aggregate of one aggregation node.
    Direct layouts keep per-row perfect-index group ids in original row
    order; sorted layouts keep the permutation to group-contiguous order
    plus per-slot [start, end) ranges in that sorted space."""

    n: int  # input rows
    capacity: int  # static output slots
    gids: Optional[torch.Tensor] = None  # int32[n] perfect index (direct)
    order: Optional[torch.Tensor] = None  # int32[n] permutation (sorted)
    gid_sorted: Optional[torch.Tensor] = None  # int32[n] non-decreasing
    starts: Optional[torch.Tensor] = None  # int32[capacity]
    ends: Optional[torch.Tensor] = None  # int32[capacity]
    num_groups: Optional[torch.Tensor] = None  # scalar (sorted only)
    rep: Optional[torch.Tensor] = None  # representative row (orig order)

    @property
    def is_direct(self) -> bool:
        return self.gids is not None

    def gids_layout(self) -> torch.Tensor:
        return self.gids if self.gids is not None else self.gid_sorted


def direct_layout(gids: torch.Tensor, capacity: int,
                  live: Optional[torch.Tensor]) -> GroupLayout:
    """Layout for perfect-index group ids (capacity <= DIRECT_CAPACITY_MAX)."""
    n = gids.shape[0]
    assert capacity <= DIRECT_CAPACITY_MAX
    idx = ranks._iota32(n, gids.device)
    dead_idx = torch.full_like(idx, n)
    reps = []
    for g in range(capacity):
        m = gids == g
        if live is not None:
            m = m & live
        reps.append(torch.where(m, idx, dead_idx).min())
    rep = torch.stack(reps)
    return GroupLayout(n=n, capacity=capacity, gids=gids, rep=rep)


def sorted_layout(
    order: torch.Tensor, gid_sorted: torch.Tensor, num_groups: torch.Tensor
) -> GroupLayout:
    """Layout from a group-contiguous permutation (ops/groupby.py).
    ``gid_sorted`` is dense and non-decreasing (run k has gid k), so
    compacting the run-boundary positions to the front with one stable
    bool-key sort yields ``starts``; each run ends where the next begins."""
    n = order.shape[0]
    device = order.device
    pos = ranks._iota32(n, device)
    boundary = torch.cat([torch.ones((1,), dtype=torch.bool, device=device),
                          gid_sorted[1:] != gid_sorted[:-1]])
    nb = boundary.to(torch.int32).sum()
    starts_seq = ranks.argsort32(~boundary)
    nn = torch.full_like(pos, n)
    starts = torch.where(pos < nb, starts_seq, nn)
    next_start = torch.cat([starts_seq[1:], nn[:1]])
    ends = torch.where(pos < nb, torch.where(pos + 1 < nb, next_start, nn), nn)
    rep = order[starts.long().clamp(0, n - 1)]
    return GroupLayout(n=n, capacity=n, order=order, gid_sorted=gid_sorted,
                       starts=starts, ends=ends, num_groups=num_groups, rep=rep)


def occupancy(layout: GroupLayout, live: Optional[torch.Tensor]) -> torch.Tensor:
    """bool[capacity]: slots holding at least one live row."""
    if layout.is_direct:
        return layout.rep < layout.n
    return torch.arange(layout.capacity, device=layout.rep.device) < layout.num_groups


def _cumsum_diff_ranges(starts, ends, x_sorted) -> torch.Tensor:
    """Per-range sums of a segment-contiguous array via cumsum + boundary
    difference (exact for ints: wraparound cancels mod 2^64)."""
    c = torch.cumsum(x_sorted, 0, dtype=x_sorted.dtype)
    c0 = torch.cat([torch.zeros((1,), dtype=c.dtype, device=c.device), c])
    return c0[ends.long()] - c0[starts.long()]


def _cumsum_diff(layout: GroupLayout, x_sorted) -> torch.Tensor:
    return _cumsum_diff_ranges(layout.starts, layout.ends, x_sorted)


def seg_sum(layout: GroupLayout, vals: torch.Tensor, m: Optional[torch.Tensor],
            out_dtype: torch.dtype) -> torch.Tensor:
    """Per-slot sum of ``vals`` over rows where mask ``m`` holds. ``vals``
    and ``m`` are in LAYOUT SPACE (original order for direct layouts,
    group-contiguous order for sorted ones)."""
    x = vals.to(out_dtype)
    if m is not None:
        x = torch.where(m, x, torch.zeros_like(x))
    if layout.is_direct:
        zero = torch.zeros_like(x)
        return torch.stack([torch.where(layout.gids == g, x, zero).sum(dtype=out_dtype)
                            for g in range(layout.capacity)])
    if out_dtype.is_floating_point:
        out = torch.zeros((layout.capacity,), dtype=out_dtype, device=x.device)
        return out.index_add_(0, layout.gid_sorted.long(), x)
    return _cumsum_diff(layout, x)


def seg_count(layout: GroupLayout, m: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-slot count of rows where mask ``m`` holds (int64)."""
    device = layout.gids_layout().device
    ones = (torch.ones((layout.n,), dtype=torch.int64, device=device)
            if m is None else m.to(torch.int64))
    if layout.is_direct:
        zero = torch.zeros_like(ones)
        return torch.stack([torch.where(layout.gids == g, ones, zero).sum()
                            for g in range(layout.capacity)])
    if m is None:
        return (layout.ends - layout.starts).to(torch.int64)
    return _cumsum_diff(layout, ones)


def seg_minmax(layout: GroupLayout, vals: torch.Tensor, m: Optional[torch.Tensor],
               is_min: bool) -> torch.Tensor:
    """Per-slot min/max over rows where ``m`` holds (sentinel-filled for
    empty slots). Sorted path: one (gid, value) sort puts each group's min
    at its start and max at its end."""
    if vals.dtype.is_floating_point:
        sentinel = float("inf") if is_min else float("-inf")
    elif vals.dtype == torch.bool:
        vals = vals.to(torch.int32)
        sentinel = 1 if is_min else 0
    else:
        info = torch.iinfo(vals.dtype)
        sentinel = info.max if is_min else info.min
    x = vals if m is None else torch.where(m, vals, torch.full_like(vals, sentinel))
    if layout.is_direct:
        fill = torch.full_like(x, sentinel)
        red = torch.amin if is_min else torch.amax
        return torch.stack([red(torch.where(layout.gids == g, x, fill))
                            for g in range(layout.capacity)])
    (_, x_by_group), _ = ranks.lex_sort([layout.gid_sorted, x])
    n = layout.n
    pos = layout.starts if is_min else (layout.ends - 1)
    out = x_by_group[pos.long().clamp(0, n - 1)]
    return torch.where(layout.ends > layout.starts, out, torch.full_like(out, sentinel))


def monotonic_segment_sum(x: torch.Tensor, seg: torch.Tensor,
                          n_segments: int) -> torch.Tensor:
    """Segment sums when ``seg`` is already non-decreasing — cumsum +
    boundary difference, no scatter."""
    slots = torch.arange(n_segments, dtype=seg.dtype, device=seg.device)
    starts, cnt = ranks.sorted_ranks([seg], [slots])
    return _cumsum_diff_ranges(starts, starts + cnt, x)
