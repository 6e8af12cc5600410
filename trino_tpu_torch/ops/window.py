"""Window functions: one sort, then prefix passes in sorted space — the port
of trino_tpu/ops/window.py.

All rows sort once by (dead, partition keys, order keys). In sorted space:

- partition and peer-run bounds: the boundary mask's running count gives
  each row its run ordinal, and one stable sort of the mask lists the run
  starts in order, so a row's start is the gather ``starts[ordinal]`` and
  its end the next run's start (no running max: ``torch.cummax`` is the
  slowest of the device ops this port has measured);
- row_number / rank / dense_rank: index arithmetic on those bounds;
- frame sums and counts: cumsum + gathered differences at the frame bounds;
- whole-partition min/max: one extra (partition, value) sort, read at the
  partition's first or last slot;
- lag/lead/first_value/last_value/nth_value: bounds-checked gathers.

Results return to original row order through the inverse permutation.
The arrays are the reference's, dtype for dtype (int32 bounds, int64
ranks and counts, float64 percent_rank and cume_dist).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from trino_tpu_torch.ops import ranks
from trino_tpu_torch.ops import sort as sort_ops

Lowered = Tuple[torch.Tensor, Optional[torch.Tensor]]


@dataclasses.dataclass
class WindowLayout:
    """Sorted-space structure shared by every window call of one node."""

    n: int
    order: torch.Tensor  # int32[n]: sorted slot -> original row
    inv: torch.Tensor  # int32[n]: original row -> sorted slot
    part_start: torch.Tensor  # int32[n] per sorted slot
    part_end: torch.Tensor  # int32[n] per sorted slot (exclusive)
    peer_start: torch.Tensor  # int32[n]
    peer_end: torch.Tensor  # int32[n] (exclusive)
    part_id: torch.Tensor  # int32[n] dense, non-decreasing
    dense_peer: torch.Tensor  # int32[n] peer-run ordinal within all rows


def _null_split(col: Lowered) -> List[torch.Tensor]:
    """(null flag, masked value) so NULL partitions and compares as its own
    value (IS NOT DISTINCT semantics for PARTITION BY and peers)."""
    vals, valid = col
    if valid is None:
        return [vals]
    return [~valid, torch.where(valid, vals, torch.zeros_like(vals))]


def _run_bounds(boundary: torch.Tensor):
    """(ordinal, start, end) per sorted slot of the runs that ``boundary``
    opens: the ordinal is the running count of boundaries less one; a stable
    sort of the negated mask lists the run starts first, in order."""
    n = boundary.shape[0]
    ordinal = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    starts_seq = ranks.argsort32(~boundary)
    n_runs = boundary.to(torch.int32).sum()
    start = starts_seq[ordinal.long()]
    nxt = ordinal + 1
    end = torch.where(nxt < n_runs, starts_seq[nxt.clamp(max=n - 1).long()],
                      torch.full_like(start, n))
    return ordinal, start, end


def build_layout(
    partition_keys: List[Lowered],
    order_keys: List[Tuple[Lowered, bool, Optional[bool]]],
    sel: Optional[torch.Tensor],
    n: int,
    device=None,
) -> WindowLayout:
    """The layout of ``n`` rows; ``device`` places it when there is no key
    and no selection (a window over all rows, unordered)."""
    sort_keys: List[torch.Tensor] = []
    if sel is not None:
        sort_keys.append(~sel)  # dead rows last, outside every partition
    part_cols: List[torch.Tensor] = []
    for pk in partition_keys:
        part_cols.extend(_null_split(pk))
    sort_keys.extend(part_cols)
    peer_cols: List[torch.Tensor] = []
    for (col, asc, nf) in order_keys:
        peer_cols.extend(sort_ops._sort_key(col[0], col[1], asc, nf))
    sort_keys.extend(peer_cols)
    if not sort_keys:
        sort_keys = [torch.zeros((n,), dtype=torch.int8, device=device)]
    order = ranks.lex_argsort32(sort_keys)
    inv = ranks.apply_inverse(order, [ranks._iota32(n, order.device)])[0]
    order_l = order.long()

    def boundary(cols: List[torch.Tensor]) -> torch.Tensor:
        neq = torch.zeros((max(n - 1, 0),), dtype=torch.bool, device=order.device)
        for c in cols:
            cs = c[order_l]
            neq = neq | (cs[1:] != cs[:-1])
        return torch.cat([torch.ones((1,), dtype=torch.bool, device=order.device), neq])

    dead_cols = [~sel] if sel is not None else []
    pb = boundary(dead_cols + part_cols)
    peerb = pb | boundary(peer_cols) if peer_cols else pb
    part_id, part_start, part_end = _run_bounds(pb)
    dense_peer, peer_start, peer_end = _run_bounds(peerb)
    return WindowLayout(
        n=n, order=order, inv=inv,
        part_start=part_start, part_end=part_end,
        peer_start=peer_start, peer_end=peer_end,
        part_id=part_id, dense_peer=dense_peer,
    )


def _iota(layout: WindowLayout, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(layout.n, dtype=dtype, device=layout.order.device)


def _sorted(layout: WindowLayout, a: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if a is None else a[layout.order.long()]


def _to_orig(layout: WindowLayout, sorted_vals, sorted_valid=None) -> Lowered:
    inv = layout.inv.long()
    return sorted_vals[inv], (sorted_valid[inv] if sorted_valid is not None else None)


def row_number(layout: WindowLayout) -> Lowered:
    return _to_orig(layout, _iota(layout, torch.int64) - layout.part_start + 1)


def rank(layout: WindowLayout) -> Lowered:
    return _to_orig(layout, (layout.peer_start - layout.part_start + 1).to(torch.int64))


def dense_rank(layout: WindowLayout) -> Lowered:
    base = layout.dense_peer[layout.part_start.clamp(0, layout.n - 1).long()]
    return _to_orig(layout, (layout.dense_peer - base + 1).to(torch.int64))


def _frame_bounds(layout: WindowLayout, frame: str, frame_lo=None, frame_hi=None):
    """[lo, hi) sorted-slot range per row. ``rows_offset``: numeric ROWS
    bounds relative to the current row, clamped to the partition."""
    idx = _iota(layout)
    if frame == "partition":
        return layout.part_start, layout.part_end
    if frame == "rows_running":
        return layout.part_start, idx + 1
    if frame == "rows_offset":
        lo = layout.part_start if frame_lo is None else torch.maximum(
            layout.part_start, idx + int(frame_lo))
        hi = layout.part_end if frame_hi is None else torch.minimum(
            layout.part_end, idx + int(frame_hi) + 1)
        return lo, torch.maximum(hi, lo)  # an empty frame has hi == lo
    # default 'running': RANGE UNBOUNDED PRECEDING..CURRENT ROW, peers included
    return layout.part_start, layout.peer_end


def _prefix0(x: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(x, 0, dtype=x.dtype)
    return torch.cat([torch.zeros((1,), dtype=c.dtype, device=c.device), c])


def agg_sum(layout: WindowLayout, arg: Lowered, frame: str, out_dtype: torch.dtype,
            frame_lo=None, frame_hi=None) -> Lowered:
    vals, valid = arg
    x = _sorted(layout, vals).to(out_dtype)
    m = _sorted(layout, valid)
    if m is not None:
        x = torch.where(m, x, torch.zeros_like(x))
    c0 = _prefix0(x)
    lo, hi = _frame_bounds(layout, frame, frame_lo, frame_hi)
    s = c0[hi.long()] - c0[lo.long()]
    cnt = _count_in_frame(m, lo, hi)
    return _to_orig(layout, s, cnt > 0)


def agg_count(layout: WindowLayout, arg: Optional[Lowered], frame: str,
              frame_lo=None, frame_hi=None) -> Lowered:
    lo, hi = _frame_bounds(layout, frame, frame_lo, frame_hi)
    if arg is None or arg[1] is None:
        return _to_orig(layout, (hi - lo).to(torch.int64))
    return _to_orig(layout, _count_in_frame(_sorted(layout, arg[1]), lo, hi))


def _count_in_frame(m: Optional[torch.Tensor], lo, hi) -> torch.Tensor:
    if m is None:
        return (hi - lo).to(torch.int64)
    c0 = _prefix0(m.to(torch.int64))
    return c0[hi.long()] - c0[lo.long()]


def agg_minmax(layout: WindowLayout, arg: Lowered, frame: str, is_min: bool) -> Lowered:
    """Whole-partition min/max through one (partition, value) sort."""
    if frame != "partition":
        raise NotImplementedError("running min/max window frames")
    vals, valid = arg
    if vals.dtype.is_floating_point:
        sentinel = float("inf") if is_min else float("-inf")
    else:
        if vals.dtype == torch.bool:
            vals = vals.to(torch.int32)
        info = torch.iinfo(vals.dtype)
        sentinel = info.max if is_min else info.min
    x = vals if valid is None else torch.where(valid, vals, torch.full_like(vals, sentinel))
    (_, x_by), _ = ranks.lex_sort([layout.part_id, _sorted(layout, x)])
    pos = layout.part_start if is_min else (layout.part_end - 1).clamp(0, layout.n - 1)
    out = x_by[pos.long()]
    lo, hi = _frame_bounds(layout, "partition")
    cnt = _count_in_frame(_sorted(layout, valid), lo, hi)
    return _to_orig(layout, out, cnt > 0)


def shifted_value(layout: WindowLayout, arg: Lowered, offset: int, lead: bool) -> Lowered:
    """lag/lead: the value ``offset`` rows before/after within the
    partition (NULL outside it)."""
    vals, valid = arg
    xs, vs = _sorted(layout, vals), _sorted(layout, valid)
    idx = _iota(layout)
    tgt = idx + offset if lead else idx - offset
    inside = (tgt >= layout.part_start) & (tgt < layout.part_end)
    tgt = tgt.clamp(0, layout.n - 1).long()
    ok = inside if vs is None else (inside & vs[tgt])
    return _to_orig(layout, xs[tgt], ok)


def edge_value(layout: WindowLayout, arg: Lowered, frame: str, first: bool,
               frame_lo=None, frame_hi=None) -> Lowered:
    """first_value / last_value over the frame (default frame: last_value
    is the current peer run's end, as SQL has it)."""
    vals, valid = arg
    xs, vs = _sorted(layout, vals), _sorted(layout, valid)
    lo, hi = _frame_bounds(layout, frame, frame_lo, frame_hi)
    pos = (lo if first else hi - 1).clamp(0, layout.n - 1).long()
    nonempty = hi > lo
    ok = nonempty if vs is None else (vs[pos] & nonempty)
    return _to_orig(layout, xs[pos], ok)


def nth_value(layout: WindowLayout, arg: Lowered, nth: int, frame: str,
              frame_lo=None, frame_hi=None) -> Lowered:
    """nth_value(x, n): the frame's n-th row's value (NULL past its end)."""
    vals, valid = arg
    xs, vs = _sorted(layout, vals), _sorted(layout, valid)
    lo, hi = _frame_bounds(layout, frame, frame_lo, frame_hi)
    pos = lo + (nth - 1)
    inside = pos < hi
    pos = pos.clamp(0, layout.n - 1).long()
    ok = inside if vs is None else (inside & vs[pos])
    return _to_orig(layout, xs[pos], ok)


def ntile(layout: WindowLayout, buckets: int) -> Lowered:
    """ntile(k): k buckets a partition, the earlier ones one row larger
    when the size does not divide."""
    rn0 = _iota(layout, torch.int64) - layout.part_start  # 0-based row number
    size = (layout.part_end - layout.part_start).to(torch.int64)
    q = torch.div(size, buckets, rounding_mode="floor")
    r = size - q * buckets
    big_rows = r * (q + 1)  # rows covered by the (q+1)-sized buckets
    tile = torch.where(
        rn0 < big_rows,
        torch.div(rn0, (q + 1).clamp(min=1), rounding_mode="floor"),
        r + torch.div(rn0 - big_rows, q.clamp(min=1), rounding_mode="floor"),
    )
    return _to_orig(layout, tile + 1)


def percent_rank(layout: WindowLayout) -> Lowered:
    """(rank - 1) / (partition size - 1); 0 for single-row partitions."""
    rk = (layout.peer_start - layout.part_start).to(torch.float64)
    size = (layout.part_end - layout.part_start).to(torch.float64)
    v = torch.where(size > 1, rk / (size - 1.0).clamp(min=1.0), torch.zeros_like(rk))
    return _to_orig(layout, v)


def cume_dist(layout: WindowLayout) -> Lowered:
    """Rows at or before the current peer run over the partition size."""
    covered = (layout.peer_end - layout.part_start).to(torch.float64)
    size = (layout.part_end - layout.part_start).to(torch.float64)
    return _to_orig(layout, covered / size.clamp(min=1.0))
