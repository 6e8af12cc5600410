"""Join kernels: lookup (N:1) and semi/anti membership, sort-merge and dense
direct-address, and the M:N expansion — the port of trino_tpu/ops/join.py.

The build side sorts by key once; probe ranges come from merge ranks
(ops/ranks.py). Single-key builds mask dead rows with the key dtype's max
(sentinel) so they sort last; multi-key builds carry a leading dead-flag
column instead. ``Lowered`` is a (values, valid-or-None) pair.

Scatters with JAX's ``mode="drop"`` (out-of-range indices are dropped)
write out-of-range indices to one scratch slot past the end instead:
``index_put_`` raises on an out-of-range index, and redirecting keeps the
scatter free of a host sync.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from trino_tpu_torch.ops import ranks

Lowered = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _is_int(dt: torch.dtype) -> bool:
    return not dt.is_floating_point and not dt.is_complex and dt != torch.bool


def _sentinel_max(dtype: torch.dtype):
    """Largest value of the key dtype — dead rows sort last under it."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


_INT_WIDEN = {torch.int8: torch.int16, torch.int16: torch.int32,
              torch.int32: torch.int64}


def scatter_drop(size: int, idx: torch.Tensor, vals, fill, dtype) -> torch.Tensor:
    """``full(size, fill).at[idx].set(vals, mode="drop")``: indices outside
    [0, size) land in a scratch slot that is cut off."""
    idx = idx.long()
    inb = (idx >= 0) & (idx < size)
    safe = torch.where(inb, idx, torch.full_like(idx, size))
    out = torch.full((size + 1,), fill, dtype=dtype, device=idx.device)
    if not torch.is_tensor(vals):
        vals = torch.full(idx.shape, vals, dtype=dtype, device=idx.device)
    out.index_put_((safe,), vals.to(dtype))
    return out[:size]


def align_join_keys(
    build_keys: List[Lowered],
    probe_keys: List[Lowered],
    build_vranges=None,
    probe_vranges=None,
) -> Tuple[List[Lowered], List[Lowered]]:
    """Cast each (build, probe) key pair to its common physical dtype. Bool
    keys promote to int8. Single integer keys widen one step unless the
    pair's value ranges prove the dtype max (the dead-row sentinel)
    unreachable."""
    n = len(build_keys)
    single = n == 1
    if build_vranges is None:
        build_vranges = [None] * n
    if probe_vranges is None:
        probe_vranges = [None] * n
    out_b, out_p = [], []
    for (bv, bva), (pv, pva), bvr, pvr in zip(
        build_keys, probe_keys, build_vranges, probe_vranges
    ):
        dt = torch.promote_types(bv.dtype, pv.dtype)
        if dt == torch.bool:
            dt = torch.int8
        if single and _is_int(dt):
            proven = (
                bvr is not None and pvr is not None
                and max(bvr[1], pvr[1]) < torch.iinfo(dt).max
            )
            if not proven and dt in _INT_WIDEN:
                dt = _INT_WIDEN[dt]
        out_b.append((bv.to(dt), bva))
        out_p.append((pv.to(dt), pva))
    return out_b, out_p


@dataclasses.dataclass
class SortedBuild:
    """Build side sorted lexicographically by key, dead rows last."""

    cols: List[torch.Tensor]
    rows: torch.Tensor  # original row index per sorted slot (int32)
    live: torch.Tensor  # bool per sorted slot
    single: bool  # True -> cols == [sentinel-masked key], no flag column

    @property
    def n(self) -> int:
        return self.rows.shape[0]


def _live_mask(keys: List[Lowered], sel: Optional[torch.Tensor]) -> torch.Tensor:
    n = keys[0][0].shape[0]
    live = torch.ones((n,), dtype=torch.bool, device=keys[0][0].device)
    if sel is not None:
        live = live & sel
    for _, valid in keys:
        if valid is not None:
            live = live & valid
    return live


def _as_key(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int8) if v.dtype == torch.bool else v


def build_side(keys: List[Lowered], sel: Optional[torch.Tensor],
               presorted: bool = False) -> SortedBuild:
    """Sort the build side by composite key; dead/null rows sort last and
    never match. ``presorted``: the caller proves a single null-free key
    already ascending with dead rows a tail — the sort is skipped (the
    sentinel-masked dead tail keeps the array sorted)."""
    live = _live_mask(keys, sel)
    n = live.shape[0]
    iota = ranks._iota32(n, live.device)
    if len(keys) == 1:
        vals = _as_key(keys[0][0])
        k = torch.where(live, vals, torch.full_like(vals, _sentinel_max(vals.dtype)))
        if presorted and keys[0][1] is None:
            return SortedBuild([k], iota, live, True)
        (k_s,), (live_s, order) = ranks.lex_sort([k], [live, iota])
        return SortedBuild([k_s], order, live_s, True)
    dead = (~live).to(torch.int8)
    masked = [torch.where(live, _as_key(v), torch.zeros_like(_as_key(v)))
              for v, _ in keys]
    sorted_keys, (live_s, order) = ranks.lex_sort([dead] + masked, [live, iota])
    return SortedBuild(sorted_keys, order, live_s, False)


def _probe_cols(build: SortedBuild, probe_keys: List[Lowered]) -> List[torch.Tensor]:
    """Probe-side search columns aligned with ``build.cols``."""
    if build.single:
        return [_as_key(probe_keys[0][0])]
    m = probe_keys[0][0].shape[0]
    flag = torch.zeros((m,), dtype=torch.int8, device=probe_keys[0][0].device)
    return [flag] + [_as_key(v) for v, _ in probe_keys]


def probe_valid(probe_keys: List[Lowered]) -> Optional[torch.Tensor]:
    """AND of per-column probe validity (NULL keys never match)."""
    valid = None
    for _, v in probe_keys:
        if v is not None:
            valid = v if valid is None else (valid & v)
    return valid


def probe_counts(
    build: SortedBuild,
    probe_keys: List[Lowered],
    probe_sel: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per probe row: the sorted-build range start and match count. Dead
    probe rows (sel/NULL key) count 0."""
    probe = _probe_cols(build, probe_keys)
    lo, counts = ranks.sorted_ranks(build.cols, probe)
    zero = torch.zeros_like(counts)
    counts = torch.where(build.live[lo.long().clamp(0, build.n - 1)], counts, zero)
    pvalid = probe_valid(probe_keys)
    if pvalid is not None:
        counts = torch.where(pvalid, counts, zero)
    if probe_sel is not None:
        counts = torch.where(probe_sel, counts, zero)
    return lo, counts


def expand(counts: torch.Tensor, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map output slot j -> (probe row, offset within its match range).

    Returns (probe_row[cap], offset_in_range[cap], live[cap], total), all
    indices int64. The output is probe-major: all matches of probe row 0,
    then row 1, and so on."""
    n = counts.shape[0]
    device = counts.device
    if n == 0:  # zero-row probe page: every output slot dead
        z = torch.zeros((capacity,), dtype=torch.int64, device=device)
        return z, z, torch.zeros((capacity,), dtype=torch.bool, device=device), \
            torch.zeros((), dtype=torch.int64, device=device)
    offsets = torch.cumsum(counts.to(torch.int64), 0)  # inclusive; totals pass 2^31
    total = offsets[n - 1]
    starts = offsets - counts.to(torch.int64)
    j = torch.arange(capacity, dtype=torch.int64, device=device)
    p = torch.searchsorted(offsets, j, right=True).clamp(0, n - 1)
    k = j - starts[p]
    live = j < torch.clamp(total, max=capacity)
    return p, k, live, total


def probe_unique(
    build: SortedBuild, probe_keys: List[Lowered]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe against a unique-key build. Returns (build_row_idx, matched)."""
    lo, counts = probe_counts(build, probe_keys, None)
    pos = lo.long().clamp(0, build.n - 1)
    return build.rows[pos], counts > 0


def membership(
    build_keys: List[Lowered],
    build_sel: Optional[torch.Tensor],
    probe_keys: List[Lowered],
    presorted: bool = False,
) -> torch.Tensor:
    """Semi-join membership test (build side may have duplicates)."""
    build = build_side(build_keys, build_sel, presorted=presorted)
    _, counts = probe_counts(build, probe_keys, None)
    return counts > 0


# ---------------------------------------------------------------- dense path
# Direct-address join: when the single integer build key rides a known value
# range whose span fits a table, the build scatters row ids into a
# span-sized table and the probe does one bounded gather — no sort.
DENSE_SPAN_MAX = 1 << 27  # int32 table slots (512 MiB worst case)


def dense_span(build_vrange, n_build: int) -> Optional[Tuple[int, int]]:
    """(lo, span) when a direct-address table is worth it, else None."""
    if build_vrange is None:
        return None
    lo, hi = int(build_vrange[0]), int(build_vrange[1])
    span = hi - lo + 1
    if span <= 0 or span > DENSE_SPAN_MAX:
        return None
    if span > 128 * max(n_build, 1024):
        return None
    return lo, span


def dense_unique_table(
    key: Lowered, sel: Optional[torch.Tensor], lo: int, span: int
) -> torch.Tensor:
    """Build row ids (+1; 0 = empty) scattered into the span table; dead
    rows are dropped. The planner proved live-key uniqueness."""
    vals, valid = key
    n = vals.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=vals.device)
    live = torch.ones((n,), dtype=torch.bool, device=vals.device) if sel is None else sel
    if valid is not None:
        live = live & valid
    idx = torch.where(live, vals.to(torch.int64) - lo, span + iota)
    return scatter_drop(span, idx, iota.to(torch.int32) + 1, 0, torch.int32)


def dense_probe_unique(
    table: torch.Tensor, key: Lowered, lo: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(build_row_idx, matched) — the dense analog of probe_unique."""
    vals, valid = key
    span = table.shape[0]
    v = vals.to(torch.int64)
    slot = table[(v - lo).clamp(0, span - 1)]
    matched = (v >= lo) & (v < lo + span) & (slot > 0)
    if valid is not None:
        matched = matched & valid
    return torch.clamp(slot - 1, min=0), matched


def dense_membership(
    build_key: Lowered, build_sel: Optional[torch.Tensor],
    probe_key: Lowered, lo: int, span: int,
) -> torch.Tensor:
    """Semi-join membership via a boolean table (one scatter — build
    duplicates all write True — and one bounded gather)."""
    bvals, bvalid = build_key
    live = (torch.ones((bvals.shape[0],), dtype=torch.bool, device=bvals.device)
            if build_sel is None else build_sel)
    if bvalid is not None:
        live = live & bvalid
    idx = torch.where(live, bvals.to(torch.int64) - lo,
                      torch.full_like(bvals, span, dtype=torch.int64))
    lut = scatter_drop(span, idx, True, False, torch.bool)
    pvals, pvalid = probe_key
    v = pvals.to(torch.int64)
    hit = (v >= lo) & (v < lo + span) & lut[(v - lo).clamp(0, span - 1)]
    if pvalid is not None:
        hit = hit & pvalid
    return hit


def gather_columns(
    cols: List[Lowered], rows: torch.Tensor, matched: torch.Tensor
) -> List[Lowered]:
    """Gather build columns to probe positions; unmatched rows become NULL."""
    if not cols:
        return []
    n = cols[0][0].shape[0]
    safe = rows.long().clamp(0, n - 1)
    arrays = [vals for vals, _ in cols] + [valid for _, valid in cols if valid is not None]
    gathered = ranks.batched_gather(arrays, safe)
    out: List[Lowered] = []
    vi = len(cols)
    for i, (_, valid) in enumerate(cols):
        if valid is None:
            out.append((gathered[i], matched))
        else:
            out.append((gathered[i], gathered[vi] & matched))
            vi += 1
    return out
