"""Aggregate accumulation over a GroupLayout: the port of the
trino_tpu/ops/aggregate.py: count, sum (int64 and the exact int128 limb
sum), avg through ``finish_avg``, min, max, count(DISTINCT), the first
live value (arbitrary), min_by/max_by, the bivariate family (corr, covar,
regr), the distinct (group, key) pairs of the map-building aggregates and
the variance family's (count, mean, m2) states.

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


def agg_first(layout: GroupLayout, arg: Lowered, sel):
    """arbitrary()/any_value(): the first live non-null value per group (any
    value is legal; the first is deterministic). A per-slot min of masked
    positions, then one gather."""
    vals, valid = arg
    m = _live(sel, valid)
    n = layout.n
    pos = torch.arange(n, dtype=torch.int32, device=vals.device)
    cand = pos if m is None else torch.where(m, pos, torch.full_like(pos, n))
    first = seg.seg_minmax(layout, cand, None, is_min=True)
    return vals[first.clamp(0, n - 1).long()], first < n


def agg_minmax_by(layout: GroupLayout, arg: Lowered, key: Lowered, sel, is_min: bool):
    """min_by/max_by(x, y): x at the first row (in layout order) holding
    the group's extreme y; rows with NULL y are ignored."""
    vals, valid = arg
    kv, kvalid = key
    m = _live(sel, kvalid)
    best = seg.seg_minmax(layout, kv, m, is_min)
    n = layout.n
    per_row_best = best[layout.gids_layout().clamp(0, layout.capacity - 1).long()]
    hit = kv == per_row_best
    if m is not None:
        hit = hit & m
    pos = torch.arange(n, dtype=torch.int32, device=kv.device)
    first = seg.seg_minmax(layout, torch.where(hit, pos, torch.full_like(pos, n)), None,
                           is_min=True)
    has = first < n
    idx = first.clamp(0, n - 1).long()
    return vals[idx], (has if valid is None else has & valid[idx])


def agg_bivariate(layout: GroupLayout, argy: Lowered, argx: Lowered, sel,
                  fn: str, y_scale: int, x_scale: int):
    """corr / covar_samp / covar_pop / regr_slope / regr_intercept over
    (y, x) pairs, ignoring rows where either side is NULL: five segment
    sums of raw moments in float64."""
    yv, yvalid = argy
    xv, xvalid = argx
    m = _live(sel, _live(yvalid, xvalid))
    y = yv.to(torch.float64)
    x = xv.to(torch.float64)
    if y_scale:
        y = y / (10.0 ** y_scale)
    if x_scale:
        x = x / (10.0 ** x_scale)
    f64 = torch.float64
    cnt = seg.seg_count(layout, m)
    sx = seg.seg_sum(layout, x, m, f64)
    sy = seg.seg_sum(layout, y, m, f64)
    sxy = seg.seg_sum(layout, x * y, m, f64)
    sxx = seg.seg_sum(layout, x * x, m, f64)
    syy = seg.seg_sum(layout, y * y, m, f64)
    nf = cnt.clamp(min=1).to(f64)
    mean_x = sx / nf
    mean_y = sy / nf
    cov_pop = sxy / nf - mean_x * mean_y
    var_x = sxx / nf - mean_x * mean_x
    var_y = syy / nf - mean_y * mean_y
    one = torch.ones_like(var_x)
    if fn == "covar_pop":
        return cov_pop, cnt > 0
    if fn == "covar_samp":
        return (sxy - sx * sy / nf) / (nf - 1.0).clamp(min=1.0), cnt > 1
    if fn == "corr":
        denom = torch.sqrt((var_x * var_y).clamp(min=0.0))
        return cov_pop / torch.where(denom > 0, denom, one), (cnt > 1) & (denom > 0)
    slope = cov_pop / torch.where(var_x > 0, var_x, one)
    if fn == "regr_slope":
        return slope, (cnt > 1) & (var_x > 0)
    if fn == "regr_intercept":
        return mean_y - slope * mean_x, (cnt > 1) & (var_x > 0)
    raise NotImplementedError(fn)


def grouped_pairs(layout: GroupLayout, key: Lowered, sel):
    """Distinct (group, key) pairs, the entries of the map-building
    aggregates: the count(DISTINCT) re-grouping, each run one entry, runs
    ordered by outer group and contiguous from slot 0.

    Returns (entry_counts[capacity] int32, rep[n] original-row index per
    entry slot, run_counts[n] int64 rows per entry, entry_live[n] bool)."""
    from trino_tpu_torch.ops import groupby as gb

    vals, valid = key
    n = vals.shape[0]
    live = _live(sel, valid)
    outer_gids = layout.gids_orig()
    order, gid_sorted, num_inner, _ = gb.group_plan([(outer_gids, None), (vals, None)], live)
    inner = seg.sorted_layout(order, gid_sorted, num_inner)
    entry_live = torch.arange(n, device=vals.device) < num_inner
    rep = inner.rep.long().clamp(0, n - 1)
    outer_of_slot = torch.where(
        entry_live, outer_gids[rep].to(torch.int32),
        torch.full((n,), layout.capacity, dtype=torch.int32, device=vals.device))
    entry_counts = seg.monotonic_segment_sum(
        entry_live.to(torch.int64), outer_of_slot, layout.capacity).to(torch.int32)
    run_counts = (inner.ends - inner.starts).to(torch.int64)
    return entry_counts, rep.to(inner.rep.dtype), run_counts, entry_live


def var_states(layout: GroupLayout, arg: Lowered, sel, scale: int):
    """(count, mean, m2) state of the variance family, two-pass: the group
    mean first, then the sum of squares centred on it, which stays well
    conditioned when |mean| >> stddev. ``scale``: the argument's decimal
    scale (0 for integers and floats)."""
    vals, valid = arg
    m = _live(sel, valid)
    x = vals.to(torch.float64)
    if scale:
        x = x / (10.0 ** scale)
    cnt = seg.seg_count(layout, m)
    s1 = seg.seg_sum(layout, x, m, torch.float64)
    mean = s1 / cnt.to(torch.float64).clamp(min=1.0)
    centered = x - mean[layout.gids_layout().clamp(0, layout.capacity - 1).long()]
    m2 = seg.seg_sum(layout, centered * centered, m, torch.float64)
    return cnt, mean, m2


def combine_var_states(layout: GroupLayout, cnt_i, mean_i, m2_i, m):
    """Per-slot merge of (count, mean, m2) states, the multi-way Chan
    decomposition: N = sum n_i, mean = sum n_i mean_i / N,
    M2 = sum M2_i + sum n_i (mean_i - mean)^2."""
    n_i = cnt_i.to(torch.float64)
    if m is not None:
        n_i = torch.where(m, n_i, torch.zeros_like(n_i))
    cnt = seg.seg_sum(layout, cnt_i, m, torch.int64)
    s1 = seg.seg_sum(layout, n_i * mean_i, None, torch.float64)
    mean = s1 / cnt.to(torch.float64).clamp(min=1.0)
    d = mean_i - mean[layout.gids_layout().clamp(0, layout.capacity - 1).long()]
    m2 = seg.seg_sum(layout, m2_i + n_i * d * d, m, torch.float64)
    return cnt, mean, m2


def agg_var(layout: GroupLayout, arg: Lowered, sel, kind: str, scale: int = 0):
    """The variance/stddev family: states, then the pop/samp finisher."""
    cnt, mean, m2 = var_states(layout, arg, sel, scale)
    return finish_var(cnt, mean, m2, kind)


def finish_var(cnt, mean, m2, kind: str):
    """(value, valid) from a (count, mean, m2) state."""
    n = cnt.to(torch.float64)
    m2 = m2.clamp(min=0.0)  # floating-point negatives
    pop = kind.endswith("_pop")
    denom = n.clamp(min=1.0) if pop else (n - 1.0).clamp(min=1.0)
    var = m2 / denom
    out = torch.sqrt(var) if kind.startswith("stddev") else var
    return out, (cnt >= 1) if pop else (cnt >= 2)


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
