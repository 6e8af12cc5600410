"""approx_distinct (HyperLogLog) and approx_percentile: the port of the
single-step functions of trino_tpu/ops/hll.py.

HyperLogLog with m = 2048 registers (about 2.3% standard error), computed
without a [groups, m] register scatter: rows re-group by (group, bucket)
with the engine's sorted grouping, a register is the segment max of rho
over its pair, and two monotonic segment sums per outer group give the
harmonic sum over present buckets and their count (an absent bucket adds
2^0). The estimate is alpha_m m^2 / denominator with the linear-counting
correction below 2.5 m. approx_percentile reads the nearest rank of a
(group, value) sort: exact, not a sketch. Split over the distributed
path's partial and final steps, it ships a mergeable summary instead
(``percentile_states``: QUANTILE_SAMPLES values at evenly spaced local
ranks and the live count a group; ``percentile_merge``: a weighted
quantile over every producer's summary).

Torch has no full uint64 arithmetic, so the 64-bit hash words live in
int64 tensors: a wrapping multiply is the same bit pattern modulo 2^64,
right shifts are logical (``_lsr``) and the one unsigned comparison (in
``_rho``) treats a word with its top bit set as the largest.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from trino_tpu_torch.ops import groupby as gb
from trino_tpu_torch.ops import ranks
from trino_tpu_torch.ops import segments as seg
from trino_tpu_torch.ops.int128 import _lsr

Lowered = Tuple[torch.Tensor, Optional[torch.Tensor]]

LOG2_M = 11
M = 1 << LOG2_M  # 2048 registers: 1.04 / sqrt(m) = 2.3% standard error
_ALPHA = 0.7213 / (1.0 + 1.079 / M)  # alpha_m for m >= 128


def _signed(u: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 bit patterns (wrapping mod 2^64)."""
    x = (x ^ _lsr(x, 30)) * _M1
    x = (x ^ _lsr(x, 27)) * _M2
    return x ^ _lsr(x, 31)


def _rho(w: torch.Tensor, width: int) -> torch.Tensor:
    """1 + the count of leading zeros of the unsigned word ``w`` within
    ``width`` bits (width + 1 when w == 0): the HLL register value. The bit
    length comes from a shift cascade; a word with its top bit set is
    negative as int64 and counts as at least 2^shift."""
    n = torch.zeros(w.shape, dtype=torch.int32, device=w.device)
    x = w
    for shift in (32, 16, 8, 4, 2, 1):
        mask = (x < 0) | (x >= (1 << shift))
        n = torch.where(mask, n + shift, n)
        x = torch.where(mask, _lsr(x, shift), x)
    bit_length = torch.where(w == 0, torch.zeros_like(n), n + 1)
    return (width - bit_length + 1).to(torch.int32)


def approx_distinct(layout: seg.GroupLayout, arg: Lowered, sel) -> Tuple[torch.Tensor, None]:
    """Per-group HLL estimate (int64). ``arg``/``sel`` are in ORIGINAL row
    order (this re-groups, like agg_count_distinct)."""
    vals, valid = arg
    n = vals.shape[0]
    device = vals.device
    live = sel if sel is not None else torch.ones((n,), dtype=torch.bool, device=device)
    if valid is not None:
        live = live & valid
    if vals.dtype.is_floating_point:
        # the bits of the double: a cast to int64 would merge distinct
        # fractional values
        key_bits = vals.to(torch.float64).view(torch.int64)
    else:
        key_bits = vals.to(torch.int64)
    h = _mix64(key_bits)
    bucket = (h & (M - 1)).to(torch.int32)
    rho = _rho(_lsr(h, LOG2_M), 64 - LOG2_M)

    outer = layout.gids_orig()
    order, gid_sorted, num_pairs, (rho_l,) = gb.group_plan(
        [(outer, None), (bucket, None)], live, payloads=[rho])
    pairs = seg.sorted_layout(order, gid_sorted, num_pairs)
    # two prefixes: live ROWS (dead rows sort last) and live pair SLOTS
    iota = torch.arange(n, dtype=torch.int32, device=device)
    row_live = iota < live.to(torch.int32).sum()
    slot_live = iota < num_pairs.to(torch.int32)
    register = seg.seg_minmax(pairs, rho_l, row_live, is_min=False)
    register = torch.where(slot_live, register, torch.zeros_like(register))
    # the outer group of each pair slot (dead pairs past every real group)
    outer_of_pair = torch.where(
        slot_live, outer[pairs.rep.long().clamp(0, n - 1)].to(torch.int32),
        torch.full((n,), layout.capacity, dtype=torch.int32, device=device))
    inv_pow = torch.where(slot_live, torch.exp2(-register.to(torch.float64)),
                          torch.zeros((n,), dtype=torch.float64, device=device))
    sum_present = seg.monotonic_segment_sum(inv_pow, outer_of_pair, layout.capacity)
    present = seg.monotonic_segment_sum(slot_live.to(torch.int64), outer_of_pair,
                                        layout.capacity)
    denom = sum_present + (M - present).to(torch.float64)
    raw = _ALPHA * M * M / denom.clamp(min=1e-9)
    v_zero = (M - present).to(torch.float64)
    linear = M * torch.log((M / v_zero.clamp(min=1e-9)).clamp(min=1.0))
    est = torch.where((raw <= 2.5 * M) & (v_zero > 0), linear, raw)
    out = torch.round(est).to(torch.int64)
    return torch.where(present > 0, out, torch.zeros_like(out)), None


def approx_percentile(layout: seg.GroupLayout, vals_l: torch.Tensor, m_l,
                      p: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group percentile by nearest rank over a (group, value) sort.
    ``vals_l``/``m_l`` are in layout space (group_structure payloads)."""
    x_by_group, starts, cnt = _by_group(layout, vals_l, m_l)
    nn = x_by_group.shape[0]
    rank = (torch.ceil(p * cnt.to(torch.float64)).to(torch.int64) - 1).clamp(min=0)
    pos = (starts.to(torch.int64) + rank).clamp(0, nn - 1)
    return x_by_group[pos], cnt > 0


def _direct_ranges(layout: seg.GroupLayout, m_l):
    """(starts, live counts) per slot of a direct layout, from the per-slot
    row counts (a (gid, value) sort puts each slot's rows together)."""
    cnt_all = seg.seg_count(layout, None)  # rows per slot, masked ones included
    starts = torch.cat([torch.zeros((1,), dtype=torch.int64, device=cnt_all.device),
                        torch.cumsum(cnt_all, 0)[:-1]]).to(torch.int32)
    return starts, seg.seg_count(layout, m_l)


# Mergeable quantile-summary width (the reference's QUANTILE_SAMPLES: 64
# rank intervals, a worst-case rank error of about 1/128 after merging)
QUANTILE_SAMPLES = 65


def _by_group(layout: seg.GroupLayout, vals_l: torch.Tensor, m_l):
    """(values sorted by (group, value) with dead rows as the largest
    value, each slot's start, each slot's live count)."""
    if vals_l.dtype.is_floating_point:
        sentinel = float("inf")
    else:
        sentinel = torch.iinfo(vals_l.dtype).max
    x = vals_l if m_l is None else torch.where(m_l, vals_l, torch.full_like(vals_l, sentinel))
    if layout.is_direct:
        (_, x_by_group), _ = ranks.lex_sort([layout.gids, x])
        starts, cnt = _direct_ranges(layout, m_l)
    else:
        (_, x_by_group), _ = ranks.lex_sort([layout.gid_sorted, x])
        starts = layout.starts
        cnt = seg.seg_count(layout, m_l)
    return x_by_group, starts, cnt


def percentile_states(layout: seg.GroupLayout, vals_l: torch.Tensor, m_l):
    """Partial approx_percentile state: per group, QUANTILE_SAMPLES values
    at evenly spaced local ranks (each marked live where the group has a
    live row) and the live count. ``vals_l``/``m_l`` are in layout space."""
    x_by_group, starts, cnt = _by_group(layout, vals_l, m_l)
    nn = x_by_group.shape[0]
    device = vals_l.device
    j = torch.arange(QUANTILE_SAMPLES, dtype=torch.float64, device=device) / (QUANTILE_SAMPLES - 1)
    ranks_ = torch.round(
        j[None, :] * (cnt - 1).clamp(min=0).to(torch.float64)[:, None]).to(torch.int64)
    pos = (starts.to(torch.int64)[:, None] + ranks_).clamp(0, max(nn - 1, 0))
    samples = x_by_group[pos]  # [capacity, SAMPLES]
    live = cnt > 0
    out = [(samples[:, k], live) for k in range(QUANTILE_SAMPLES)]
    out.append((cnt, None))
    return out


def percentile_merge(layout: seg.GroupLayout, samples, cnt_state, p: float):
    """Final approx_percentile: the lower weighted percentile over every
    producer's summary. Each partial row spreads its SAMPLES values at
    weight count/SAMPLES; one stable (group, value) sort and a
    cumulative-weight search a group slot. ``samples``/``cnt_state`` are
    layout-space payloads of the final grouping."""
    S = len(samples)
    cnt_l, _ = cnt_state
    vals = torch.stack([v for v, _ in samples], dim=1)  # [n_l, S]
    valid0 = samples[0][1]
    live_row = cnt_l > 0
    if valid0 is not None:
        live_row = live_row & valid0
    w_row = torch.where(live_row, cnt_l.to(torch.float64) / S,
                        torch.zeros(cnt_l.shape, dtype=torch.float64, device=cnt_l.device))
    if layout.is_direct:
        gid_l = layout.gids
        starts_l, _ = _direct_ranges(layout, None)
        ends_l = starts_l.to(torch.int64) + seg.seg_count(layout, None)
    else:
        gid_l = layout.gid_sorted
        starts_l = layout.starts
        ends_l = layout.ends
    gid2 = torch.repeat_interleave(gid_l, S)
    x2 = vals.reshape(-1)
    w2 = torch.repeat_interleave(w_row, S)
    (_, x_s), (w_s,) = ranks.lex_sort([gid2, x2], [w2])
    c = torch.cumsum(w_s, 0)
    c0 = torch.cat([torch.zeros((1,), dtype=c.dtype, device=c.device), c])
    e_start = starts_l.to(torch.int64) * S
    e_end = ends_l.to(torch.int64) * S
    w_group = c0[e_end] - c0[e_start]
    target = c0[e_start] + p * w_group
    pos = torch.searchsorted(c, target, side="left")
    pos = torch.minimum(torch.maximum(pos, e_start), torch.maximum(e_end - 1, e_start))
    out = x_s[pos.clamp(0, max(x_s.shape[0] - 1, 0))]
    return out, w_group > 0
