"""Fused sort-merge join tier: the port of trino_tpu/ops/fused_join.py.

``fused_match_rows`` sorts build and probe keys together (builds first, so
equal keys keep builds before probes) and propagates the matching live
build row to every probe slot of its equal-key run with one running max
over ``run_id * (nb + 1) + (build_row + 1)``; matched rows return to probe
order by one scatter through the sort permutation.

``merge_sorted_build`` serves an already-sorted build (a presorted key
column): only the probe side is sorted, and the rank step is the merge of
ops/merge.py when ``use_pallas`` is set (the name is the reference's
session-property vocabulary; here it selects the Hopper kernel), else
merge ranks over a combined sort (ops/ranks.py).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from trino_tpu_torch.ops import join as join_ops
from trino_tpu_torch.ops import ranks
from trino_tpu_torch.ops.join import _live_mask as _build_live
from trino_tpu_torch.ops.join import probe_valid as _probe_valid

Lowered = Tuple[torch.Tensor, Optional[torch.Tensor]]


def fused_match_rows(
    build_keys: List[Lowered],
    build_sel: Optional[torch.Tensor],
    probe_keys: List[Lowered],
) -> torch.Tensor:
    """Per probe row (original order): the ORIGINAL build row index of a
    live equal-key build row, or -1 when none exists (int32). Duplicate
    build keys resolve to the last live duplicate in sorted order."""
    device = probe_keys[0][0].device
    nb = build_keys[0][0].shape[0]
    np_ = probe_keys[0][0].shape[0]
    if np_ == 0:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    if nb == 0:
        return torch.full((np_,), -1, dtype=torch.int32, device=device)
    n = nb + np_
    operands = []
    for (bv, _), (pv, _) in zip(build_keys, probe_keys):
        bv, pv = join_ops._as_key(bv), join_ops._as_key(pv)
        dt = torch.promote_types(bv.dtype, pv.dtype)
        operands.append(torch.cat([bv.to(dt), pv.to(dt)]))
    idx = ranks._iota32(n, device)
    live_b = _build_live(build_keys, build_sel)
    live_concat = torch.cat([live_b, torch.ones((np_,), dtype=torch.bool, device=device)])
    sorted_cols, (idx_s, live_s) = ranks.lex_sort(operands, [idx, live_concat])
    is_build = idx_s < nb
    neq = torch.zeros((n - 1,), dtype=torch.bool, device=device)
    for c in sorted_cols:
        neq = neq | (c[1:] != c[:-1])
    run_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=device), neq])
    run_id = torch.cumsum(run_start.to(torch.int32), 0, dtype=torch.int32)
    cand_live = is_build & live_s
    stride = nb + 1
    run64 = run_id.to(torch.int64)
    enc = run64 * stride + torch.where(
        cand_live, idx_s.to(torch.int64) + 1, torch.zeros_like(run64))
    m = torch.cummax(enc, 0).values
    has_build = torch.div(m, stride, rounding_mode="floor") == run64
    rem = torch.remainder(m, stride)
    brow_sorted = torch.where(has_build & (rem > 0), (rem - 1).to(torch.int32),
                              torch.full_like(idx_s, -1))
    # back to probe order through the permutation's probe slots; build
    # slots map out of range and are dropped
    probe_pos = torch.where(is_build, np_ + idx_s, idx_s - nb)
    return join_ops.scatter_drop(np_, probe_pos, brow_sorted, -1, torch.int32)


def fused_probe_unique(
    build_keys: List[Lowered],
    build_sel: Optional[torch.Tensor],
    probe_keys: List[Lowered],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(build_row_idx, matched) in probe order."""
    m = fused_match_rows(build_keys, build_sel, probe_keys)
    matched = m >= 0
    pvalid = _probe_valid(probe_keys)
    if pvalid is not None:
        matched = matched & pvalid
    return torch.clamp(m, min=0), matched


def fused_membership(
    build_keys: List[Lowered],
    build_sel: Optional[torch.Tensor],
    probe_keys: List[Lowered],
) -> torch.Tensor:
    """Semi/anti membership: any live equal-key build row flags the probe."""
    _, matched = fused_probe_unique(build_keys, build_sel, probe_keys)
    return matched


def merge_sorted_build(
    build: join_ops.SortedBuild,
    probe_keys: List[Lowered],
    *,
    use_pallas: bool = False,
    pallas_block_build: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(build_row_idx, matched) against an ALREADY-SORTED build.

    PRECONDITION for ``use_pallas``: the caller has proven the dead-row
    sentinel (INT32_MAX) unreachable from the key's value range (executor
    ``_merge_sentinel_safe``). A single int32 key is required for the
    merge kernel; other shapes take the rank merge over a combined sort."""
    from trino_tpu_torch.ops import merge

    device = probe_keys[0][0].device
    nb = build.n
    np_ = probe_keys[0][0].shape[0]
    if np_ == 0 or nb == 0:
        z = torch.zeros((np_,), dtype=torch.int32, device=device)
        return z, torch.zeros((np_,), dtype=torch.bool, device=device)
    pcols = join_ops._probe_cols(build, probe_keys)
    # dead build slots pre-encode as -1
    rows_live = torch.where(build.live, build.rows.to(torch.int32),
                            torch.full_like(build.rows, -1, dtype=torch.int32))
    pv = _probe_valid(probe_keys)
    if (
        use_pallas
        and build.single
        and len(pcols) == 1
        and pcols[0].dtype == torch.int32
        and build.cols[0].dtype == torch.int32
    ):
        # NULL probe slots carry raw values the vrange proof does not
        # bound: mask them in range (0) so no slot equals the INT32_MAX pad;
        # their matches are voided by the validity mask below either way
        pkey = pcols[0] if pv is None else torch.where(pv, pcols[0], torch.zeros_like(pcols[0]))
        perm = ranks.argsort32(pkey).long()
        p_sorted = pkey[perm].contiguous()
        pos = merge.merge_unique_sorted(build.cols[0].contiguous(), p_sorted,
                                        block_build=pallas_block_build)
        (pos_o,) = ranks.apply_inverse(perm, [pos])
        rl = rows_live[pos_o.long().clamp(0, nb - 1)]
        matched = (pos_o >= 0) & (rl >= 0)
    else:
        lo, counts = ranks.sorted_ranks(build.cols, pcols)
        rl = rows_live[lo.long().clamp(0, nb - 1)]
        matched = (counts > 0) & (rl >= 0)
    rows = torch.clamp(rl, min=0)
    if pv is not None:
        matched = matched & pv
    return rows, matched
