"""Capacity-hint reseeding from staged truth (the compiled-tier half of
adaptive rule 2): the port of trino_tpu/adaptive/reseed.py, numpy over the
staged pages' key columns read once to the host.

The static hints of ``sql/planner/stats.py`` guess expansion-join outputs
and hash-exchange block sizes from connector stats with fudge factors
biased high — over-allocating HBM when right and STILL recompiling when
wrong (the double-and-recompile loop). But by the time the compiled tiers
jit, phase 1 has already STAGED every scan host-side: the actual key
columns are sitting in host memory. This module prices the hints from
them —

- expansion joins: per-probe-row build-key multiplicities via one
  ``np.unique`` + ``searchsorted`` give the exact match count (hash
  collisions and pre-filter rows only ever INFLATE it, so the capacity is
  a true upper bound — never a recompile);
- hash exchanges: the per-(source shard, destination partition) send-block
  histogram uses the same splitmix64 combine as the mesh exchange
  (``parallel/exchange.partition_ids`` / ``exec/memory.partition_page_host``),
  so skewed keys price their actual hot-partition block instead of the
  2x-uniform guess;
- the merge kernel's ``jtile:`` window hint from the same histograms.

Consumed by ``CompiledQuery.build`` (exec/compiled.py) and
``DistributedQuery.build`` (parallel/spmd.py) when the
``adaptive_capacity_reseed`` session property is set: reseeded keys REPLACE
the static guesses (reference: AdaptivePlanner swapping estimated stats for
runtime stats).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from trino_tpu_torch.data.page import to_numpy
from trino_tpu_torch.exec.memory import _mix64_np as _mix64
from trino_tpu_torch.sql.planner import plan as P
from trino_tpu_torch.sql.planner.stats import _pow2

# the caps are exact-or-over already; the pow2 rounding of _pow2 (shared
# with the static hints in sql/planner/stats.py, so static and reseeded
# capacities always round identically) is the only headroom they need
_MIN_CAP = 1024
_MIN_XCHG_CAP = 256


@dataclasses.dataclass
class _SideKeys:
    """Host view of one join side's key columns, in staged row order."""

    hash: np.ndarray  # uint64[n], NULLs mapped to the shared null hash
    live: np.ndarray  # bool[n], staged sel AND key non-null (match math)
    sel: np.ndarray  # bool[n], staged sel only (exchange/emit math —
    # null-key rows still ship to the null partition and still emit
    # outer-join slots)
    n_rows: int  # staged rows INCLUDING dead/pad slots (shard math)


def _trace_channel(node: P.PlanNode, ch: int) -> Optional[Tuple[int, int]]:
    """(scan node id, scan channel) a channel traces to through row-local
    operators, or None. Filters/limits along the way only REDUCE rows, so
    counting on the staged (pre-filter) column stays an upper bound."""
    if isinstance(node, P.TableScanNode):
        return node.id, ch
    if isinstance(node, P.ProjectNode):
        from trino_tpu_torch.sql import ir

        e = node.expressions[ch]
        if isinstance(e, ir.ColumnRef):
            return _trace_channel(node.source, e.index)
        return None
    if isinstance(node, (P.FilterNode, P.CompactNode, P.LimitNode,
                         P.TopNNode, P.SortNode)):
        return _trace_channel(node.source, ch)
    return None


def _trace_rows(node: P.PlanNode, staged: Dict[int, object]) -> Optional[int]:
    """Upper-bound LIVE row count of a row-local subtree from its staged
    scan, or None when the subtree is not scan-rooted."""
    if isinstance(node, P.TableScanNode):
        page = staged.get(node.id)
        if page is None:
            return None
        if page.sel is None:
            return int(page.num_rows)
        return int(to_numpy(page.sel).sum())
    if isinstance(node, (P.FilterNode, P.ProjectNode, P.CompactNode,
                         P.LimitNode, P.TopNNode, P.SortNode)):
        return _trace_rows(node.source, staged)
    return None


def _side_keys(staged: Dict[int, object], side: P.PlanNode,
               channels) -> Optional[_SideKeys]:
    """Combined key hash + liveness for one join side, or None when any
    key is untraceable / varchar (probe and build dictionaries are
    page-local — code equality across sides is meaningless)."""
    from trino_tpu_torch.exec.memory import _NULL_HASH

    scan_id = None
    cols = []
    for ch in channels:
        hit = _trace_channel(side, ch)
        if hit is None:
            return None
        sid, sc = hit
        if scan_id is None:
            scan_id = sid
        elif sid != scan_id:
            return None  # keys from two scans: row orders don't align
        page = staged.get(sid)
        if page is None:
            return None
        col = page.columns[sc]
        if col.type.is_varchar:
            return None
        cols.append(col)
    page = staged[scan_id]
    n = int(page.num_rows)
    live = (np.ones(n, bool) if page.sel is None
            else to_numpy(page.sel).astype(bool))
    h = np.zeros(n, np.uint64)
    valid = live.copy()
    for col in cols:
        # low limb only — the cross-side placement contract of
        # partition_page_host / parallel/exchange (hash-equal is a
        # superset of key-equal, which only inflates match counts). NULL
        # keys hash to the shared null constant so they still co-locate
        # for partition counting, but drop out of ``valid`` — they never
        # match.
        k = _mix64(to_numpy(col.values).astype(np.int64))
        if col.nulls is not None:
            nulls = to_numpy(col.nulls).astype(bool)
            k = np.where(nulls, np.uint64(_NULL_HASH), k)
            valid &= ~nulls
        h = _mix64(h ^ k)
    return _SideKeys(hash=h, live=valid, sel=live, n_rows=n)


def _match_counts(probe: _SideKeys, build: _SideKeys) -> np.ndarray:
    """Build-key multiplicity per LIVE probe row (0 for dead/null rows)."""
    bh = build.hash[build.live]
    if len(bh) == 0:
        return np.zeros(probe.n_rows, np.int64)
    uniq, counts = np.unique(bh, return_counts=True)
    idx = np.searchsorted(uniq, probe.hash)
    idx = np.clip(idx, 0, len(uniq) - 1)
    hit = (uniq[idx] == probe.hash) & probe.live
    return np.where(hit, counts[idx], 0).astype(np.int64)


def _group_max(values: np.ndarray, groups: np.ndarray, n_groups: int) -> int:
    """max over groups of the per-group sum of ``values``."""
    sums = np.bincount(groups, weights=values.astype(np.float64),
                       minlength=n_groups)
    return int(sums.max()) if len(sums) else 0


def _shard_ids(k: _SideKeys, n_devices: int) -> np.ndarray:
    """Device shard per staged row: scans stage contiguous equal-length
    shards (stage_sharded_scans pads every shard to the same length)."""
    per_shard = max(k.n_rows // max(n_devices, 1), 1)
    return np.minimum(np.arange(k.n_rows) // per_shard, n_devices - 1)


def _expansion_capacity(node: P.JoinNode, probe: _SideKeys,
                        build: _SideKeys, n_devices: int,
                        partitioned: bool) -> int:
    counts = _match_counts(probe, build)
    if node.join_type == "left":
        # outer probes emit >= one slot each (unmatched and null-key
        # rows included)
        counts = np.where(probe.sel, np.maximum(counts, 1), counts)
    if n_devices <= 1:
        total = int(counts.sum())
        return _pow2(max(total, _MIN_CAP))
    if partitioned:
        # after the co-partitioning exchange, device p joins partition p:
        # its expansion output is exactly partition p's match count
        pid = (probe.hash % np.uint64(n_devices)).astype(np.int64)
        worst = _group_max(counts, pid, n_devices)
    else:
        # broadcast build: device s probes its own shard against the
        # whole build
        worst = _group_max(counts, _shard_ids(probe, n_devices), n_devices)
    return _pow2(max(worst, _MIN_CAP))


def _exchange_block_capacity(k: _SideKeys, n_devices: int) -> int:
    """Exact send-block size for a hash exchange of these rows: the max
    over (source shard, destination partition) of rows sent — the skewed
    hot partition prices its real block instead of the 2x-uniform guess."""
    pid = (k.hash % np.uint64(n_devices)).astype(np.int64)
    shard = _shard_ids(k, n_devices)
    flat = shard * n_devices + pid
    counts = np.bincount(flat[k.sel], minlength=n_devices * n_devices)
    worst = int(counts.max()) if len(counts) else 0
    return _pow2(max(worst, _MIN_XCHG_CAP))


_JTILE_MIN = 512
_JTILE_MAX = 8192


def _merge_tile_hint(probe: _SideKeys, build: _SideKeys) -> int:
    """Build-window rows per probe block for the Pallas tiled merge
    (``jtile:<join id>``), priced from the SAME staged key histograms
    that size the capacities: a probe block of B sorted keys spans about
    ``B * nb/np * max_multiplicity`` build slots, so skewed builds get
    wider DMA windows up front instead of paying extra window iterations
    per block. Rounded to the kernel's 128-lane granularity via pow2,
    clamped to [512, 8192] (VMEM double-buffer budget)."""
    from trino_tpu_torch.ops.merge import BLOCK_PROBE

    bh = build.hash[build.live]
    n_probe = max(int(probe.sel.sum()), 1)
    if len(bh) == 0:
        return _JTILE_MIN
    _, counts = np.unique(bh, return_counts=True)
    mult = int(counts.max())
    est = BLOCK_PROBE * len(bh) * mult // n_probe
    return min(max(_pow2(max(est, 1)), _JTILE_MIN), _JTILE_MAX)


def reseed_capacity_hints(session, root: P.PlanNode,
                          staged: Dict[int, object],
                          n_devices: int = 1) -> Dict[str, int]:
    """Capacity hints priced from the staged scan pages (actual rows/keys)
    for every expansion join and hash exchange whose keys trace to staged
    columns, plus ``jtile:*`` merge-window hints for the fused join tier's
    merge kernel. Returns only the keys it could compute — callers
    ``update()`` them over the static guesses."""
    from trino_tpu_torch.sql.planner import stats

    # jtile hints are consumed ONLY by the opt-in Pallas merge kernel —
    # don't pay the per-join host histogram passes when nothing reads them
    props = getattr(session, "properties", None) or {}
    price_jtile = bool(props.get("fused_join_pallas"))
    hints: Dict[str, int] = {}
    for n in P.walk_plan(root):
        if isinstance(n, P.JoinNode):
            # one histogram pass per side, computed lazily and shared by
            # every hint family (capacity, exchange block, merge tile)
            sides: List = []

            def side_keys(n=n, sides=sides):
                if not sides:
                    sides.append((_side_keys(staged, n.left, n.left_keys),
                                  _side_keys(staged, n.right, n.right_keys)))
                return sides[0]

            partitioned = bool(
                n_devices > 1 and n.left_keys
                and stats.join_repartitions(session, n, n_devices))
            if price_jtile and n.left_keys:
                probe, build = side_keys()
                if probe is not None and build is not None:
                    hints[f"jtile:{n.id}"] = _merge_tile_hint(probe, build)
            if P.uses_expansion_kernel(n):
                if n.left_keys:
                    probe, build = side_keys()
                    if probe is not None and build is not None:
                        hints[f"join:{n.id}"] = _expansion_capacity(
                            n, probe, build, n_devices, partitioned)
                elif not n.singleton:
                    lrows = _trace_rows(n.left, staged)
                    rrows = _trace_rows(n.right, staged)
                    if lrows is not None and rrows is not None:
                        per = (-(-lrows // n_devices)
                               if n_devices > 1 else lrows)
                        hints[f"join:{n.id}"] = _pow2(
                            max(per * rrows, _MIN_CAP))
            if partitioned:
                probe, build = side_keys()
                if probe is not None:
                    hints[f"xchgl:{n.id}"] = _exchange_block_capacity(
                        probe, n_devices)
                if build is not None:
                    hints[f"xchgr:{n.id}"] = _exchange_block_capacity(
                        build, n_devices)
        elif isinstance(n, P.AggregationNode) and n.step == "single" \
                and n_devices > 1 and n.group_channels:
            if stats.agg_repartitions(session, n, n_devices):
                k = _side_keys(staged, n.source, n.group_channels)
                if k is not None:
                    hints[f"xchg:{n.id}"] = _exchange_block_capacity(
                        k, n_devices)
    return hints


def staged_pages_from_arrays(staged_arrays: Dict[int, List],
                             specs: Dict[int, object]) -> Dict[int, object]:
    """Pages of every scan's rows from the SPMD tier's sharded staging
    (``stage_sharded_scans``: a list of arrays a rank), the shards end to
    end in rank order (pad slots stay dead through the sel column) — the
    reseed view of the sharded staging. Shards on different devices meet
    on the host."""
    import torch

    from trino_tpu_torch.exec.page_tree import unflatten_page

    pages = {}
    for nid, shards in staged_arrays.items():
        same = len({str(a.device) for arrs in shards for a in arrs}) <= 1
        flat = [torch.cat([arrs[i] if same else arrs[i].cpu() for arrs in shards])
                for i in range(len(shards[0]))]
        pages[nid] = unflatten_page(specs[nid], flat)
    return pages


def reseed_enabled(session) -> bool:
    props = getattr(session, "properties", None) or {}
    return bool(props.get("adaptive_capacity_reseed", False))


def apply_reseed(session, root, staged: Dict[int, object], n_devices: int,
                 capacity_hints: Dict[str, int]) -> Dict[str, int]:
    """The one reseed integration both compiled tiers call: compute the
    staged-truth hints, REPLACE the static guesses in ``capacity_hints``
    in place, and record the adaptation (a ``plan/adapt`` span + the
    adaptive metric) ONLY when something was actually reseeded — an empty
    result must not masquerade as an adaptation in the trace."""
    reseeded = reseed_capacity_hints(session, root, staged, n_devices)
    if reseeded:
        from trino_tpu_torch.obs import metrics as M
        from trino_tpu_torch.obs import trace as tracing

        capacity_hints.update(reseeded)
        with tracing.span("plan/adapt") as sp:
            sp.set("rule", "capacity-reseed")
            sp.set("reseeded", len(reseeded))
        M.ADAPTIVE_ADAPTATIONS.inc(1, "capacity-reseed")
    return reseeded
