"""Plan fragmenter: cut the plan into exchange-separated fragments.

Reference: ``core/trino-main/.../sql/planner/PlanFragmenter.java:94`` cuts at
remote ExchangeNodes into PlanFragments with PartitioningHandles
(SystemPartitioningHandle.java:48-57). Here the same cuts describe how the
SPMD executor maps the query onto the mesh (parallel/spmd.py):

- SOURCE fragments: sharded scans + local work, one shard per device;
- partial->final aggregations cut at a GATHER_STATES exchange (all_gather of
  partial-state pages);
- lookup/semi join build sides cut at BROADCAST exchanges (all_gather of the
  build page);
- the root fragment is SINGLE (sort/topN/limit/output over the gathered,
  replicated result).

Unlike the reference, a fragment boundary is not a process/wire boundary on
the intra-slice path — every exchange compiles to a collective inside one
program. The fragment tree IS the scheduling unit for the multi-host DCN
tier (trino_tpu/server: coordinator schedules source fragments onto
workers, pages stream over HTTP) and drives EXPLAIN (TYPE DISTRIBUTED).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Tuple

from trino_tpu_torch.sql.planner import plan as P

_frag_ids = itertools.count()


@dataclasses.dataclass
class RemoteSourceNode(P.PlanNode):
    """Leaf standing for another fragment's output (reference:
    plan/RemoteSourceNode.java)."""

    fragment_id: int = 0
    types: List = None
    names: List[str] = None
    exchange_type: str = "gather"  # gather | broadcast | gather_states
    # ACTUAL output rows of the producing stage, stamped at the stage
    # boundary by the adaptive re-planner (trino_tpu/adaptive/): downstream
    # cardinality estimation then starts from truth — the
    # TableScanNode.runtime_rows analog on fragment boundaries.
    runtime_rows: Optional[int] = None

    @property
    def output_types(self):
        return list(self.types)

    @property
    def output_names(self):
        return list(self.names)


@dataclasses.dataclass
class PlanFragment:
    # 'source' (sharded over splits) | 'hash' (one task per key partition)
    # | 'single' (replicated/coordinator)
    id: int
    partitioning: str
    root: P.PlanNode
    # producer-side hash partitioning of this fragment's OUTPUT: the task
    # splits its result by hash of these channels into one stream per
    # consumer (FIXED_HASH_DISTRIBUTION's PartitionedOutputOperator role)
    output_partition_channels: Optional[List[int]] = None
    # adaptive skew mitigation (trino_tpu/adaptive/replanner.py): rows of
    # these HOT partitions spread round-robin across all partitions
    # (probe side) / replicate into every partition (build side) — set
    # only on salted re-run fragments the re-planner creates
    skew_spread_partitions: Optional[List[int]] = None
    skew_replicate_partitions: Optional[List[int]] = None


def _hash_distributed_final(session, node: P.AggregationNode) -> bool:
    """Hash-distribute the FINAL aggregation stage when the group space is
    too big to gather into one process (threshold: the same
    gather_max_rows_per_device session property the SPMD tier uses).
    Partitioned outputs spool per partition (server/task.py), so the FTE
    retry policy no longer forces the gather path."""
    if session is None or not node.group_channels:
        return False
    from trino_tpu_torch.sql.planner import stats

    rows = stats.estimate_rows(session, node.source)
    return rows > stats._gather_max_rows(session)


def _colocated_join(session, node: P.JoinNode, left, right) -> bool:
    """True when both join sides trace to scans whose connector-declared
    partitionings share a family on exactly the join keys, and neither
    scan's static constraint narrows the partitioning column (which could
    desynchronize the two sides' split boundaries). Split alignment then
    holds by the connector contract: same family => same key->split map."""
    if not node.left_keys or len(node.left_keys) != 1:
        return False
    if node.join_type not in ("inner", "semi", "anti", "left"):
        return False
    from trino_tpu_torch.sql.planner.optimizer import _trace_to_scan

    lt = _trace_to_scan(left, node.left_keys[0])
    rt = _trace_to_scan(right, node.right_keys[0])
    if lt is None or rt is None:
        return False
    (lscan, lcol), (rscan, rcol) = lt, rt
    if lscan.catalog != rscan.catalog:
        return False
    conn = session.catalogs.get(lscan.catalog)
    if conn is None:
        return False
    lp = conn.table_partitioning(lscan.schema, lscan.table)
    rp = conn.table_partitioning(rscan.schema, rscan.table)
    if lp is None or rp is None or lp.family != rp.family:
        return False
    if lp.columns != (lcol,) or rp.columns != (rcol,):
        return False
    for scan, col in ((lscan, lcol), (rscan, rcol)):
        td = scan.constraint
        if td is not None and not td.domain(col).is_all():
            return False  # key-narrowed splits could misalign
    return True


def fragment_plan(root: P.OutputNode, session=None) -> List[PlanFragment]:
    """Cut the optimized plan into fragments mirroring the SPMD execution."""
    global _frag_ids
    _frag_ids = itertools.count()
    fragments: List[PlanFragment] = []

    def cut(node: P.PlanNode, fragments: List[PlanFragment]) -> Tuple[P.PlanNode, bool]:
        """Returns (node-in-current-fragment, is_replicated)."""
        if isinstance(node, P.TableScanNode):
            return node, False
        if isinstance(node, (P.FilterNode, P.ProjectNode, P.LimitNode, P.CompactNode)):
            src, rep = cut(node.source, fragments)
            node.source = src
            return node, rep
        if isinstance(node, P.AggregationNode):
            src, rep = cut(node.source, fragments)
            if rep:
                node.source = src
                return node, True
            if not P.can_split_aggs(node.aggregates):
                # DISTINCT aggregates can't be split partial/final: gather the
                # raw rows, aggregate single-step above the exchange
                fid = next(_frag_ids)
                fragments.append(PlanFragment(fid, "source", src))
                node.source = RemoteSourceNode(
                    fragment_id=fid,
                    types=src.output_types,
                    names=src.output_names,
                    exchange_type="gather",
                )
                return node, True
            # partial in a source fragment, final above a state exchange
            partial = P.AggregationNode(
                src, node.group_channels, node.aggregates, step="partial",
                names=node.names,
            )
            k = len(node.group_channels)
            if _hash_distributed_final(session, node):
                # FIXED_HASH_DISTRIBUTION: partial tasks partition their
                # state pages by group-key hash; one FINAL task per
                # partition aggregates disjoint key sets in parallel —
                # no process ever holds all groups (reference:
                # PagePartitioner producer + hash-distributed final stage)
                fid = next(_frag_ids)
                fragments.append(PlanFragment(
                    fid, "source", partial,
                    output_partition_channels=list(range(k))))
                remote = RemoteSourceNode(
                    fragment_id=fid,
                    types=partial.output_types,
                    names=partial.output_names,
                    exchange_type="partitioned",
                )
                final = P.AggregationNode(
                    remote, list(range(k)), node.aggregates, step="final",
                    names=node.names,
                )
                hfid = next(_frag_ids)
                fragments.append(PlanFragment(hfid, "hash", final))
                return RemoteSourceNode(
                    fragment_id=hfid,
                    types=final.output_types,
                    names=final.output_names,
                    exchange_type="gather",
                ), True
            fid = next(_frag_ids)
            fragments.append(PlanFragment(fid, "source", partial))
            remote = RemoteSourceNode(
                fragment_id=fid,
                types=partial.output_types,
                names=partial.output_names,
                exchange_type="gather_states",
            )
            final = P.AggregationNode(
                remote, list(range(k)), node.aggregates, step="final", names=node.names
            )
            return final, True
        if isinstance(node, P.JoinNode):
            left, lrep = cut(node.left, fragments)
            right, rrep = cut(node.right, fragments)
            if (session is not None and not lrep and not rrep
                    and _colocated_join(session, node, left, right)):
                # connector-partitioned co-located join (reference:
                # ConnectorNodePartitioningProvider + bucketed-table
                # execution): both sides' scans split by the SAME key
                # boundaries, and the scheduler assigns same-index splits
                # to the same task — so the join runs INSIDE the source
                # fragment with ZERO exchange on either side.
                node.left, node.right = left, right
                node.distribution = "colocated"
                return node, False
            if (session is not None and not lrep and not rrep
                    and node.left_keys and node.join_type in ("inner", "semi",
                                                              "anti", "left")):
                from trino_tpu_torch.sql.planner import stats

                if stats.join_repartitions(session, node, 1):
                    # co-partitioned join (FIXED_HASH_DISTRIBUTION both
                    # sides): probe and build tasks partition their output
                    # pages by key hash; hash-stage task p joins partition
                    # p of each side locally — equal keys co-locate, so the
                    # union of per-partition joins is the exact join and NO
                    # process ever materializes a whole side (reference:
                    # PagePartitioner.java:134-149 + partitioned join
                    # distribution).
                    lfid = next(_frag_ids)
                    fragments.append(PlanFragment(
                        lfid, "source", left,
                        output_partition_channels=list(node.left_keys)))
                    rfid = next(_frag_ids)
                    fragments.append(PlanFragment(
                        rfid, "source", right,
                        output_partition_channels=list(node.right_keys)))
                    node.left = RemoteSourceNode(
                        fragment_id=lfid, types=left.output_types,
                        names=left.output_names, exchange_type="partitioned")
                    node.right = RemoteSourceNode(
                        fragment_id=rfid, types=right.output_types,
                        names=right.output_names, exchange_type="partitioned")
                    node.distribution = "partitioned"
                    jfid = next(_frag_ids)
                    fragments.append(PlanFragment(jfid, "hash", node))
                    return RemoteSourceNode(
                        fragment_id=jfid, types=node.output_types,
                        names=node.output_names, exchange_type="gather",
                    ), True
            node.left = left
            if not rrep:
                # build side broadcast: its own source fragment
                fid = next(_frag_ids)
                fragments.append(PlanFragment(fid, "source", right))
                node.right = RemoteSourceNode(
                    fragment_id=fid,
                    types=right.output_types,
                    names=right.output_names,
                    exchange_type="broadcast",
                )
                node.distribution = node.distribution or "broadcast"
            else:
                node.right = right
            return node, lrep
        if isinstance(node, (P.SortNode, P.TopNNode, P.WindowNode,
                             P.MatchRecognizeNode)):
            src, rep = cut(node.source, fragments)
            if not rep:
                fid = next(_frag_ids)
                fragments.append(PlanFragment(fid, "source", src))
                src = RemoteSourceNode(
                    fragment_id=fid,
                    types=src.output_types,
                    names=src.output_names,
                    exchange_type="gather",
                )
            node.source = src
            return node, True
        if isinstance(node, (P.UnionNode, P.SetOpNode)):
            # each non-replicated operand becomes a gathered source fragment
            kids = list(node.sources)
            new_kids = []
            for kid in kids:
                src, rep = cut(kid, fragments)
                if not rep:
                    fid = next(_frag_ids)
                    fragments.append(PlanFragment(fid, "source", src))
                    src = RemoteSourceNode(
                        fragment_id=fid,
                        types=src.output_types,
                        names=src.output_names,
                        exchange_type="gather",
                    )
                new_kids.append(src)
            if isinstance(node, P.UnionNode):
                node.sources_ = new_kids
            else:
                node.left, node.right = new_kids
            return node, True
        if isinstance(node, P.ValuesNode):
            return node, True
        raise NotImplementedError(f"fragmenter: {type(node).__name__}")

    import copy

    body, rep = cut(copy.deepcopy(root.source), fragments)
    out = P.OutputNode(body, root.column_names)
    if not rep:
        fid = next(_frag_ids)
        fragments.append(PlanFragment(fid, "source", body))
        out = P.OutputNode(
            RemoteSourceNode(
                fragment_id=fid,
                types=body.output_types,
                names=body.output_names,
                exchange_type="gather",
            ),
            root.column_names,
        )
    fragments.append(PlanFragment(next(_frag_ids), "single", out))
    from trino_tpu_torch.sql.planner.sanity import (
        validate_fragments, validation_enabled)

    if validation_enabled(session):
        validate_fragments(fragments, phase="fragmentation")
    return fragments


def fresh_fragment_ids(fragments: List[PlanFragment]):
    """Id allocator for fragments added AFTER fragmentation (the adaptive
    re-planner): continues past the query's own max id. The module-global
    ``_frag_ids`` cannot be reused — a concurrent query's fragment_plan
    resets it, and a recycled id would collide inside this query."""
    return itertools.count(max((f.id for f in fragments), default=-1) + 1)


def adapt_broadcast_to_partitioned(frag: PlanFragment, join: P.JoinNode,
                                   build_root: P.PlanNode,
                                   id_alloc) -> List[PlanFragment]:
    """Re-fragment a broadcast join into the co-partitioned shape at the
    stage boundary (the adaptive half of DetermineJoinDistributionType):
    the probe subtree moves into its own key-partitioned source fragment,
    the build re-runs as a key-partitioned source fragment (its broadcast
    output was never pulled), and ``frag`` becomes the hash join stage.
    Operators above the join stay in ``frag`` — they were already computed
    per task and merged downstream, and a hash partition is just a
    different task-partitioning of the same rows. Returns the new producer
    fragments to schedule before ``frag``."""
    probe = join.left
    pfid, bfid = next(id_alloc), next(id_alloc)
    probe_frag = PlanFragment(
        pfid, "source", probe,
        output_partition_channels=list(join.left_keys))
    build_frag = PlanFragment(
        bfid, "source", build_root,
        output_partition_channels=list(join.right_keys))
    join.left = RemoteSourceNode(
        fragment_id=pfid, types=probe.output_types,
        names=probe.output_names, exchange_type="partitioned")
    join.right = RemoteSourceNode(
        fragment_id=bfid, types=build_root.output_types,
        names=build_root.output_names, exchange_type="partitioned")
    join.distribution = "partitioned"
    frag.partitioning = "hash"
    return [probe_frag, build_frag]


def adapt_partitioned_to_broadcast(frag: PlanFragment, join: P.JoinNode,
                                   build_root: P.PlanNode,
                                   id_alloc) -> List[PlanFragment]:
    """Re-fragment a co-partitioned join's BUILD side into a broadcast at
    the stage boundary (actual build rows came in far under the threshold):
    the build re-runs as an unpartitioned source fragment whose full stream
    every join task pulls; the probe side keeps its partitioned producers,
    so each hash task joins its probe partition against the whole (tiny)
    build — build-side partition skew disappears. Returns the new build
    fragment to schedule before ``frag``."""
    bfid = next(id_alloc)
    build_frag = PlanFragment(bfid, "source", build_root)
    join.right = RemoteSourceNode(
        fragment_id=bfid, types=build_root.output_types,
        names=build_root.output_names, exchange_type="broadcast")
    join.distribution = "broadcast"
    return [build_frag]


def format_fragments(fragments: List[PlanFragment], stats=None,
                     stage_stats=None, verbose: bool = False,
                     adapted=None, kernels=None) -> str:
    """EXPLAIN (TYPE DISTRIBUTED) rendering (reference: PlanPrinter's
    fragmented text plan). With ``stats`` (plan-node id → OperatorStats,
    the coordinator's rollup of worker-reported task stats) this renders
    distributed EXPLAIN ANALYZE: per-node ``wall=``/``rows=`` annotations
    sourced from the workers that actually ran each fragment. With
    ``stage_stats`` (fragment id → stage rollup dict), each fragment header
    carries its stage totals; ``verbose`` adds a device-detail line per
    fragment (device seconds, output/peak bytes, spill count). ``adapted``
    (fragment id → change description, from the query's versioned plan
    changes) annotates fragments the runtime re-planner rewrote, e.g.
    ``[adapted: broadcast->partitioned]``."""
    lines = []
    for f in reversed(fragments):
        head = f"Fragment {f.id} [{f.partitioning}]"
        note = (adapted or {}).get(f.id)
        if note:
            head += f" [adapted: {note}]"
        si = (stage_stats or {}).get(f.id)
        if si is not None:
            head += (f" [tasks={si['tasks']},"
                     f" splits={si['completedSplits']}/{si['totalSplits']},"
                     f" wall={si['wallS'] * 1e3:.1f}ms,"
                     f" rows={si['outputRows']}]")
        lines.append(head)
        if verbose and si is not None:
            lines.append(
                f"  device: execute={si['deviceS'] * 1e3:.1f}ms,"
                f" output={si['outputBytes'] // 1024}KiB,"
                f" peak={si['peakBytes'] // 1024}KiB,"
                f" spills={si['spills']}")
        lines.append(_format(f.root, 1, stats, verbose, kernels))
        lines.append("")
    return "\n".join(lines).rstrip()


def _format(node: P.PlanNode, indent: int, stats=None,
            verbose: bool = False, kernels=None) -> str:
    if isinstance(node, RemoteSourceNode):
        pad = "  " * indent
        line = (f"{pad}- RemoteSource[{node.exchange_type}]"
                f" <- Fragment {node.fragment_id}")
        st = (stats or {}).get(node.id)
        if st is not None:
            line += f"  [wall={st.wall_s * 1e3:.1f}ms rows={st.output_rows}]"
        return line
    base = P.format_plan(node, indent, stats=stats, verbose=verbose,
                         kernels=kernels).split("\n")
    out = [base[0]]
    # re-render children so RemoteSourceNodes print specially
    kids = list(node.sources)
    if kids:
        out = [base[0]]
        for k in kids:
            out.append(_format(k, indent + 1, stats, verbose, kernels))
        return "\n".join(out)
    return base[0]