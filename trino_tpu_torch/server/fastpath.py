"""Short-query fast path: run single-stage plans coordinator-local.

Reference role: the dispatch/execution split of
``dispatcher/QueuedStatementResource`` exists because the per-query
control-plane work — fragment, create tasks over HTTP, poll status, pull
pages through the exchange — dominates short queries. A point lookup that
executes in ~1 ms pays tens of milliseconds of task round-trips on the
distributed path. When the optimized plan would fragment into at most ONE
distributed stage (point lookups, small scans, single-step aggregations)
and its scans are small, the coordinator can run the WHOLE plan on its own
engine: same admission (``cluster_memory`` gates dispatch before ``_run``
starts), same caches (plan/result lookups happen before execution), same
stats rollups and spans — minus every task HTTP round-trip.

The eligibility predictor mirrors ``fragmenter.cut``'s decisions without
building fragments (no deepcopy, no fragment ids): it walks the optimized
plan and counts the stage cuts fragmentation WOULD make. Drift between
the two is caught by a test that compares the predictor against
``fragment_plan`` across the TPC-H suite (tests/test_fast_path.py).

Gated by the ``short_query_fast_path`` session property (opt-in, like the
other serving knobs) plus a scan-size guard (``fast_path_max_scan_rows``):
big scans keep the cluster's parallelism.
"""
from __future__ import annotations

from typing import Tuple

from trino_tpu_torch.sql.planner import plan as P


def predicted_stage_count(session, root: P.PlanNode) -> int:
    """Number of non-single fragments ``fragment_plan`` would produce for
    this optimized plan (the root single fragment is not counted)."""
    n, rep = _cuts(session, root.source if isinstance(root, P.OutputNode)
                   else root)
    return n + (0 if rep else 1)


def _cuts(session, node: P.PlanNode) -> Tuple[int, bool]:
    """Mirror of ``fragmenter.cut``: returns (fragments the subtree would
    create, is_replicated). Unknown node kinds count as many stages so the
    fast path never claims a plan the fragmenter itself would reject."""
    from trino_tpu_torch.sql.planner.fragmenter import (
        _colocated_join, _hash_distributed_final)

    if isinstance(node, P.TableScanNode):
        return 0, False
    if isinstance(node, (P.FilterNode, P.ProjectNode, P.LimitNode,
                         P.CompactNode)):
        return _cuts(session, node.source)
    if isinstance(node, P.AggregationNode):
        n, rep = _cuts(session, node.source)
        if rep:
            return n, True
        if not P.can_split_aggs(node.aggregates):
            return n + 1, True
        if _hash_distributed_final(session, node):
            return n + 2, True
        return n + 1, True
    if isinstance(node, P.JoinNode):
        ln, lrep = _cuts(session, node.left)
        rn, rrep = _cuts(session, node.right)
        n = ln + rn
        if (session is not None and not lrep and not rrep
                and _colocated_join(session, node, node.left, node.right)):
            return n, False
        if (session is not None and not lrep and not rrep
                and node.left_keys and node.join_type in ("inner", "semi",
                                                          "anti", "left")):
            from trino_tpu_torch.sql.planner import stats

            if stats.join_repartitions(session, node, 1):
                return n + 3, True
        if not rrep:
            n += 1  # broadcast build fragment
        return n, lrep
    if isinstance(node, (P.SortNode, P.TopNNode, P.WindowNode,
                         P.MatchRecognizeNode)):
        n, rep = _cuts(session, node.source)
        return (n if rep else n + 1), True
    if isinstance(node, (P.UnionNode, P.SetOpNode)):
        n = 0
        for kid in node.sources:
            kn, krep = _cuts(session, kid)
            n += kn + (0 if krep else 1)
        return n, True
    if isinstance(node, P.ValuesNode):
        return 0, True
    # fragmenter would raise NotImplementedError: never fast-path it
    return 1 << 10, True


def scan_rows_estimate(session, root: P.PlanNode) -> int:
    """Total estimated rows across the plan's table scans — the work the
    coordinator would absorb without worker parallelism."""
    from trino_tpu_torch.sql.planner import stats

    total = 0
    for node in P.walk_plan(root):
        if isinstance(node, P.TableScanNode):
            total += int(stats.estimate_rows(session, node))
    return total


def fast_path_decision(session, root: P.PlanNode) -> Tuple[bool, str]:
    """(take_fast_path, reason). The reason string rides the
    ``fastpath/execute`` span and EXPLAIN ANALYZE so the decision is
    always inspectable."""
    props = getattr(session, "properties", None) or {}
    if not bool(props.get("short_query_fast_path", False)):
        return False, "short_query_fast_path disabled"
    try:
        stages = predicted_stage_count(session, root)
    except Exception as e:  # noqa: BLE001 — prediction is best-effort
        return False, f"stage prediction failed: {e}"
    if stages > 1:
        return False, f"plan needs {stages} distributed stages"
    max_rows = int(props.get("fast_path_max_scan_rows", 4_000_000))
    rows = scan_rows_estimate(session, root)
    if rows > max_rows:
        return False, (f"~{rows} estimated scan rows exceed "
                       f"fast_path_max_scan_rows={max_rows}")
    return True, f"single-stage plan, ~{rows} estimated scan rows"
