"""The rule set for the iterative optimizer.

Reference: ``sql/planner/iterative/rule/`` (227 rules). This is the
load-bearing starter set, each a faithful analog of the named reference
rule, re-targeted at the channel-positional plan IR. Rules fire through
``iterative.IterativeOptimizer``; whole-tree passes in optimizer.py remain
for global rewrites (predicate pushdown, channel pruning) — the reference
keeps the same split (PredicatePushDown is not an iterative rule there
either).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.planner import plan as P
from trino_tpu_torch.sql.planner.iterative import Context, Rule
from trino_tpu_torch.sql.planner.planner import combine_conjuncts, ir_conjuncts


def _is_true(e: ir.Expr) -> bool:
    return isinstance(e, ir.Constant) and e.value is True


class MergeFilters(Rule):
    """Filter(Filter(x)) -> Filter(x, a AND b)
    (reference: rule/MergeFilters.java)."""

    pattern = P.FilterNode

    def apply(self, node: P.FilterNode, ctx: Context):
        child = ctx.resolve(node.source)
        if not isinstance(child, P.FilterNode):
            return None
        pred = combine_conjuncts(
            ir_conjuncts(node.predicate) + ir_conjuncts(child.predicate))
        return P.FilterNode(source=child.source, predicate=pred)


class RemoveTrivialFilter(Rule):
    """Filter(x, TRUE) -> x (reference: rule/RemoveTrivialFilters.java)."""

    pattern = P.FilterNode

    def apply(self, node: P.FilterNode, ctx: Context):
        if _is_true(node.predicate):
            return ctx.resolve(node.source)
        return None


class MergeLimits(Rule):
    """Limit(Limit(x, a), b) -> Limit(x, min(a, b))
    (reference: rule/MergeLimits.java)."""

    pattern = P.LimitNode

    def apply(self, node: P.LimitNode, ctx: Context):
        child = ctx.resolve(node.source)
        if not isinstance(child, P.LimitNode) or child.step != node.step:
            return None
        return P.LimitNode(source=child.source,
                           count=min(node.count, child.count), step=node.step)


class PushLimitThroughProject(Rule):
    """Limit(Project(x)) -> Project(Limit(x)) — the limit moves toward the
    data (reference: rule/PushLimitThroughProject.java)."""

    pattern = P.LimitNode

    def apply(self, node: P.LimitNode, ctx: Context):
        child = ctx.resolve(node.source)
        if not isinstance(child, P.ProjectNode):
            return None
        inner = P.LimitNode(source=child.source, count=node.count,
                            step=node.step)
        return P.ProjectNode(source=inner,
                             expressions=list(child.expressions),
                             names=list(child.names))


class LimitOverSortToTopN(Rule):
    """Limit(Sort(x)) -> TopN(x) — one bounded device kernel instead of a
    full sort then a cut (reference: rule/CreateTopN ...
    LimitOverProjectWithSort family)."""

    pattern = P.LimitNode

    def apply(self, node: P.LimitNode, ctx: Context):
        child = ctx.resolve(node.source)
        if not isinstance(child, P.SortNode):
            return None
        return P.TopNNode(source=child.source, count=node.count,
                          sort_channels=list(child.sort_channels))


class RemoveIdentityProject(Rule):
    """Project that passes every input channel through unchanged -> source
    (reference: rule/RemoveRedundantIdentityProjections.java)."""

    pattern = P.ProjectNode

    def apply(self, node: P.ProjectNode, ctx: Context):
        child = ctx.resolve(node.source)
        width = len(child.output_types)
        if len(node.expressions) != width:
            return None
        for i, e in enumerate(node.expressions):
            if not (isinstance(e, ir.ColumnRef) and e.index == i):
                return None
        return ctx.resolve(node.source)


def _substitute(e: ir.Expr, inner: List[ir.Expr]):
    """Replace every ColumnRef with the inner project's expression. Covers
    the WHOLE expression grammar; an unknown composite kind returns None
    (caller declines the rewrite) rather than risking stale channel refs.
    Lambda bodies index lambda PARAMETERS, not input channels — a project
    expression containing one declines (conservative)."""
    if isinstance(e, ir.ColumnRef):
        return inner[e.index]
    if isinstance(e, (ir.Constant, ir.OuterRef)):
        return e
    if isinstance(e, ir.Lambda):
        return None
    if isinstance(e, ir.Call):
        args = [_substitute(a, inner) for a in e.args]
        if any(a is None for a in args):
            return None
        return dataclasses.replace(e, args=tuple(args))
    if isinstance(e, ir.Cast):
        v = _substitute(e.value, inner)
        return None if v is None else dataclasses.replace(e, value=v)
    if isinstance(e, ir.Case):
        whens = []
        for c, v in e.whens:
            c2, v2 = _substitute(c, inner), _substitute(v, inner)
            if c2 is None or v2 is None:
                return None
            whens.append((c2, v2))
        d = None
        if e.default is not None:
            d = _substitute(e.default, inner)
            if d is None:
                return None
        return dataclasses.replace(e, whens=tuple(whens), default=d)
    return None  # unknown composite: decline


def _ref_counts(e: ir.Expr, counts: dict) -> None:
    if isinstance(e, ir.ColumnRef):
        counts[e.index] = counts.get(e.index, 0) + 1
        return
    for c in (e.children() if hasattr(e, "children") else ()):
        _ref_counts(c, counts)


class MergeProjects(Rule):
    """Project(Project(x)) -> Project(x) with inner expressions inlined
    (reference: rule/InlineProjections.java). Guard: an inner expression
    referenced more than once must be trivial (column/constant), else
    inlining would duplicate computation."""

    pattern = P.ProjectNode

    def apply(self, node: P.ProjectNode, ctx: Context):
        child = ctx.resolve(node.source)
        if not isinstance(child, P.ProjectNode):
            return None
        counts: dict = {}
        for e in node.expressions:
            _ref_counts(e, counts)
        for idx, n in counts.items():
            inner_e = child.expressions[idx]
            if n > 1 and not isinstance(inner_e, (ir.ColumnRef, ir.Constant)):
                return None
        exprs = [_substitute(e, child.expressions) for e in node.expressions]
        if any(e is None for e in exprs):
            return None  # grammar kind the substituter cannot renumber
        return P.ProjectNode(source=child.source, expressions=exprs,
                             names=list(node.names))


class PushLimitThroughUnion(Rule):
    """Limit(Union(a, b)) -> Limit(Union(Limit(a), Limit(b))) — each branch
    need produce at most ``count`` rows (reference:
    rule/PushLimitThroughUnion.java). Fires once per shape (branches that
    are already limits to the same count are left alone)."""

    pattern = P.LimitNode

    def apply(self, node: P.LimitNode, ctx: Context):
        child = ctx.resolve(node.source)
        if not isinstance(child, P.UnionNode) or node.step != "single":
            return None
        branches = [ctx.resolve(s) for s in child.sources_]
        if all(isinstance(b, P.LimitNode) and b.count <= node.count
               for b in branches):
            return None
        limited = [
            s if (isinstance(b, P.LimitNode) and b.count <= node.count)
            else P.LimitNode(source=s, count=node.count, step="single")
            for s, b in zip(child.sources_, branches)
        ]
        new_union = P.UnionNode(sources_=limited, names=list(child.names))
        return P.LimitNode(source=new_union, count=node.count, step="single")


class PruneUnpayingCompact(Rule):
    """Remove a CompactNode whose cost gate says the payload sort cannot
    pay for itself: estimated live rows are NOT far below the input's slot
    count (the inverse of optimizer.insert_compactions' insertion gate —
    a stats-driven COST decision, reference: the iterative rules'
    isExpensive()/cost-comparison gates)."""

    pattern = P.CompactNode

    def apply(self, node: P.CompactNode, ctx: Context):
        if ctx.session is None:
            return None
        from trino_tpu_torch.sql.planner import optimizer as O
        from trino_tpu_torch.sql.planner import stats

        source = ctx.resolve(node.source)
        try:
            slots = O._slot_count(ctx.session, self._resolved(source, ctx))
            live = stats.estimate_live_rows(
                ctx.session, self._resolved(source, ctx))
        except Exception:  # noqa: BLE001 — stats unavailable: keep the node
            return None
        if slots >= O.COMPACT_MIN_SLOTS and slots >= O.COMPACT_MIN_RATIO * live * 1.3:
            return None  # still worth it
        return source

    @staticmethod
    def _resolved(node: P.PlanNode, ctx: Context) -> P.PlanNode:
        """Stats walk a plain tree: materialize this subtree out of the
        memo (cheap — subtrees under a compact candidate are small)."""
        from trino_tpu_torch.sql.planner.iterative import GroupReference

        if isinstance(node, GroupReference):
            return ctx.memo.extract(node.group)
        children = [PruneUnpayingCompact._resolved(c, ctx) for c in node.sources]
        if not children:
            return node
        from trino_tpu_torch.sql.planner.iterative import replace_children

        return replace_children(node, children)


def _catalog(ctx: Context, scan: P.TableScanNode):
    if ctx.session is None:
        return None
    return ctx.session.catalogs.get(scan.catalog)


def _scan_with_handle(scan: P.TableScanNode, handle) -> P.TableScanNode:
    new = dataclasses.replace(scan)
    new.id = scan.id
    new.table_handle = handle
    return new


class PushLimitIntoTableScan(Rule):
    """Limit(TableScan) -> Limit(TableScan[handle+limit]) — the connector
    caps rows remotely; the engine's Limit stays (split-level guarantee
    only), as the reference does unless the handle is guaranteed
    (reference: rule/PushLimitIntoTableScan.java +
    ConnectorMetadata.applyLimit)."""

    pattern = P.LimitNode

    def apply(self, node: P.LimitNode, ctx: Context):
        child = ctx.resolve(node.source)
        if not isinstance(child, P.TableScanNode) or node.step != "single":
            return None
        conn = _catalog(ctx, child)
        if conn is None:
            return None
        h = conn.apply_limit(child.schema, child.table, child.table_handle,
                             node.count)
        if h is None:
            return None
        return P.LimitNode(source=_scan_with_handle(child, h),
                           count=node.count, step=node.step)


class PushTopNIntoTableScan(Rule):
    """TopN(TableScan) -> TopN(TableScan[handle+topN]) (reference:
    rule/PushTopNIntoTableScan.java + ConnectorMetadata.applyTopN). The
    engine's TopN stays: the remote order guarantees the top set per
    split, the engine re-establishes total order."""

    pattern = P.TopNNode

    def apply(self, node: P.TopNNode, ctx: Context):
        child = ctx.resolve(node.source)
        if not isinstance(child, P.TableScanNode) or node.step != "single":
            return None
        conn = _catalog(ctx, child)
        if conn is None:
            return None
        from trino_tpu_torch.connector.spi import SortItem

        order = []
        for ch, asc, nulls_first in node.sort_channels:
            nf = nulls_first if nulls_first is not None else (not asc)
            order.append(SortItem(child.column_names[ch], asc, nf))
        h = conn.apply_topn(child.schema, child.table, child.table_handle,
                            node.count, order)
        if h is None:
            return None
        return P.TopNNode(source=_scan_with_handle(child, h),
                          count=node.count,
                          sort_channels=list(node.sort_channels),
                          step=node.step)


class PushAggregationIntoTableScan(Rule):
    """Aggregation(TableScan) -> TableScan[handle+aggregate] — the WHOLE
    aggregation moves to the connector when it can evaluate it with the
    engine's exact semantics; the scan's output schema becomes the
    aggregation's (reference: rule/PushAggregationIntoTableScan.java +
    ConnectorMetadata.applyAggregation)."""

    pattern = P.AggregationNode

    def apply(self, node: P.AggregationNode, ctx: Context):
        if node.step != "single":
            return None
        child = ctx.resolve(node.source)
        # see through the planner's argument-mapping Project when it is
        # pure column references (channel -> scan column renumbering)
        chan_map = None
        if isinstance(child, P.ProjectNode):
            if not all(isinstance(e, ir.ColumnRef) for e in child.expressions):
                return None
            chan_map = [e.index for e in child.expressions]
            child = ctx.resolve(child.source)
        if not isinstance(child, P.TableScanNode):
            return None
        conn = _catalog(ctx, child)
        if conn is None or getattr(child, "table_handle", None) is not None:
            return None
        from trino_tpu_torch.connector.spi import AggregateSpec

        def col(ch: int) -> str:
            return child.column_names[chan_map[ch] if chan_map else ch]

        group_cols = [col(c) for c in node.group_channels]
        specs = []
        for call in node.aggregates:
            if call.distinct or call.arg2_channel is not None:
                return None
            fn = call.function
            if fn == "count_star" or (fn == "count" and call.arg_channel is None):
                specs.append(AggregateSpec("count", None, call.output_type))
                continue
            if fn not in ("count", "sum", "min", "max"):
                return None
            specs.append(AggregateSpec(
                fn, col(call.arg_channel), call.output_type))
        got = conn.apply_aggregation(
            child.schema, child.table, child.table_handle, group_cols, specs)
        if got is None:
            return None
        handle, out_cols = got
        return P.TableScanNode(
            catalog=child.catalog, schema=child.schema, table=child.table,
            column_names=[c.name for c in out_cols],
            column_types=[c.type for c in out_cols],
            table_handle=handle)


DEFAULT_RULES = [
    MergeFilters(),
    RemoveTrivialFilter(),
    MergeLimits(),
    PushLimitThroughUnion(),
    PushLimitThroughProject(),
    LimitOverSortToTopN(),
    RemoveIdentityProject(),
    MergeProjects(),
    PushAggregationIntoTableScan(),
    PushTopNIntoTableScan(),
    PushLimitIntoTableScan(),
]
