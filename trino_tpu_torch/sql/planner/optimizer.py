"""Logical plan optimizer.

Reference: ``core/trino-main/.../sql/planner/PlanOptimizers.java`` sequences
227 iterative rules + big-bang passes. Round-1 passes (the load-bearing
subset):

- ``push_predicates``: PredicatePushDown analog — moves filter conjuncts to
  their lowest legal position, turning cross joins (from implicit-join SQL)
  into equi-keyed hash joins along the way (EqualityInference role).
- ``prune_channels``: PruneUnreferencedOutputs/projection-pushdown analog —
  trims every node to the channels actually consumed; at scans this becomes
  connector projection pushdown (the TPC-H generator then only generates the
  projected columns).
- ``order_joins``: greedy size-based join ordering (ReorderJoins stand-in)
  + distribution choice (AddExchanges' broadcast-vs-partitioned decision)
  happens in the fragmenter for now.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.planner import plan as P
from trino_tpu_torch.sql.planner.planner import combine_conjuncts, ir_conjuncts


def optimize(root: P.OutputNode, session=None) -> P.OutputNode:
    # plan-IR sanity checking between passes (reference: PlanSanityChecker
    # interposed on every PlanOptimizer): a pass that breaks a channel
    # invariant is named by the failing phase instead of corrupting rows
    from trino_tpu_torch.sql.planner.sanity import checker

    check = checker(session)
    check(root, "initial-plan")
    node = push_predicates(root.source, [])
    check(node, "optimizer:push_predicates")
    node = orient_joins(node, session)
    check(node, "optimizer:orient_joins")
    node, _ = prune_channels(node, set(range(len(node.output_types))))
    check(node, "optimizer:prune_channels")
    node = merge_identity_projects(node)
    check(node, "optimizer:merge_identity_projects")
    # local rewrites run as memo-resident rules to fixpoint (reference:
    # IterativeOptimizer + rule/ — the scaling path for new rewrites;
    # the passes above stay whole-tree, as PredicatePushDown does there)
    from trino_tpu_torch.sql.planner.iterative import IterativeOptimizer
    from trino_tpu_torch.sql.planner.rules import DEFAULT_RULES

    node = IterativeOptimizer(DEFAULT_RULES).optimize(node, session)
    check(node, "optimizer:iterative_rules")
    derive_scan_constraints(node)
    plan_dynamic_filters(node)
    check(node, "optimizer:dynamic_filters")
    if session is not None:
        node = insert_compactions(node, session)
        check(node, "optimizer:insert_compactions")
    out = P.OutputNode(node, root.column_names)
    check(out, "optimizer:output")
    return out


# ------------------------------------------------------- compaction pass

# only consider squeezing inputs this large (the payload sort that performs
# the compaction has to pay for itself downstream)
COMPACT_MIN_SLOTS = 1 << 17
COMPACT_MIN_RATIO = 2.0  # slots / estimated live rows


def _slot_count(session, node: P.PlanNode) -> int:
    """Physical row-slot count a node's output page carries (the static
    shape downstream operators process, live or dead)."""
    from trino_tpu_torch.sql.planner import stats

    if isinstance(node, P.TableScanNode):
        conn = session.catalogs.get(node.catalog)
        n = conn.table_row_count(node.schema, node.table) if conn else None
        return int(n) if n else 1024
    if isinstance(node, P.CompactNode):
        from trino_tpu_torch.sql.planner.stats import compact_capacity

        return compact_capacity(session, node)
    if isinstance(node, P.JoinNode):
        if P.uses_expansion_kernel(node):
            return stats._expansion_capacity(session, node)
        left = _slot_count(session, node.left)
        if node.join_type == "left" and node.filter is not None:
            return 2 * left  # head + null-tail concat (expand_join)
        return left
    if isinstance(node, P.AggregationNode):
        return _slot_count(session, node.source)  # sorted-path capacity == n
    if isinstance(node, P.UnionNode):
        return sum(_slot_count(session, s) for s in node.sources_)
    if isinstance(node, P.SetOpNode):
        return _slot_count(session, node.left) + _slot_count(session, node.right)
    if isinstance(node, P.ValuesNode):
        return max(1, len(node.rows or ()))
    srcs = node.sources
    if not srcs:
        return 1024
    return max(_slot_count(session, s) for s in srcs)


def insert_compactions(node: P.PlanNode, session) -> P.PlanNode:
    """Insert CompactNodes where cardinality estimates say the live rows
    are a small fraction of the page's slots AND a downstream operator
    (join / aggregation / window / set-op) would pay per-slot costs for the
    dead ones. Sorts/TopN don't qualify: the compaction itself is one
    payload sort, so compact-then-sort saves nothing over sorting.
    Capacities are estimates; underestimates raise CAPACITY_EXCEEDED and
    the bucketed recompile loop doubles them (CompiledQuery.run)."""
    from trino_tpu_torch.sql.planner import stats

    def maybe_compact(child: P.PlanNode) -> P.PlanNode:
        if isinstance(child, (P.CompactNode, P.ValuesNode, P.TableScanNode)):
            return child
        slots = _slot_count(session, child)
        if slots < COMPACT_MIN_SLOTS:
            return child
        live = stats.estimate_live_rows(session, child)
        if slots < COMPACT_MIN_RATIO * live * 1.3:
            return child
        return P.CompactNode(child, estimated_rows=live)

    def walk(n: P.PlanNode) -> P.PlanNode:
        srcs = [walk(s) for s in n.sources]
        n = _replace_sources(n, srcs)
        if isinstance(n, P.JoinNode):
            n.left = maybe_compact(n.left)
            n.right = maybe_compact(n.right)
        elif isinstance(n, (P.AggregationNode, P.WindowNode)):
            n.source = maybe_compact(n.source)
        elif isinstance(n, P.SetOpNode):
            n.left = maybe_compact(n.left)
            n.right = maybe_compact(n.right)
        return n

    return walk(node)


# ------------------------------------------- scan constraint pushdown


def derive_scan_constraints(node: P.PlanNode) -> None:
    """Attach a TupleDomain to every scan under a filter (reference:
    PushPredicateIntoTableScan + ConnectorMetadata.applyFilter). The
    constraint is advisory: the enforcing FilterNode is KEPT, so connectors
    may ignore or over-approximate it."""
    from trino_tpu_torch.connector.predicate import TupleDomain

    for child in node.sources:
        derive_scan_constraints(child)
    if isinstance(node, P.FilterNode) and isinstance(node.source, P.TableScanNode):
        scan = node.source
        td = TupleDomain.all()
        for conj in ir_conjuncts(node.predicate):
            d = _conjunct_domain(conj, scan)
            if d is not None:
                td = td.intersect(d)
        if not td.is_all():
            scan.constraint = td if scan.constraint is None else scan.constraint.intersect(td)


def _conjunct_domain(e: ir.Expr, scan: P.TableScanNode):
    """Single-column comparison conjunct -> TupleDomain, else None."""
    from trino_tpu_torch.connector.predicate import Domain, TupleDomain

    if not isinstance(e, ir.Call):
        return None

    def col_const(args):
        a, b = args
        if isinstance(a, ir.ColumnRef) and isinstance(b, ir.Constant) and b.value is not None:
            return a, b.value, False
        if isinstance(b, ir.ColumnRef) and isinstance(a, ir.Constant) and a.value is not None:
            return b, a.value, True
        return None, None, False

    name = e.name
    if name in ("eq", "lt", "le", "gt", "ge") and len(e.args) == 2:
        col, v, flipped = col_const(e.args)
        if col is None:
            return None
        if flipped:  # const OP col  ==  col FLIP(OP) const
            name = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}[name]
        dom = {
            "eq": lambda: Domain.from_values([v]),
            "lt": lambda: Domain.range(high=v, high_inclusive=False),
            "le": lambda: Domain.range(high=v),
            "gt": lambda: Domain.range(low=v, low_inclusive=False),
            "ge": lambda: Domain.range(low=v),
        }[name]()
        return TupleDomain({scan.column_names[col.index]: dom})
    if name == "between" and len(e.args) == 3:
        col, lo, hi = e.args
        if (isinstance(col, ir.ColumnRef) and isinstance(lo, ir.Constant)
                and isinstance(hi, ir.Constant)
                and lo.value is not None and hi.value is not None):
            return TupleDomain(
                {scan.column_names[col.index]: Domain.range(low=lo.value, high=hi.value)})
        return None
    if name == "in_list":
        col = e.args[0]
        rest = e.args[1:]
        if isinstance(col, ir.ColumnRef) and all(
                isinstance(a, ir.Constant) and a.value is not None for a in rest):
            return TupleDomain(
                {scan.column_names[col.index]: Domain.from_values([a.value for a in rest])})
    return None


# ------------------------------------------------- dynamic filter planning


def plan_dynamic_filters(node: P.PlanNode) -> None:
    """Annotate probe-side scans of inner/semi joins with the joins whose
    build-side key domains can narrow them at runtime (reference:
    DynamicFilterService.java:105 + LocalDynamicFilterConsumer): the
    executor runs build sides first, extracts key min/max (or small
    in-sets), and hands the domain to the scan's connector."""
    for child in node.sources:
        plan_dynamic_filters(child)
    if not isinstance(node, P.JoinNode):
        return
    if node.join_type not in ("inner", "semi") or node.singleton:
        return
    for i, probe_ch in enumerate(node.left_keys or []):
        target = _trace_to_scan(node.left, probe_ch)
        if target is None:
            continue
        scan, column = target
        if scan.dynamic_filters is None:
            scan.dynamic_filters = []
        scan.dynamic_filters.append((node.id, i, column))
        if node.dyn_filter_keys is None:
            node.dyn_filter_keys = []
        node.dyn_filter_keys.append(i)


def reoptimize_distribution(session, join: P.JoinNode, n_workers: int) -> str:
    """Adaptive re-optimization entry point (reference: AdaptivePlanner
    re-firing DetermineJoinDistributionType on runtime stats): the SAME
    static distribution predicate, evaluated after the adaptive re-planner
    stamped ``runtime_rows`` on the join's exchange sources — so the
    runtime decision and the plan-time decision can never use different
    rules, only different cardinalities. Returns 'partitioned' or
    'broadcast'."""
    from trino_tpu_torch.sql.planner import stats

    if not join.left_keys:
        return "broadcast"  # cross join: broadcast is the only option
    return ("partitioned"
            if stats.join_repartitions(session, join, n_workers)
            else "broadcast")


def _trace_to_scan(node: P.PlanNode, channel: int):
    """Follow ``channel`` down through row-preserving/identity mappings to
    the originating scan column, or None."""
    if isinstance(node, P.TableScanNode):
        return node, node.column_names[channel]
    if isinstance(node, P.FilterNode):
        # row-preserving in the required direction: pruned scan rows could
        # only be rows the join drops anyway. LIMIT is NOT traceable — which
        # rows a limit admits depends on what the scan materialized, so
        # pruning would change results.
        return _trace_to_scan(node.source, channel)
    if isinstance(node, P.ProjectNode):
        e = node.expressions[channel]
        if isinstance(e, ir.ColumnRef):
            return _trace_to_scan(node.source, e.index)
        return None
    if isinstance(node, P.JoinNode):
        if node.join_type in ("semi", "anti") or channel < len(node.left.output_types):
            return _trace_to_scan(node.left, channel)
        return _trace_to_scan(node.right, channel - len(node.left.output_types))
    return None


def merge_identity_projects(node: P.PlanNode) -> P.PlanNode:
    """Drop Projects that are pure identity over their source (reference:
    iterative rule RemoveRedundantIdentityProjections)."""
    new_sources = [merge_identity_projects(s) for s in node.sources]
    _replace_sources(node, new_sources)
    if isinstance(node, P.ProjectNode):
        src = node.source
        if len(node.expressions) == len(src.output_types) and all(
            isinstance(e, ir.ColumnRef) and e.index == i for i, e in enumerate(node.expressions)
        ):
            return src
    return node


# ----------------------------------------------------- join orientation


def unique_key_sets(node: P.PlanNode, session) -> List[frozenset]:
    """Channel sets whose values are unique in node's output.

    Reference analog: uniqueness/cardinality reasoning the CBO does via
    stats; here structural (primary keys, group-by outputs) and used to pick
    the lookup-join build side (executor requires a unique build)."""
    if isinstance(node, P.TableScanNode):
        conn = session.catalogs.get(node.catalog) if session else None
        pk = conn.primary_key(node.schema, node.table) if conn else None
        if pk and all(c in node.column_names for c in pk):
            return [frozenset(node.column_names.index(c) for c in pk)]
        return []
    if isinstance(node, (P.FilterNode, P.SortNode, P.TopNNode, P.LimitNode, P.ExchangeNode)):
        return unique_key_sets(node.source, session)
    if isinstance(node, P.ProjectNode):
        mapping = {}
        for out_ch, e in enumerate(node.expressions):
            if isinstance(e, ir.ColumnRef):
                mapping.setdefault(e.index, out_ch)
        out = []
        for s in unique_key_sets(node.source, session):
            if all(c in mapping for c in s):
                out.append(frozenset(mapping[c] for c in s))
        return out
    if isinstance(node, P.AggregationNode):
        k = len(node.group_channels)
        return [frozenset(range(k))] if k else []
    if isinstance(node, P.JoinNode):
        if node.join_type in ("semi", "anti"):
            return unique_key_sets(node.left, session)
        if node.right_unique and node.join_type in ("inner", "left"):
            # N:1 join preserves left-side uniqueness; left channels keep indices
            return unique_key_sets(node.left, session)
        return []
    return []


def orient_joins(node: P.PlanNode, session) -> P.PlanNode:
    """Bottom-up: make the unique-keyed side the build (right) side of each
    lookup join, flipping sides (and restoring channel order with a Project)
    when only the left side is unique."""
    if isinstance(node, P.JoinNode):
        node.left = orient_joins(node.left, session)
        node.right = orient_joins(node.right, session)
    else:
        new_sources = [orient_joins(s, session) for s in node.sources]
        _replace_sources(node, new_sources)
    if not isinstance(node, P.JoinNode) or node.join_type in ("semi", "anti"):
        return node
    if not node.left_keys:
        return node  # scalar-subquery singleton or true cross join
    if _covered(node.right_keys, unique_key_sets(node.right, session)):
        node.right_unique = True
        return node
    if node.join_type == "inner" and _covered(
        node.left_keys, unique_key_sets(node.left, session)
    ):
        nleft = len(node.left.output_types)
        nright = len(node.right.output_types)
        flipped = P.JoinNode(
            join_type="inner", left=node.right, right=node.left,
            left_keys=list(node.right_keys), right_keys=list(node.left_keys),
            filter=(
                ir.remap_channels(
                    node.filter,
                    {
                        **{c: nright + c for c in range(nleft)},
                        **{nleft + c: c for c in range(nright)},
                    },
                )
                if node.filter is not None
                else None
            ),
            distribution=node.distribution,
            right_unique=True,
        )
        # restore original channel order: left channels then right channels
        tys = node.left.output_types + node.right.output_types
        nms = node.left.output_names + node.right.output_names
        order = list(range(nright, nright + nleft)) + list(range(nright))
        return P.ProjectNode(
            flipped,
            [ir.ColumnRef(tys[i], order[i], nms[i]) for i in range(len(order))],
            nms,
        )
    return node  # M:N join: executor uses the two-pass expansion kernel


def _covered(keys: List[int], unique_sets: List[frozenset]) -> bool:
    ks = set(keys)
    return any(s <= ks for s in unique_sets)


# --------------------------------------------------------------- pushdown


def substitute(e: ir.Expr, mapping: Dict[int, ir.Expr]) -> ir.Expr:
    if isinstance(e, ir.ColumnRef):
        return mapping[e.index]
    if isinstance(e, ir.Call):
        return ir.Call(e.type, e.name, tuple(substitute(a, mapping) for a in e.args))
    if isinstance(e, ir.Case):
        return ir.Case(
            e.type,
            tuple((substitute(c, mapping), substitute(v, mapping)) for c, v in e.whens),
            substitute(e.default, mapping) if e.default is not None else None,
        )
    if isinstance(e, ir.Cast):
        return ir.Cast(e.type, substitute(e.value, mapping))
    return e


def or_disjuncts(e: ir.Expr) -> List[ir.Expr]:
    if isinstance(e, ir.Call) and e.name == "or":
        return or_disjuncts(e.args[0]) + or_disjuncts(e.args[1])
    return [e]


def combine_disjuncts(parts: List[ir.Expr]) -> ir.Expr:
    out = parts[0]
    for p in parts[1:]:
        out = ir.Call(T.BOOLEAN, "or", (out, p))
    return out


def extract_common_or_conjuncts(c: ir.Expr) -> List[ir.Expr]:
    """or(and(a,b), and(a,c)) -> [a, or(b, c)] — factoring common conjuncts
    out of a disjunction (reference: ExtractCommonPredicatesExpressionRewrite)
    so e.g. TPC-H Q19's repeated `p_partkey = l_partkey` becomes a join key."""
    branches = or_disjuncts(c)
    if len(branches) < 2:
        return [c]
    branch_conjs = [ir_conjuncts(b) for b in branches]
    common = [
        x for x in branch_conjs[0] if all(x in bc for bc in branch_conjs[1:])
    ]
    if not common:
        return [c]
    rest = [
        combine_conjuncts([x for x in bc if x not in common]) for bc in branch_conjs
    ]
    if any(r is None for r in rest):  # a branch reduced to TRUE
        return common
    return common + [combine_disjuncts(rest)]


def push_predicates(node: P.PlanNode, conjuncts: List[ir.Expr]) -> P.PlanNode:
    """Push ``conjuncts`` (over node's output channels) down through ``node``."""
    conjuncts = [x for c in conjuncts for x in extract_common_or_conjuncts(c)]
    if isinstance(node, P.FilterNode):
        return push_predicates(node.source, conjuncts + ir_conjuncts(node.predicate))
    if isinstance(node, P.ProjectNode):
        mapping = dict(enumerate(node.expressions))
        inlined = [substitute(c, mapping) for c in conjuncts]
        src = push_predicates(node.source, inlined)
        return P.ProjectNode(src, node.expressions, node.names)
    if isinstance(node, P.JoinNode):
        return _push_into_join(node, conjuncts)
    if isinstance(node, P.UnionNode):
        # predicates distribute over UNION ALL branches (channel-aligned)
        new_sources = [push_predicates(s, list(conjuncts)) for s in node.sources]
        return _replace_sources(node, new_sources)
    if isinstance(node, P.UnnestNode):
        # predicates touching only replicated (source) channels push below
        # the expansion — each survives iff its parent row survives; element
        # predicates stay above (reference: unnest pushdown in
        # PredicatePushDown is similarly source-channel-only)
        rep = node.replicate_channels
        down, up = [], []
        for c in conjuncts:
            if all(ch < len(rep) for ch in ir.referenced_channels(c)):
                down.append(ir.remap_channels(c, {i: r for i, r in enumerate(rep)}))
            else:
                up.append(c)
        node.source = push_predicates(node.source, down)
        return _wrap_filter(node, up)
    if isinstance(
        node,
        (P.LimitNode, P.TopNNode, P.SortNode, P.AggregationNode, P.ExchangeNode,
         P.WindowNode, P.SetOpNode),
    ):
        # not safe/supported to push through — recurse with nothing
        # (predicates over window outputs change which rows a window sees;
        # set-op membership is over whole rows)
        new_sources = [push_predicates(s, []) for s in node.sources]
        node = _replace_sources(node, new_sources)
        return _wrap_filter(node, conjuncts)
    # leaves (scan, values)
    return _wrap_filter(node, conjuncts)


def _wrap_filter(node: P.PlanNode, conjuncts: List[ir.Expr]) -> P.PlanNode:
    pred = combine_conjuncts(conjuncts)
    return P.FilterNode(node, pred) if pred is not None else node


def _replace_sources(node: P.PlanNode, sources: List[P.PlanNode]) -> P.PlanNode:
    if isinstance(node, P.JoinNode):
        node.left, node.right = sources
    elif isinstance(node, P.SetOpNode):
        node.left, node.right = sources
    elif isinstance(node, P.UnionNode):
        node.sources_ = list(sources)
    elif sources:
        node.source = sources[0]
    return node


def _push_into_join(node: P.JoinNode, conjuncts: List[ir.Expr]) -> P.PlanNode:
    nleft = len(node.left.output_types)
    nright = len(node.right.output_types)
    left_conj: List[ir.Expr] = []
    right_conj: List[ir.Expr] = []
    new_left_keys = list(node.left_keys)
    new_right_keys = list(node.right_keys)
    residual: List[ir.Expr] = []
    above: List[ir.Expr] = []
    semi = node.join_type in ("semi", "anti")
    outer = node.join_type == "left"

    pending = list(conjuncts)
    if node.filter is not None and node.join_type == "inner":
        pending += ir_conjuncts(node.filter)
        node.filter = None
    kept_filter: List[ir.Expr] = []
    if node.filter is not None and outer:
        # ON-clause conjuncts of a left join: right-only ones can be pushed
        # into the build side (they only restrict match candidates); all
        # others must stay in the join filter
        for c in ir_conjuncts(node.filter):
            chans = set(ir.referenced_channels(c))
            if chans and min(chans) >= nleft:
                right_conj.append(ir.remap_channels(c, {i: i - nleft for i in chans}))
            else:
                kept_filter.append(c)
        node.filter = combine_conjuncts(kept_filter)

    for c in pending:
        chans = set(ir.referenced_channels(c))
        if semi:
            # output channels == left channels: pushing into left is always legal
            left_conj.append(c)
            continue
        if chans and max(chans, default=-1) < nleft:
            left_conj.append(c)
            continue
        if chans and min(chans, default=nleft) >= nleft:
            rc = ir.remap_channels(c, {i: i - nleft for i in chans})
            if outer:
                above.append(c)  # can't push to right of a left join
            else:
                right_conj.append(rc)
            continue
        # mixed: equi-join key? (not into singleton joins — the scalar
        # subquery's 0/multi-row error semantics live in the cross kernel)
        if (
            node.join_type == "inner"
            and not node.singleton
            and isinstance(c, ir.Call)
            and c.name == "eq"
            and isinstance(c.args[0], ir.ColumnRef)
            and isinstance(c.args[1], ir.ColumnRef)
        ):
            a, b = c.args[0].index, c.args[1].index
            if a < nleft <= b:
                new_left_keys.append(a)
                new_right_keys.append(b - nleft)
                continue
            if b < nleft <= a:
                new_left_keys.append(b)
                new_right_keys.append(a - nleft)
                continue
        if node.join_type == "inner":
            residual.append(c)
        else:
            above.append(c)

    node.left = push_predicates(node.left, left_conj)
    node.right = push_predicates(node.right, right_conj)
    node.left_keys = new_left_keys
    node.right_keys = new_right_keys
    existing_filter = ir_conjuncts(node.filter)
    node.filter = combine_conjuncts(existing_filter + residual)
    return _wrap_filter(node, above)


def prune_output(node: P.PlanNode) -> P.PlanNode:
    return node


# ----------------------------------------------------------------- pruning


def prune_channels(node: P.PlanNode, needed: Set[int]) -> Tuple[P.PlanNode, Dict[int, int]]:
    """Rewrite the subtree to produce only ``needed`` output channels.

    Returns (new_node, mapping old_channel -> new_channel).

    Invariant: no node is ever pruned to zero channels — a Page's row count
    lives in its columns, so count(*)-style consumers that need no values
    still need one channel."""
    if not needed and node.output_types:
        needed = {0}
    if isinstance(node, P.TableScanNode):
        keep = sorted(needed)
        mapping = {old: i for i, old in enumerate(keep)}
        new = P.TableScanNode(
            catalog=node.catalog, schema=node.schema, table=node.table,
            column_names=[node.column_names[i] for i in keep],
            column_types=[node.column_types[i] for i in keep],
            table_handle=node.table_handle,
        )
        return new, mapping
    if isinstance(node, P.ValuesNode):
        keep = sorted(needed)
        mapping = {old: i for i, old in enumerate(keep)}
        new = P.ValuesNode(
            [node.types[i] for i in keep],
            [node.names[i] for i in keep],
            [tuple(r[i] for i in keep) for r in node.rows],
        )
        return new, mapping
    if isinstance(node, P.ProjectNode):
        keep = sorted(needed)
        kept_exprs = [node.expressions[i] for i in keep]
        src_needed = set()
        for e in kept_exprs:
            src_needed.update(ir.referenced_channels(e))
        src, src_map = prune_channels(node.source, src_needed)
        new_exprs = [ir.remap_channels(e, src_map) for e in kept_exprs]
        new = P.ProjectNode(src, new_exprs, [node.names[i] for i in keep])
        return new, {old: i for i, old in enumerate(keep)}
    if isinstance(node, P.UnnestNode):
        rep = node.replicate_channels
        keep_pos = [i for i in range(len(rep)) if i in needed]
        src_needed = {rep[i] for i in keep_pos}
        for e in node.unnest_exprs:
            src_needed.update(ir.referenced_channels(e))
        src, src_map = prune_channels(node.source, src_needed)
        new_exprs = [ir.remap_channels(e, src_map) for e in node.unnest_exprs]
        new = P.UnnestNode(
            source=src,
            unnest_exprs=new_exprs,
            ordinality=node.ordinality,
            replicate_channels=[src_map[rep[i]] for i in keep_pos],
        )
        mapping = {pos: i for i, pos in enumerate(keep_pos)}
        for j in range(len(node.output_types) - len(rep)):
            mapping[len(rep) + j] = len(keep_pos) + j
        return new, mapping
    if isinstance(node, P.FilterNode):
        src_needed = set(needed) | set(ir.referenced_channels(node.predicate))
        src, src_map = prune_channels(node.source, src_needed)
        pred = ir.remap_channels(node.predicate, src_map)
        filt = P.FilterNode(src, pred)
        if src_needed == needed:
            return filt, src_map
        keep = sorted(needed)
        proj = P.ProjectNode(
            filt,
            [
                ir.ColumnRef(node.source.output_types[i], src_map[i],
                             node.source.output_names[i])
                for i in keep
            ],
            [node.source.output_names[i] for i in keep],
        )
        return proj, {old: i for i, old in enumerate(keep)}
    if isinstance(node, P.AggregationNode):
        k = len(node.group_channels)
        kept_aggs = [
            (i, a) for i, a in enumerate(node.aggregates) if (k + i) in needed or not needed
        ]
        src_needed = set(node.group_channels)
        for _, a in kept_aggs:
            if a.arg_channel is not None:
                src_needed.add(a.arg_channel)
            if a.arg2_channel is not None:
                src_needed.add(a.arg2_channel)
        src, src_map = prune_channels(node.source, src_needed)
        new_aggs = [
            P.AggregateCall(
                a.function,
                src_map[a.arg_channel] if a.arg_channel is not None else None,
                a.output_type,
                a.distinct,
                a.param,
                arg2_channel=(
                    src_map[a.arg2_channel] if a.arg2_channel is not None else None
                ),
            )
            for _, a in kept_aggs
        ]
        new_groups = [src_map[c] for c in node.group_channels]
        names = [node.names[c] for c in range(k)] + [
            node.names[k + i] for i, _ in kept_aggs
        ]
        new_node = P.AggregationNode(src, new_groups, new_aggs, node.step, names)
        mapping = {c: c for c in range(k)}
        for newi, (oldi, _) in enumerate(kept_aggs):
            mapping[k + oldi] = k + newi
        return new_node, mapping
    if isinstance(node, P.JoinNode):
        nleft = len(node.left.output_types)
        semi = node.join_type in ("semi", "anti")
        filter_chans = set(ir.referenced_channels(node.filter)) if node.filter is not None else set()
        left_needed = {c for c in needed if c < nleft} | set(node.left_keys) | {
            c for c in filter_chans if c < nleft
        }
        right_needed = (
            set(node.right_keys) | {c - nleft for c in filter_chans if c >= nleft}
        )
        if not semi:
            right_needed |= {c - nleft for c in needed if c >= nleft}
        new_left, lmap = prune_channels(node.left, left_needed)
        new_right, rmap = prune_channels(node.right, right_needed)
        node_filter = node.filter
        if node_filter is not None:
            fmap = {c: lmap[c] for c in filter_chans if c < nleft}
            nl = len(new_left.output_types)
            fmap.update({c: nl + rmap[c - nleft] for c in filter_chans if c >= nleft})
            node_filter = ir.remap_channels(node_filter, fmap)
        new_node = P.JoinNode(
            join_type=node.join_type, left=new_left, right=new_right,
            left_keys=[lmap[c] for c in node.left_keys],
            right_keys=[rmap[c] for c in node.right_keys],
            filter=node_filter, distribution=node.distribution,
            right_unique=node.right_unique, singleton=node.singleton,
        )
        if semi:
            return new_node, lmap
        nl = len(new_left.output_types)
        mapping = dict(lmap)
        mapping.update({nleft + c: nl + rc for c, rc in rmap.items()})
        # the join output may contain channels not in `needed` (keys kept for
        # the join itself); project them away if any extra survive
        produced = set(mapping[c] for c in needed)
        total = nl + len(new_right.output_types)
        if len(produced) != total:
            keep = sorted(mapping[c] for c in needed)
            tys = new_node.output_types
            nms = new_node.output_names
            proj = P.ProjectNode(
                new_node,
                [ir.ColumnRef(tys[c], c, nms[c]) for c in keep],
                [nms[c] for c in keep],
            )
            inv = {c: i for i, c in enumerate(keep)}
            return proj, {c: inv[mapping[c]] for c in needed}
        return new_node, mapping
    if isinstance(node, (P.SortNode, P.TopNNode)):
        src_needed = set(needed) | {c for c, _, _ in node.sort_channels}
        src, src_map = prune_channels(node.source, src_needed)
        node.source = src
        node.sort_channels = [(src_map[c], a, nf) for c, a, nf in node.sort_channels]
        return node, src_map
    if isinstance(node, P.LimitNode):
        src, src_map = prune_channels(node.source, needed)
        node.source = src
        return node, src_map
    if isinstance(node, P.ExchangeNode):
        src_needed = set(needed) | set(node.partition_channels or [])
        src, src_map = prune_channels(node.source, src_needed)
        node.source = src
        if node.partition_channels:
            node.partition_channels = [src_map[c] for c in node.partition_channels]
        return node, src_map
    if isinstance(node, P.WindowNode):
        w = len(node.source.output_types)
        keep_calls = [i for i in range(len(node.calls)) if (w + i) in needed]
        src_needed = {c for c in needed if c < w}
        src_needed |= set(node.partition_channels)
        src_needed |= {c for c, _, _ in node.order_channels}
        for i in keep_calls:
            if node.calls[i].arg_channel is not None:
                src_needed.add(node.calls[i].arg_channel)
        src, src_map = prune_channels(node.source, src_needed)
        if not keep_calls:  # window outputs unused: drop the node entirely
            return src, {c: src_map[c] for c in needed if c < w}
        node.source = src
        node.partition_channels = [src_map[c] for c in node.partition_channels]
        node.order_channels = [(src_map[c], a, nf) for c, a, nf in node.order_channels]
        node.calls = [
            dataclasses.replace(
                node.calls[i],
                arg_channel=(
                    src_map[node.calls[i].arg_channel]
                    if node.calls[i].arg_channel is not None
                    else None
                ),
            )
            for i in keep_calls
        ]
        node.names = [node.names[i] for i in keep_calls]
        new_w = len(src.output_types)
        mapping = {c: src_map[c] for c in needed if c < w}
        for j, i in enumerate(keep_calls):
            mapping[w + i] = new_w + j
        return node, mapping
    if isinstance(node, P.UnionNode):
        keep = sorted(needed)
        mapping = {old: i for i, old in enumerate(keep)}
        new_sources = []
        for s in node.sources_:
            src, src_map = prune_channels(s, set(keep))
            # branches must stay channel-aligned: re-project when a source
            # pruned differently than requested
            if [src_map.get(c) for c in keep] != list(range(len(keep))):
                tys = src.output_types
                src = P.ProjectNode(
                    src,
                    [ir.ColumnRef(tys[src_map[c]], src_map[c]) for c in keep],
                    [node.names[c] for c in keep],
                )
            new_sources.append(src)
        return P.UnionNode(sources_=new_sources, names=[node.names[c] for c in keep]), mapping
    if isinstance(node, P.SetOpNode):
        # set membership is whole-row: every channel stays
        width = len(node.output_types)
        keep = list(range(width))
        names = node.output_names
        for attr in ("left", "right"):
            src, src_map = prune_channels(getattr(node, attr), set(keep))
            if [src_map.get(c) for c in keep] != keep:
                tys = src.output_types
                src = P.ProjectNode(
                    src,
                    [ir.ColumnRef(tys[src_map[c]], src_map[c]) for c in keep],
                    list(names),
                )
            setattr(node, attr, src)
        return node, {i: i for i in keep}
    if isinstance(node, P.MatchRecognizeNode):
        # DEFINE/MEASURES reference input columns by NAME (host matcher):
        # every source channel stays; MR outputs are not pruned through
        width = len(node.source.output_types)
        src, src_map = prune_channels(node.source, set(range(width)))
        assert all(src_map.get(c) == c for c in range(width))
        node.source = src
        return node, {i: i for i in range(len(node.output_types))}
    raise NotImplementedError(f"prune_channels: {type(node).__name__}")
