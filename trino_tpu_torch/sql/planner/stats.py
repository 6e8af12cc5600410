"""Plan cardinality estimates + expansion-join capacity hints.

Reference role: ``core/trino-main/.../cost/`` (StatsCalculator,
FilterStatsCalculator, JoinStatsRule) in miniature. Estimates flow from
connector row counts (``Connector.table_row_count``) through simple
selectivity heuristics. They are NOT trusted for correctness — an expansion
join or hash exchange whose true size exceeds its estimated static capacity
raises a deferred ``CAPACITY_EXCEEDED:<hint-key>`` flag, and the compiled
paths double that bucket and recompile (the bucketed-recompile loop of
SURVEY.md §7.3; the spill-FSM analog of HashBuilderOperator.java:162-177).

Also home to the broadcast-vs-repartition distribution choice (reference:
DetermineJoinDistributionType + AddExchanges.java:138): both the build-time
hint estimation and SpmdExecutor's trace-time dispatch consult the same
predicates, so hints always exist for the exchanges the trace creates.
"""
from __future__ import annotations

from typing import Dict

from trino_tpu_torch.sql.planner import plan as P

# Heuristic fudge factors, biased high — capacity hints should over- rather
# than under-estimate to avoid recompiles. Filters don't discount (the
# reference's FilterStatsCalculator discounts by 0.9 per unknown conjunct;
# a capacity hint must survive the filter being non-selective).
JOIN_FANOUT = 1.25  # M:N fudge over the FK-join output (= probe rows)
MIN_CAPACITY = 1024


def estimate_rows(session, node: P.PlanNode) -> int:
    """Rough output-row estimate per plan node (upper-bound biased)."""
    if isinstance(node, P.TableScanNode):
        if node.runtime_rows is not None:
            return max(int(node.runtime_rows), 1)
        conn = session.catalogs.get(node.catalog)
        n = conn.table_row_count(node.schema, node.table) if conn else None
        return int(n) if n else MIN_CAPACITY
    if isinstance(node, P.ValuesNode):
        return max(1, len(node.rows or ()))
    if isinstance(node, (P.LimitNode, P.TopNNode)):
        return min(node.count, estimate_rows(session, node.source))
    if isinstance(node, P.JoinNode):
        left = estimate_rows(session, node.left)
        right = estimate_rows(session, node.right)
        if node.join_type in ("semi", "anti"):
            return left
        if node.singleton:
            return left
        if node.right_unique:
            return left  # N:1 lookup join: output == probe rows
        if not node.left_keys:  # cross join
            return left * right
        return int(max(left, right) * JOIN_FANOUT)
    if isinstance(node, P.AggregationNode):
        src = estimate_rows(session, node.source)
        if not node.group_channels:
            return src  # global agg: the sort-based kernel's capacity is
            # the input row count anyway
        # group count <= min(input rows, product of group-key NDVs): the
        # NDV cap keeps compiled group-by capacity hints (and every hint
        # derived above an aggregation) from over-allocating to the full
        # input row count (reference: AggregationStatsRule)
        ndv = key_ndv(session, node.source, node.group_channels)
        return max(1, min(src, ndv)) if ndv else src
    if isinstance(node, P.UnionNode):
        # UNION ALL output = SUM of branches (the generic max fallback
        # would under-allocate capacity hints by the branch count)
        return sum(estimate_rows(session, s) for s in node.sources_)
    srcs = node.sources
    if not srcs:
        # exchange sources (RemoteSourceNode) stamped with actual upstream
        # stage output rows by the adaptive re-planner start from truth —
        # the TableScanNode.runtime_rows analog on fragment boundaries
        rr = getattr(node, "runtime_rows", None)
        if rr is not None:
            return max(int(rr), 1)
        return MIN_CAPACITY
    return max(estimate_rows(session, s) for s in srcs)


def _expansion_capacity(session, node: P.JoinNode) -> int:
    left = estimate_rows(session, node.left)
    right = estimate_rows(session, node.right)
    if not node.left_keys:  # true cross join: exact
        est = left * right
    elif node.join_type in ("semi", "anti"):
        # filtered-semi expansion materializes all key matches
        est = int(max(left, right) * JOIN_FANOUT)
    else:
        est = int(max(left, right) * JOIN_FANOUT)
        if node.join_type == "left":
            est = max(est, left)  # outer emits >= one slot per probe row
    return _pow2(max(est, MIN_CAPACITY))


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def estimate_capacity_hints(session, root: P.PlanNode) -> Dict[str, int]:
    """Static output capacities for every expansion-join node in the plan,
    from stats alone (no eager pre-run)."""
    hints: Dict[str, int] = {}
    for n in P.walk_plan(root):
        if isinstance(n, P.JoinNode) and P.uses_expansion_kernel(n):
            hints[f"join:{n.id}"] = _expansion_capacity(session, n)
        elif isinstance(n, P.CompactNode):
            hints[f"cmp:{n.id}"] = compact_capacity(session, n)
    return hints


# ---------------------------------------------------------------- exchanges

# Build sides larger than this repartition instead of broadcasting
# (join_max_broadcast_table_size analog, in rows).
BROADCAST_BUILD_MAX = 1 << 17
# Aggregations whose per-device input exceeds this repartition raw rows by
# group-key hash instead of gathering partial states.
GATHER_AGG_MAX_ROWS_PER_DEVICE = 1 << 16
MIN_EXCHANGE_CAPACITY = 256


def _keys_low_cardinality(node: P.AggregationNode) -> bool:
    """Group keys whose domain is small enough for the gather exchange no
    matter the row count (dictionary codes / booleans — the direct-layout
    grouping fast path)."""
    src_types = node.source.output_types
    for c in node.group_channels:
        t = src_types[c]
        if not (t.is_varchar or t.name == "boolean"):
            return False
    return True


def agg_repartitions(session, node: P.AggregationNode, n_devices: int) -> bool:
    """True when a distributed single-step aggregation should hash-repartition
    raw rows by group key (FIXED_HASH_DISTRIBUTION) instead of gathering
    partial states (the low-cardinality path)."""
    if not node.group_channels:
        return False  # global aggregate: partial states are one row
    if not P.can_split_aggs(node.aggregates):
        return False  # distinct/percentile fallback gathers raw rows (for now)
    if _keys_low_cardinality(node):
        return False
    rows = estimate_rows(session, node.source)
    return rows // max(n_devices, 1) > GATHER_AGG_MAX_ROWS_PER_DEVICE


def resolved_broadcast_limit(properties) -> int:
    """The effective join_max_broadcast_rows threshold: the session
    property when explicitly set, else the module constant (sessions
    materialize every default, so an untouched property defers to
    BROADCAST_BUILD_MAX — which tests tune directly). The ONE resolution
    both the static rule and the adaptive re-planner consult."""
    from trino_tpu_torch.client.properties import SYSTEM_SESSION_PROPERTIES

    declared = SYSTEM_SESSION_PROPERTIES["join_max_broadcast_rows"].default
    limit = int((properties or {}).get("join_max_broadcast_rows", declared))
    return BROADCAST_BUILD_MAX if limit == declared else limit


def join_repartitions(session, node: P.JoinNode, n_devices: int) -> bool:
    """True when a distributed join should co-partition both sides by key
    hash instead of broadcasting the build side (session property
    join_max_broadcast_rows; reference: join_max_broadcast_table_size)."""
    if not node.left_keys:
        return False  # cross join: broadcast is the only option
    limit = resolved_broadcast_limit(getattr(session, "properties", None))
    build = estimate_rows(session, node.right)
    return build > limit


def _gather_max_rows(session) -> int:
    """Per-device row threshold above which windows/set-ops/sorts
    repartition instead of gathering everything to every device
    (session property gather_max_rows_per_device)."""
    from trino_tpu_torch.client.properties import SYSTEM_SESSION_PROPERTIES

    default = SYSTEM_SESSION_PROPERTIES["gather_max_rows_per_device"].default
    props = getattr(session, "properties", None) or {}
    return int(props.get("gather_max_rows_per_device", default))


def window_repartitions(session, node: P.WindowNode, n_devices: int) -> bool:
    """True when a distributed window should hash-repartition rows by its
    PARTITION BY keys (whole partitions co-locate) instead of gathering."""
    if not node.partition_channels:
        return False  # global window frame: every row is one partition
    rows = estimate_rows(session, node.source)
    return rows // max(n_devices, 1) > _gather_max_rows(session)


def setop_repartitions(session, node: P.SetOpNode, n_devices: int) -> bool:
    """True when INTERSECT/EXCEPT should co-partition both sides by whole-
    row hash (equal rows co-locate) instead of gathering."""
    rows = estimate_rows(session, node.left) + estimate_rows(session, node.right)
    return rows // max(n_devices, 1) > _gather_max_rows(session)


def sort_repartitions(session, source: P.PlanNode, n_devices: int) -> bool:
    """True when a full ORDER BY (no limit) should range-partition by
    sampled splitters and sort shards locally — the sharded distributed
    sort (reference role: range exchange + ordered-merge consumer) —
    instead of gathering the whole input to every device."""
    rows = estimate_rows(session, source)
    return rows // max(n_devices, 1) > _gather_max_rows(session)


def exchange_capacity(session, source: P.PlanNode, n_devices: int) -> int:
    """Static per-(source device, destination device) block size for a hash
    exchange of ``source``'s rows: ~2x the uniform share, doubled on
    overflow by the recompile loop (skewed keys land here)."""
    rows = estimate_rows(session, source)
    per_block = (2 * rows) // max(n_devices * n_devices, 1)
    return _pow2(max(per_block, MIN_EXCHANGE_CAPACITY))


def estimate_exchange_hints(session, root: P.PlanNode, n_devices: int) -> Dict[str, int]:
    """Capacity hints for every hash exchange the SPMD trace will create —
    consults the same predicates as SpmdExecutor's dispatch."""
    hints: Dict[str, int] = {}
    for n in P.walk_plan(root):
        if isinstance(n, P.AggregationNode) and n.step == "single":
            if agg_repartitions(session, n, n_devices):
                hints[f"xchg:{n.id}"] = exchange_capacity(session, n.source, n_devices)
        elif isinstance(n, P.JoinNode):
            if join_repartitions(session, n, n_devices):
                hints[f"xchgl:{n.id}"] = exchange_capacity(session, n.left, n_devices)
                hints[f"xchgr:{n.id}"] = exchange_capacity(session, n.right, n_devices)
        elif isinstance(n, P.WindowNode):
            if window_repartitions(session, n, n_devices):
                hints[f"xchgw:{n.id}"] = exchange_capacity(session, n.source, n_devices)
        elif isinstance(n, P.SetOpNode):
            if setop_repartitions(session, n, n_devices):
                cap_l = exchange_capacity(session, n.left, n_devices)
                cap_r = exchange_capacity(session, n.right, n_devices)
                hints[f"xchgs:{n.id}"] = _pow2(cap_l + cap_r)
        elif isinstance(n, P.SortNode):
            if sort_repartitions(session, n.source, n_devices):
                hints[f"xchgo:{n.id}"] = exchange_capacity(session, n.source, n_devices)
    return hints


CAPACITY_ERROR_PREFIX = "CAPACITY_EXCEEDED:"


def grow_overflowed_hints(hints: Dict[str, int], codes, flags) -> Dict[str, int]:
    """Scan deferred-error (code, flag) pairs; double the bucket of every
    expansion join / exchange whose capacity flag fired (flags may be
    per-device stacks). Returns a new dict, or None when nothing overflowed
    — the shared half of the bucketed-recompile loop (CompiledQuery.run /
    DistributedQuery.run)."""
    import numpy as np

    out = None
    for code, flag in zip(codes, flags):
        if code.startswith(CAPACITY_ERROR_PREFIX) and bool(np.asarray(flag).any()):
            key = code[len(CAPACITY_ERROR_PREFIX):]
            out = dict(hints) if out is None else out
            out[key] = out.get(key, MIN_CAPACITY) * 2
    return out


# ------------------------------------------------- selectivity / live rows

# Reference: FilterStatsCalculator.UNKNOWN_FILTER_COEFFICIENT — predicates
# we can't estimate keep 90% of rows (biased high: capacities must survive
# a non-selective filter without a recompile).
UNKNOWN_FILTER_COEFFICIENT = 0.9


def resolve_column_stats(session, node: P.PlanNode, channel: int):
    """ColumnStats of the base-table column a channel traces to (through
    pass-through projections, filters, joins, and group keys), or None."""
    from trino_tpu_torch.sql import ir

    if isinstance(node, P.TableScanNode):
        conn = session.catalogs.get(node.catalog)
        if conn is None:
            return None
        return conn.column_stats(node.schema, node.table, node.column_names[channel])
    if isinstance(node, P.ProjectNode):
        e = node.expressions[channel]
        if isinstance(e, ir.ColumnRef):
            return resolve_column_stats(session, node.source, e.index)
        return None
    if isinstance(node, (P.FilterNode, P.CompactNode, P.LimitNode, P.SortNode,
                         P.TopNNode, P.WindowNode)):
        if isinstance(node, P.WindowNode) and channel >= len(node.source.output_types):
            return None
        return resolve_column_stats(session, node.source, channel)
    if isinstance(node, P.JoinNode):
        nl = len(node.left.output_types)
        if node.join_type in ("semi", "anti") or channel < nl:
            if channel < nl:
                return resolve_column_stats(session, node.left, channel)
            return None
        return resolve_column_stats(session, node.right, channel - nl)
    if isinstance(node, P.AggregationNode):
        if channel < len(node.group_channels):
            return resolve_column_stats(
                session, node.source, node.group_channels[channel])
        return None
    return None


def _scale_of_type(t) -> int:
    return t.scale if getattr(t, "scale", None) is not None and t.is_decimal else 0


def _cmp_selectivity(session, fn: str, col_expr, const_expr, source) -> float:
    """Range-interpolated selectivity of ``col <op> const`` from column
    min/max stats (reference: FilterStatsCalculator range arithmetic)."""
    cs = resolve_column_stats(session, source, col_expr.index)
    if cs is None or const_expr.value is None:
        return UNKNOWN_FILTER_COEFFICIENT
    if cs.low is None or cs.high is None:
        # no range (e.g. varchar vocab) — NDV still prices equality
        if cs.ndv and fn == "eq":
            return 1.0 / cs.ndv
        if cs.ndv and fn == "ne":
            return 1.0 - 1.0 / cs.ndv
        return UNKNOWN_FILTER_COEFFICIENT
    lo, hi = cs.low, cs.high
    try:
        c = int(const_expr.value)
    except (TypeError, ValueError):
        return UNKNOWN_FILTER_COEFFICIENT
    # align literal scale to the column's storage scale
    ds = _scale_of_type(col_expr.type) - _scale_of_type(const_expr.type)
    if ds > 0:
        c *= 10 ** ds
    elif ds < 0:
        c //= 10 ** (-ds)
    span = hi - lo + 1
    if fn == "eq":
        return 1.0 / max(cs.ndv or span, 1) if lo <= c <= hi else 0.0
    if fn == "ne":
        return 1.0 - (1.0 / max(cs.ndv or span, 1)) if lo <= c <= hi else 1.0
    if fn in ("lt", "le"):
        kept = c - lo + (1 if fn == "le" else 0)
    elif fn in ("gt", "ge"):
        kept = hi - c + (1 if fn == "ge" else 0)
    else:
        return UNKNOWN_FILTER_COEFFICIENT
    return min(max(kept / span, 0.0), 1.0)


def predicate_selectivity(session, pred, source) -> float:
    """Estimated fraction of rows a predicate keeps."""
    from trino_tpu_torch.sql import ir

    if isinstance(pred, ir.Call):
        if pred.name == "and":
            return predicate_selectivity(session, pred.args[0], source) * \
                predicate_selectivity(session, pred.args[1], source)
        if pred.name == "or":
            a = predicate_selectivity(session, pred.args[0], source)
            b = predicate_selectivity(session, pred.args[1], source)
            return min(1.0, a + b - a * b)
        if pred.name in ("eq", "ne", "lt", "le", "gt", "ge"):
            a, b = pred.args
            flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
            if isinstance(a, ir.ColumnRef) and isinstance(b, ir.Constant):
                return _cmp_selectivity(session, pred.name, a, b, source)
            if isinstance(b, ir.ColumnRef) and isinstance(a, ir.Constant):
                return _cmp_selectivity(
                    session, flip.get(pred.name, pred.name), b, a, source)
        if pred.name == "between":
            v, lo_e, hi_e = pred.args
            if isinstance(v, ir.ColumnRef) and isinstance(lo_e, ir.Constant) \
                    and isinstance(hi_e, ir.Constant):
                return max(
                    0.0,
                    _cmp_selectivity(session, "ge", v, lo_e, source)
                    + _cmp_selectivity(session, "le", v, hi_e, source) - 1.0,
                )
        if pred.name == "in_list":
            v = pred.args[0]
            if isinstance(v, ir.ColumnRef):
                cs = resolve_column_stats(session, source, v.index)
                if cs is not None and cs.ndv:
                    return min(1.0, (len(pred.args) - 1) / cs.ndv)
    return UNKNOWN_FILTER_COEFFICIENT


def key_ndv(session, node: P.PlanNode, channels) -> int:
    """Product of per-key NDVs (capped), or 0 when unknown."""
    total = 1
    for c in channels:
        cs = resolve_column_stats(session, node, c)
        if cs is None or not cs.ndv:
            return 0
        total *= cs.ndv
        if total > 1 << 62:
            break
    return total


def estimate_live_rows(session, node: P.PlanNode) -> int:
    """Estimated LIVE output rows (as opposed to estimate_rows, which is
    capacity-biased): drives compaction placement and capacities.
    Reference role: StatsCalculator's outputRowCount."""
    if isinstance(node, P.TableScanNode):
        # NO constraint discount here: scan constraints are advisory and the
        # enforcing FilterNode is always kept (optimizer.derive_scan_
        # constraints), so the filter's predicate_selectivity already counts
        # them — discounting both would square the selectivity.
        if node.runtime_rows is not None:
            return max(int(node.runtime_rows), 1)  # phase-1 staged truth
        conn = session.catalogs.get(node.catalog)
        n = conn.table_row_count(node.schema, node.table) if conn else None
        return int(n) if n else MIN_CAPACITY
    if isinstance(node, P.FilterNode):
        src = estimate_live_rows(session, node.source)
        return max(1, int(src * predicate_selectivity(
            session, node.predicate, node.source)))
    if isinstance(node, (P.ProjectNode, P.CompactNode, P.WindowNode, P.SortNode)):
        return estimate_live_rows(session, node.source)
    if isinstance(node, (P.LimitNode, P.TopNNode)):
        return min(node.count, estimate_live_rows(session, node.source))
    if isinstance(node, P.ValuesNode):
        return max(1, len(node.rows or ()))
    if isinstance(node, P.UnionNode):
        return sum(estimate_live_rows(session, s) for s in node.sources_)
    if isinstance(node, P.JoinNode):
        left = estimate_live_rows(session, node.left)
        right = estimate_live_rows(session, node.right)
        if node.singleton:
            return left
        if not node.left_keys:
            return left * right
        ndv = key_ndv(session, node.left, node.left_keys)
        match = min(1.0, right / ndv) if ndv else 1.0
        if node.df_exact:
            # probe scans were narrowed by this join's exact in-set domain:
            # every surviving probe row matches (two-phase dynamic filtering)
            match = 1.0
        if node.join_type == "semi":
            return max(1, int(left * match))
        if node.join_type == "anti":
            return max(1, int(left * (1.0 - match)) if ndv else left)
        if node.right_unique:
            out = int(left * match)
        else:
            ndv_r = key_ndv(session, node.right, node.right_keys)
            fanout = max(right / ndv_r, 1.0) if ndv_r else JOIN_FANOUT
            out = int(left * match * fanout)
        if node.join_type == "left":
            out = max(out, left)
        return max(1, out)
    if isinstance(node, P.AggregationNode):
        src = estimate_live_rows(session, node.source)
        if not node.group_channels:
            return 1
        ndv = key_ndv(session, node.source, node.group_channels)
        return max(1, min(src, ndv) if ndv else src)
    if isinstance(node, P.SetOpNode):
        return estimate_live_rows(session, node.left)
    srcs = node.sources
    if not srcs:
        rr = getattr(node, "runtime_rows", None)  # stamped exchange source
        if rr is not None:
            return max(int(rr), 1)
        return MIN_CAPACITY
    return max(estimate_live_rows(session, s) for s in srcs)


def compact_capacity(session, node: P.CompactNode) -> int:
    """Static capacity for a CompactNode: estimated live rows + 30% slack,
    next power of two (the recompile loop doubles on overflow)."""
    est = node.estimated_rows or estimate_live_rows(session, node.source)
    return _pow2(max(int(est * 1.3), MIN_CAPACITY))
