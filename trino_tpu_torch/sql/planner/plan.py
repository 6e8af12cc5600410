"""Logical plan nodes.

Reference: ``core/trino-main/.../sql/planner/plan/`` (46 concrete node types).
Round-1 subset (~15) covering the TPC-H surface; grows with the engine.
Plans are *channel-positional*: every node exposes ``output_types`` (and
debug ``output_names``); expressions inside a node are IR over the node's
input channels (left channels then right channels for joins, as in the
reference's symbol->channel layout done by LocalExecutionPlanner).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.sql import ir

_next_plan_id = itertools.count()


@dataclasses.dataclass
class PlanNode:
    id: int = dataclasses.field(default_factory=lambda: next(_next_plan_id), init=False)

    @property
    def sources(self) -> Sequence["PlanNode"]:
        return ()

    @property
    def output_types(self) -> List[T.Type]:
        raise NotImplementedError

    @property
    def output_names(self) -> List[str]:
        raise NotImplementedError


@dataclasses.dataclass
class TableScanNode(PlanNode):
    """Reference: plan/TableScanNode.java — here carries the connector handle
    directly (catalog, schema, table) plus the projected column subset."""

    catalog: str
    schema: str
    table: str
    column_names: List[str]
    column_types: List[T.Type]
    table_handle: object = None  # connector-provided
    # Static pushdown (reference: applyFilter/TupleDomain): advisory
    # constraint derived from filter conjuncts; the filter is kept.
    constraint: object = None  # Optional[TupleDomain]
    # Runtime narrowing (reference: DynamicFilterService/DynamicFilter):
    # [(join_node_id, key_index, column_name)] — at execution the scan
    # waits for the named join's build-side key domain.
    dynamic_filters: List = None
    # ACTUAL rows staged for this scan (set by the two-phase compiled path
    # after phase-1 narrowing; reference: AdaptivePlanner's runtime stats) —
    # when present, cardinality estimation starts from truth, not stats.
    runtime_rows: Optional[int] = None
    # set by the materialized-view substitution pass (trino_tpu/matview/):
    # this scan reads the named MV's storage table in place of a matched
    # plan subtree — EXPLAIN renders it as ``[mv: <name>]``
    mv_name: Optional[str] = None

    @property
    def output_types(self):
        return list(self.column_types)

    @property
    def output_names(self):
        return list(self.column_names)


@dataclasses.dataclass
class FilterNode(PlanNode):
    source: PlanNode = None
    predicate: ir.Expr = None

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        return self.source.output_types

    @property
    def output_names(self):
        return self.source.output_names


@dataclasses.dataclass
class CompactNode(PlanNode):
    """Squeeze live rows to the front of a smaller static-capacity page.

    TPU-first: filters keep selection masks instead of compacting (static
    shapes), so a selective pipeline drags dead slots through every
    downstream sort/join. When the optimizer's cardinality estimate says
    live rows are far below the slot count, this node pays one stable
    payload-carrying sort (live rows first, original order kept) to shrink
    the working set. Capacity comes from stats (hint key ``cmp:<id>``);
    a too-small estimate raises CAPACITY_EXCEEDED and the bucketed
    recompile loop doubles it. Reference role: the implicit compaction the
    reference gets for free from page-at-a-time operators that drop
    filtered rows (PageProcessor emitting compacted pages)."""

    source: PlanNode = None
    estimated_rows: int = 0  # live-row estimate the capacity hint derives from

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        return self.source.output_types

    @property
    def output_names(self):
        return self.source.output_names


@dataclasses.dataclass
class ProjectNode(PlanNode):
    source: PlanNode = None
    expressions: List[ir.Expr] = None
    names: List[str] = None

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        return [e.type for e in self.expressions]

    @property
    def output_names(self):
        return list(self.names)

    @staticmethod
    def identity_prefix(source: PlanNode, extra: List[ir.Expr], extra_names: List[str]):
        exprs = [
            ir.ColumnRef(t, i, n)
            for i, (t, n) in enumerate(zip(source.output_types, source.output_names))
        ]
        return ProjectNode(source, exprs + extra, source.output_names + extra_names)


@dataclasses.dataclass
class UnnestNode(PlanNode):
    """Expand array/map-valued expressions into rows, replicating the source
    columns (lateral CROSS JOIN UNNEST semantics; ordinality optional).

    Reference: ``operator/unnest/UnnestOperator.java:41`` — there a
    position-at-a-time block traversal; here one static-shape expansion:
    output capacity = total flat element count, per-output-row parent ids
    come from a searchsorted over the offsets, replicated columns are row
    gathers, unnested columns are the flat children themselves (ops/
    array_ops.py). Rows beyond a row's own length are sel-masked dead."""

    source: PlanNode = None
    unnest_exprs: List[ir.Expr] = None  # array/map-typed, over source channels
    ordinality: bool = False
    # source channels replicated into the output (pruning drops unused ones —
    # critically the unnested array column itself, whose device row-gather
    # would need data-dependent reshaping)
    replicate_channels: List[int] = None

    def __post_init__(self):
        if self.replicate_channels is None:
            self.replicate_channels = list(range(len(self.source.output_types)))

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        out = [self.source.output_types[c] for c in self.replicate_channels]
        for e in self.unnest_exprs:
            t = e.type
            if isinstance(t, T.MapType):
                out.extend([t.key, t.value])
            else:
                out.append(t.element)
        if self.ordinality:
            out.append(T.BIGINT)
        return out

    @property
    def output_names(self):
        out = [self.source.output_names[c] for c in self.replicate_channels]
        for i, e in enumerate(self.unnest_exprs):
            if isinstance(e.type, T.MapType):
                out.extend([f"key_{i}" if i else "key", f"value_{i}" if i else "value"])
            else:
                out.append(f"col_{i}" if i else "col")
        if self.ordinality:
            out.append("ordinality")
        return out


@dataclasses.dataclass(frozen=True)
class AggregateCall:
    function: str  # count | sum | avg | min | max | stddev* | var* | approx_* | bool_* | *_by | corr | ...
    arg_channel: Optional[int]  # None for count(*)
    output_type: T.Type
    distinct: bool = False
    param: Optional[float] = None  # approx_percentile's percentile
    # second argument channel (min_by/max_by key, corr/covar/regr y, map_agg value)
    arg2_channel: Optional[int] = None
    # count(*) counts rows; count(x) counts non-null x

    def __post_init__(self):
        # approx_distinct counts distinct non-null values: it shares the
        # cannot-split-partial/final property of DISTINCT aggregates, so the
        # flag is forced here (every construction site included)
        if self.function == "approx_distinct" and not self.distinct:
            object.__setattr__(self, "distinct", True)


@dataclasses.dataclass
class AggregationNode(PlanNode):
    """Reference: plan/AggregationNode.java + HashAggregationOperator.
    step: 'single' | 'partial' | 'final' (partial/final appear after the
    fragmenter splits the aggregation across an exchange)."""

    source: PlanNode = None
    group_channels: List[int] = None
    aggregates: List[AggregateCall] = None
    step: str = "single"
    names: List[str] = None

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        src = self.source.output_types
        types = [src[c] for c in self.group_channels]
        if self.step == "partial":
            types += [t for agg in self.aggregates for t in _acc_types(agg, src)]
        else:
            types += [a.output_type for a in self.aggregates]
        return types

    @property
    def output_names(self):
        if self.step != "partial":
            return list(self.names)
        # partial output carries one column PER ACCUMULATOR STATE (an avg
        # ships (sum, count)), so names expand to match — the sanity
        # checker's arity invariant (sql/planner/sanity.py) holds on every
        # node, partials included
        k = len(self.group_channels)
        out = list(self.names[:k])
        for name, agg in zip(self.names[k:], self.aggregates):
            n_states = _acc_state_count(agg)
            if n_states == 1:
                out.append(name)
            else:
                out.extend(f"{name}$s{i}" for i in range(n_states))
        return out


def _acc_types(agg: AggregateCall, src_types) -> List[T.Type]:
    """Accumulator (partial-state) types for an aggregate (reference:
    AccumulatorCompiler intermediate state). Length must equal
    ``_acc_state_count(agg)`` — the executor's final step uses that to
    slice gathered state columns."""
    if agg.function in ("count", "count_star"):
        out = [T.BIGINT]
    elif agg.function == "avg":
        # running (sum, count)
        base = src_types[agg.arg_channel]
        out = [T.DOUBLE if base.is_floating else base, T.BIGINT]
    elif agg.function in _VAR_FAMILY:
        # running (count, mean, m2) — the reference's VarianceState layout;
        # merged with the exact multi-way Chan decomposition
        # (ops/aggregate.py combine_var_states)
        out = [T.BIGINT, T.DOUBLE, T.DOUBLE]
    elif agg.function == "sum":
        out = [agg.output_type]
        if _is_long_decimal(agg.output_type):
            # two-limb running sum: (lo bit pattern, hi limb) — exact for
            # the full p38 range across the partial/final split
            # (ops/aggregate.py agg_sum_128; reference: Int128State)
            out.append(T.BIGINT)
    elif agg.function in ("min", "max"):
        out = [src_types[agg.arg_channel]]
    elif agg.function in ("bool_and", "bool_or", "every"):
        out = [T.BOOLEAN]
    elif agg.function == "count_if":
        out = [T.BIGINT]
    elif agg.function == "approx_percentile":
        # mergeable quantile summary (ops/hll.py QUANTILE_SAMPLES values at
        # evenly spaced local ranks) + the live count
        out = [src_types[agg.arg_channel]] * QUANTILE_SAMPLES + [T.BIGINT]
    else:
        raise NotImplementedError(agg.function)
    assert len(out) == _acc_state_count(agg)
    return out


_VAR_FAMILY = {"stddev", "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop"}


# Aggregates whose partial state is the raw rows themselves (variable
# length or pair-valued) — the planner routes them through a gather
# exchange instead of a partial/final split.
_UNSPLITTABLE = {
    "array_agg", "histogram", "map_agg", "min_by", "max_by",
    "corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept",
    "arbitrary", "any_value", "geometric_mean", "checksum",
}


def can_split_aggs(aggregates) -> bool:
    """True when every aggregate has a mergeable partial/final state.
    DISTINCT aggregates must see all raw rows; approx_percentile ships a
    mergeable quantile summary (ops/hll.py percentile_states)."""
    return not any(
        a.distinct or a.function in _UNSPLITTABLE for a in aggregates
    )


# sample count of the approx_percentile summary (trino_tpu/ops/hll.py)
QUANTILE_SAMPLES = 65


def _acc_state_count(agg: AggregateCall) -> int:
    """Number of accumulator state columns an aggregate ships partial->final."""
    if agg.function == "approx_percentile":
        return QUANTILE_SAMPLES + 1
    if agg.function in _VAR_FAMILY:
        return 3
    if agg.function == "sum" and _is_long_decimal(agg.output_type):
        return 2
    return 2 if agg.function == "avg" else 1


def _is_long_decimal(t: T.Type) -> bool:
    return isinstance(t, T.DecimalType) and t.precision > 18


_TWO_ARG_AGGS = {
    "min_by", "max_by", "map_agg",
    "corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept",
}


@dataclasses.dataclass
class JoinNode(PlanNode):
    """Reference: plan/JoinNode.java. Output = left channels ++ right channels
    (probe then build). ``distribution``: None until the optimizer picks
    partitioned vs broadcast (AddExchanges analog)."""

    join_type: str = "inner"  # inner | left | semi | anti (right/full: not yet supported)
    left: PlanNode = None
    right: PlanNode = None
    left_keys: List[int] = None
    right_keys: List[int] = None
    filter: Optional[ir.Expr] = None  # over concatenated channels
    distribution: Optional[str] = None  # 'partitioned' | 'broadcast'
    right_unique: bool = False  # build side keys unique (N:1 lookup join)
    singleton: bool = False  # right side is a scalar subquery (exactly 1 row)
    # key indices whose build-side domain some probe scan consumes as a
    # dynamic filter (set by optimizer.plan_dynamic_filters) — the executor
    # extracts domains only for these
    dyn_filter_keys: List[int] = None
    # phase-1 host evaluation produced an EXACT in-set domain that probe
    # scans applied: every surviving probe row has >= 1 build match, so
    # cardinality estimation skips the key-match discount
    df_exact: bool = False

    @property
    def sources(self):
        return (self.left, self.right)

    @property
    def output_types(self):
        if self.join_type in ("semi", "anti"):
            return self.left.output_types
        return self.left.output_types + self.right.output_types

    @property
    def output_names(self):
        if self.join_type in ("semi", "anti"):
            return self.left.output_names
        return self.left.output_names + self.right.output_names


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """One window function evaluation (reference: WindowNode.Function)."""

    function: str  # rank | dense_rank | row_number | sum | count | count_star
    #              | avg | min | max | lag | lead | first_value | last_value
    arg_channel: Optional[int]
    output_type: T.Type = None
    offset: int = 1  # lag/lead distance (static)
    # 'running': RANGE UNBOUNDED PRECEDING..CURRENT ROW (peers included) —
    # the default frame with ORDER BY; 'rows_running': ROWS ..CURRENT ROW;
    # 'partition': whole partition (default without ORDER BY / UNBOUNDED
    # PRECEDING..UNBOUNDED FOLLOWING)
    frame: str = "running"
    # ROWS-frame numeric bounds relative to the current row (frame ==
    # 'rows_offset'): lo = -n for "n PRECEDING", hi = +m for "m FOLLOWING",
    # 0 = CURRENT ROW, None = unbounded on that side
    frame_lo: Optional[int] = None
    frame_hi: Optional[int] = None


@dataclasses.dataclass
class WindowNode(PlanNode):
    """Window functions over sorted partitions; output = source channels ++
    one channel per call. Reference: plan/WindowNode.java +
    operator/WindowOperator.java:69 (redesigned: one fused sort + streaming
    prefix kernels instead of per-partition iteration, ops/window.py)."""

    source: PlanNode = None
    partition_channels: List[int] = None
    order_channels: List[Tuple[int, bool, Optional[bool]]] = None  # (ch, asc, nulls_first)
    calls: List[WindowCall] = None
    names: List[str] = None  # names for the appended channels

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        return self.source.output_types + [c.output_type for c in self.calls]

    @property
    def output_names(self):
        return self.source.output_names + list(self.names)


@dataclasses.dataclass
class MatchRecognizeNode(PlanNode):
    """Row pattern matching, ONE ROW PER MATCH (reference:
    plan/PatternRecognitionNode). DEFINE/MEASURES keep their analyzed-AST
    form: the matcher is host-tier (exec/match_recognize.py) — its
    backtracking inner loop is the one operator family that does not
    vectorize onto the device."""

    source: PlanNode = None
    partition_channels: List[int] = None
    sort_channels: List[Tuple[int, bool, Optional[bool]]] = None
    pattern: tuple = ()  # ((variable, quantifier), ...)
    defines: tuple = ()  # ((variable, ast expr), ...)
    measures: tuple = ()  # ((ast expr, name), ...)
    measure_types: List[T.Type] = None
    after_match: str = "past_last"
    # the SCOPE names of the input (aliases applied): DEFINE/MEASURES
    # resolve by these, not by the physical child's debug names
    input_names: List[str] = None

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        src = self.source.output_types
        return [src[c] for c in self.partition_channels] + list(self.measure_types)

    @property
    def output_names(self):
        names = self.input_names or self.source.output_names
        return [names[c] for c in self.partition_channels] + [
            n for _, n in self.measures]


@dataclasses.dataclass
class SortNode(PlanNode):
    source: PlanNode = None
    sort_channels: List[Tuple[int, bool, Optional[bool]]] = None  # (ch, asc, nulls_first)

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        return self.source.output_types

    @property
    def output_names(self):
        return self.source.output_names


@dataclasses.dataclass
class TopNNode(PlanNode):
    source: PlanNode = None
    count: int = 0
    sort_channels: List[Tuple[int, bool, Optional[bool]]] = None
    step: str = "single"  # single | partial | final

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        return self.source.output_types

    @property
    def output_names(self):
        return self.source.output_names


@dataclasses.dataclass
class LimitNode(PlanNode):
    source: PlanNode = None
    count: int = 0
    step: str = "single"

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        return self.source.output_types

    @property
    def output_names(self):
        return self.source.output_names


@dataclasses.dataclass
class OutputNode(PlanNode):
    source: PlanNode = None
    column_names: List[str] = None

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        return self.source.output_types

    @property
    def output_names(self):
        return list(self.column_names)


@dataclasses.dataclass
class ValuesNode(PlanNode):
    types: List[T.Type] = None
    names: List[str] = None
    rows: List[tuple] = None

    @property
    def output_types(self):
        return list(self.types)

    @property
    def output_names(self):
        return list(self.names)


@dataclasses.dataclass
class UnionNode(PlanNode):
    """UNION ALL: positional concatenation of same-width sources
    (reference: plan/UnionNode.java; distinct UNION plans as UnionNode +
    grouping AggregationNode, the reference's SetOperationNodeTranslator)."""

    sources_: List[PlanNode] = None
    names: List[str] = None

    @property
    def sources(self):
        return tuple(self.sources_)

    @property
    def output_types(self):
        return self.sources_[0].output_types

    @property
    def output_names(self):
        return list(self.names)


@dataclasses.dataclass
class SetOpNode(PlanNode):
    """INTERSECT/EXCEPT (DISTINCT): whole-row set membership with SQL
    set-operation NULL semantics (NULLs compare equal — the grouping
    equality, not the join equality; reference:
    SetOperationNodeTranslator + distinct aggregations)."""

    op: str = "intersect"  # intersect | except
    left: PlanNode = None
    right: PlanNode = None

    @property
    def sources(self):
        return (self.left, self.right)

    @property
    def output_types(self):
        return self.left.output_types

    @property
    def output_names(self):
        return self.left.output_names


@dataclasses.dataclass
class ExchangeNode(PlanNode):
    """Reference: plan/ExchangeNode.java — the fragmenter cuts plans here
    (PlanFragmenter.java:94). partitioning: 'single' (gather),
    'hash' (repartition on key channels), 'broadcast' (replicate)."""

    source: PlanNode = None
    partitioning: str = "single"
    partition_channels: List[int] = None
    scope: str = "remote"  # remote | local

    @property
    def sources(self):
        return (self.source,)

    @property
    def output_types(self):
        return self.source.output_types

    @property
    def output_names(self):
        return self.source.output_names


def walk_plan(node: PlanNode):
    yield node
    for s in node.sources:
        yield from walk_plan(s)


def uses_expansion_kernel(n: JoinNode) -> bool:
    """True when the executor dispatches this join to the two-pass expansion
    kernel (expand_join / semi_join_filtered), whose static output capacity
    comes from stats (sql/planner/stats.py) with overflow-triggered
    recompiles. Must mirror Executor._exec_JoinNode's dispatch."""
    if n.join_type in ("semi", "anti"):
        return n.filter is not None
    return not n.right_unique and not n.singleton


def kernel_annotations(rows) -> dict:
    """Per-plan-node launch counts + dispatch overhead from kernel-ledger
    rows (obs/devprofiler.py wire shape) — the EXPLAIN ANALYZE VERBOSE
    ``launches=/dispatch_overhead=`` annotation source."""
    out: dict = {}
    for r in rows or ():
        nid = str(r.get("planNodeId", ""))
        agg = out.setdefault(nid, {"launches": 0, "overheadS": 0.0})
        agg["launches"] += int(r.get("launches", 0))
        agg["overheadS"] += max(
            0.0, float(r.get("wallS", 0.0)) - float(r.get("deviceS", 0.0)))
    return out


def format_plan(node: PlanNode, indent: int = 0, executor=None,
                stats=None, verbose: bool = False, kernels=None) -> str:
    """Text plan printer (reference: sql/planner/planprinter/PlanPrinter.java).
    With ``executor`` (a finished eager Executor), renders EXPLAIN ANALYZE:
    per-operator wall time / output rows / scan+spill detail from its stats
    (the role of PlanPrinter's stats injection from OperatorStats). With
    ``stats`` (node id → OperatorStats, e.g. the coordinator's rollup of
    worker-reported task stats), the same annotations render WITHOUT a
    local executor — the distributed EXPLAIN ANALYZE path. ``verbose``
    additionally prints bytes / peak reservation / split counts and the
    kernel ledger's per-node ``launches=/dispatch_overhead=`` line
    (``kernels``: plan-node id → annotation, see kernel_annotations;
    derived from the executor's own kernel stats when not passed)."""
    if verbose and kernels is None and executor is not None:
        kernels = kernel_annotations(
            getattr(executor, "kernel_stats", {}).values())
    pad = "  " * indent
    label = type(node).__name__.replace("Node", "")
    detail = ""
    if isinstance(node, TableScanNode):
        detail = f" {node.catalog}.{node.schema}.{node.table} -> {node.column_names}"
        if node.mv_name is not None:
            detail += f" [mv: {node.mv_name}]"
        if node.constraint is not None:
            detail += f" constraint={node.constraint!r}"
        if node.table_handle is not None:
            detail += f" pushdown={node.table_handle!r}"
        if node.dynamic_filters:
            detail += f" dynamic_filters={[c for _, _, c in node.dynamic_filters]}"
    elif isinstance(node, FilterNode):
        detail = f" {node.predicate!r}"
    elif isinstance(node, ProjectNode):
        detail = f" {[f'{n}:={e!r}' for n, e in zip(node.names, node.expressions)]}"
    elif isinstance(node, AggregationNode):
        detail = f" [{node.step}] keys={node.group_channels} aggs={[a.function for a in self_aggs(node)]}"
    elif isinstance(node, JoinNode):
        detail = (
            f" [{node.join_type}{'/' + node.distribution if node.distribution else ''}]"
            f" L{node.left_keys} = R{node.right_keys}"
            + (f" filter={node.filter!r}" if node.filter is not None else "")
        )
    elif isinstance(node, (SortNode, TopNNode)):
        detail = f" by={node.sort_channels}" + (
            f" count={node.count}" if isinstance(node, TopNNode) else ""
        )
    elif isinstance(node, LimitNode):
        detail = f" {node.count}"
    elif isinstance(node, ExchangeNode):
        detail = f" [{node.scope}/{node.partitioning}] keys={node.partition_channels}"
    elif isinstance(node, OutputNode):
        detail = f" {node.column_names}"
    if executor is not None:
        st = executor.node_stats.get(node.id)
        if st is not None:
            detail += f"  [wall={st.wall_s * 1e3:.1f}ms rows={st.output_rows}]"
            if verbose:
                detail += (f" [bytes={st.output_bytes}"
                           f" peak={st.peak_bytes}]")
        if isinstance(node, TableScanNode) and node.id in executor.scan_stats:
            detail += f" [scanned={executor.scan_stats[node.id]}]"
        for sp in executor.memory.spills:
            if sp.node_id == node.id:
                detail += (
                    f" [spilled: {sp.partitions} passes,"
                    f" {sp.projected_bytes // 1024}KiB projected]"
                )
    elif stats is not None:
        st = stats.get(node.id)
        if st is not None:
            detail += f"  [wall={st.wall_s * 1e3:.1f}ms rows={st.output_rows}]"
            if isinstance(node, TableScanNode) and (st.splits or st.input_rows):
                detail += f" [scanned={st.input_rows} splits={st.splits}]"
            if verbose:
                detail += (f" [bytes={st.output_bytes}"
                           f" peak={st.peak_bytes}"
                           f" calls={st.invocations}]")
    if verbose and kernels:
        kr = kernels.get(str(node.id))
        if kr is not None:
            detail += (f" [launches={kr['launches']}"
                       f" dispatch_overhead={kr['overheadS'] * 1e3:.1f}ms]")
    lines = [f"{pad}- {label}{detail}"]
    for s in node.sources:
        lines.append(format_plan(s, indent + 1, executor, stats, verbose,
                                 kernels))
    return "\n".join(lines)


def self_aggs(node: AggregationNode):
    return node.aggregates or []
