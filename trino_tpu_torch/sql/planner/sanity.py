"""Plan-IR sanity checker: fail loudly at plan time, not wrongly at run time.

Reference: ``sql/planner/sanity/PlanSanityChecker.java`` — Trino interposes
a validator between every optimizer stage (ValidateDependenciesChecker,
NoDuplicatePlanNodeIdsChecker, TypeValidator, ...) so a bad rewrite raises
at plan time instead of corrupting results at execution time. Our plans are
*channel-positional* (sql/planner/plan.py): every expression indexes its
source's output channels by position, so a rule that misindexes a channel
silently reads the wrong column. ``validate_plan`` walks any PlanNode tree
and enforces the invariants the executor assumes:

- ``len(output_types) == len(output_names)`` on every node (``arity``);
- every ``ir.Expr`` channel reference within the source's arity
  (``channel-range``) and type-consistent with the channel it names
  (``channel-type``); no ``OuterRef`` survives planning
  (``unresolved-outer-ref``);
- join/aggregate/window/sort/exchange key channels in range
  (``key-range``), join key lists the same length (``key-arity``);
- boolean positions (filter predicates, join filters) actually typed
  BOOLEAN (``predicate-type``);
- the tree is a tree — no node object reachable twice (``tree-sharing``);
- UNION branches channel-aligned (``union-alignment``);
- fragment-level (``validate_fragments``): every ``RemoteSourceNode.types``
  matches the producing fragment's ``output_types``
  (``stale-remote-source``), producers exist (``unknown-fragment``),
  fragment ids are unique (``duplicate-fragment-id``), and the fragment
  DAG is acyclic (``fragment-cycle``).

Failures raise :class:`PlanSanityError` naming the node, the violated
invariant, and the optimizer phase that produced the plan, and increment
``trino_tpu_plan_validation_failures_total``. Wired after initial planning,
after each named pass in ``optimizer.optimize``, after ``fragment_plan``,
and after every adaptive re-plan (``adaptive/replanner.py``) — gated by the
``plan_validation`` session property, which defaults to ON under pytest.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from trino_tpu_torch import types as T
from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.planner import plan as P


class PlanSanityError(ValueError):
    """A plan invariant does not hold. Names the failing node, the
    invariant, and the phase (the pass that produced the plan) so the
    offending rewrite is identified without bisection."""

    def __init__(self, node: P.PlanNode, invariant: str, phase: str,
                 detail: str):
        self.node_type = type(node).__name__
        self.node_id = node.id
        self.invariant = invariant
        self.phase = phase
        self.detail = detail
        super().__init__(
            f"plan sanity [{invariant}] at {self.node_type}#{self.node_id} "
            f"after {phase}: {detail}")


def _fail(node: P.PlanNode, invariant: str, phase: str, detail: str):
    from trino_tpu_torch.obs import metrics as M

    M.PLAN_VALIDATION_FAILURES.inc(1, phase.split(":", 1)[0])
    raise PlanSanityError(node, invariant, phase, detail)


# ---------------------------------------------------------------- gating


def validation_enabled(session) -> bool:
    """The ``plan_validation`` session property; its None default means
    AUTO — on under pytest (every test run validates every plan), off in
    production paths unless explicitly enabled."""
    props = getattr(session, "properties", None) or {}
    val = props.get("plan_validation")
    if val is None:
        return "PYTEST_CURRENT_TEST" in os.environ
    if isinstance(val, str):  # wire-protocol header strings
        return val.lower() not in ("false", "0", "no")
    return bool(val)


def checker(session):
    """A ``check(node, phase)`` callable for pass pipelines — a no-op when
    validation is off, so call sites stay one line per pass."""
    if not validation_enabled(session):
        return lambda node, phase: None
    return lambda node, phase: validate_plan(node, phase=phase)


# ------------------------------------------------------------ tree walk


def validate_plan(root: P.PlanNode, phase: str = "unknown",
                  _seen: Optional[Dict[int, P.PlanNode]] = None) -> None:
    """Validate one plan tree. ``_seen`` (object id -> node) is threaded by
    ``validate_fragments`` so node sharing is also caught ACROSS fragment
    roots (a subtree may live in exactly one fragment)."""
    seen: Dict[int, P.PlanNode] = _seen if _seen is not None else {}
    stack = [root]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            _fail(node, "tree-sharing", phase,
                  "node reachable through more than one parent — the plan "
                  "must be a tree (rewrites must copy, not alias)")
        seen[id(node)] = node
        _validate_node(node, phase)
        stack.extend(node.sources)


def _validate_node(node: P.PlanNode, phase: str) -> None:
    out_types = node.output_types
    out_names = node.output_names
    if len(out_types) != len(out_names):
        _fail(node, "arity", phase,
              f"{len(out_types)} output_types vs {len(out_names)} "
              f"output_names")
    kind = type(node).__name__
    fn = _NODE_CHECKS.get(kind)
    if fn is not None:
        fn(node, phase)


def _check_channel(node: P.PlanNode, ch, src_types: Sequence, phase: str,
                   what: str) -> None:
    if not isinstance(ch, int) or not 0 <= ch < len(src_types):
        _fail(node, "key-range", phase,
              f"{what} channel {ch!r} out of range for source arity "
              f"{len(src_types)}")


def _check_expr(node: P.PlanNode, e: ir.Expr, src_types: Sequence,
                phase: str, what: str) -> None:
    """Every ColumnRef in range and type-consistent; Lambda bodies are
    element-scoped (their refs name lambda parameters) and are skipped,
    matching ir.referenced_channels."""
    if e is None:
        _fail(node, "missing-expr", phase, f"{what} is None")
    stack = [e]
    while stack:
        x = stack.pop()
        if isinstance(x, ir.Lambda):
            continue
        if isinstance(x, ir.OuterRef):
            _fail(node, "unresolved-outer-ref", phase,
                  f"{what} still holds {x!r} — decorrelation must rewrite "
                  "outer references into join criteria before execution")
        if isinstance(x, ir.ColumnRef):
            if not 0 <= x.index < len(src_types):
                _fail(node, "channel-range", phase,
                      f"{what} references channel {x.index} but the source "
                      f"has {len(src_types)} channels")
            if x.type != src_types[x.index]:
                _fail(node, "channel-type", phase,
                      f"{what} reads channel {x.index} as {x.type} but the "
                      f"source produces {src_types[x.index]}")
        stack.extend(x.children())


# --------------------------------------------------------- node checks


def _check_filter(node: P.FilterNode, phase: str) -> None:
    src = node.source.output_types
    _check_expr(node, node.predicate, src, phase, "predicate")
    if node.predicate.type != T.BOOLEAN:
        _fail(node, "predicate-type", phase,
              f"filter predicate typed {node.predicate.type}, not boolean")


def _check_project(node: P.ProjectNode, phase: str) -> None:
    if len(node.expressions) != len(node.names):
        _fail(node, "arity", phase,
              f"{len(node.expressions)} expressions vs {len(node.names)} "
              "names")
    src = node.source.output_types
    for i, e in enumerate(node.expressions):
        _check_expr(node, e, src, phase, f"expression {i}")


def _check_aggregation(node: P.AggregationNode, phase: str) -> None:
    src = node.source.output_types
    for c in node.group_channels:
        _check_channel(node, c, src, phase, "group")
    if node.step == "final":
        # final-step aggregates keep their ORIGINAL arg channels; the
        # executor slices the exchanged state columns positionally
        # (aggregate_final), so range checks against the remote source's
        # state layout would be both wrong and meaningless
        return
    for a in node.aggregates:
        if a.arg_channel is not None:
            _check_channel(node, a.arg_channel, src, phase,
                           f"aggregate {a.function} arg")
        if a.arg2_channel is not None:
            _check_channel(node, a.arg2_channel, src, phase,
                           f"aggregate {a.function} arg2")


def _check_join(node: P.JoinNode, phase: str) -> None:
    if len(node.left_keys or ()) != len(node.right_keys or ()):
        _fail(node, "key-arity", phase,
              f"{len(node.left_keys or ())} left keys vs "
              f"{len(node.right_keys or ())} right keys")
    for c in node.left_keys or ():
        _check_channel(node, c, node.left.output_types, phase, "left key")
    for c in node.right_keys or ():
        _check_channel(node, c, node.right.output_types, phase, "right key")
    if node.filter is not None:
        # the join filter evaluates over left ++ right channels (also for
        # semi/anti: semi_join_filtered expands matches before reducing)
        joint = node.left.output_types + node.right.output_types
        _check_expr(node, node.filter, joint, phase, "join filter")
        if node.filter.type != T.BOOLEAN:
            _fail(node, "predicate-type", phase,
                  f"join filter typed {node.filter.type}, not boolean")
    for i in node.dyn_filter_keys or ():
        if not 0 <= i < len(node.left_keys or ()):
            _fail(node, "key-range", phase,
                  f"dyn_filter_keys index {i} out of range for "
                  f"{len(node.left_keys or ())} join keys")


def _check_window(node: P.WindowNode, phase: str) -> None:
    src = node.source.output_types
    for c in node.partition_channels or ():
        _check_channel(node, c, src, phase, "partition")
    for c, _asc, _nf in node.order_channels or ():
        _check_channel(node, c, src, phase, "order")
    for call in node.calls:
        if call.arg_channel is not None:
            _check_channel(node, call.arg_channel, src, phase,
                           f"window {call.function} arg")
    if len(node.names or ()) != len(node.calls):
        _fail(node, "arity", phase,
              f"{len(node.calls)} window calls vs "
              f"{len(node.names or ())} appended names")


def _check_sorted(node, phase: str) -> None:
    src = node.source.output_types
    for c, _asc, _nf in node.sort_channels or ():
        _check_channel(node, c, src, phase, "sort")


def _check_exchange(node: P.ExchangeNode, phase: str) -> None:
    src = node.source.output_types
    for c in node.partition_channels or ():
        _check_channel(node, c, src, phase, "partition")


def _check_union(node: P.UnionNode, phase: str) -> None:
    width = len(node.sources_[0].output_types)
    for i, s in enumerate(node.sources_):
        st = s.output_types
        if len(st) != width:
            _fail(node, "union-alignment", phase,
                  f"branch {i} has {len(st)} channels, branch 0 has "
                  f"{width} — UNION ALL is positional")
        if st != node.sources_[0].output_types:
            _fail(node, "union-alignment", phase,
                  f"branch {i} types {st} differ from branch 0 "
                  f"{node.sources_[0].output_types}")


def _check_setop(node: P.SetOpNode, phase: str) -> None:
    lt, rt = node.left.output_types, node.right.output_types
    if len(lt) != len(rt):
        _fail(node, "union-alignment", phase,
              f"left has {len(lt)} channels, right has {len(rt)} — "
              "set operations are whole-row positional")


def _check_unnest(node: P.UnnestNode, phase: str) -> None:
    src = node.source.output_types
    for c in node.replicate_channels or ():
        _check_channel(node, c, src, phase, "replicate")
    for i, e in enumerate(node.unnest_exprs):
        _check_expr(node, e, src, phase, f"unnest expression {i}")
        if not isinstance(e.type, (T.ArrayType, T.MapType)):
            _fail(node, "predicate-type", phase,
                  f"unnest expression {i} typed {e.type}, not array/map")


def _check_values(node: P.ValuesNode, phase: str) -> None:
    width = len(node.types or ())
    for i, row in enumerate(node.rows or ()):
        if len(row) != width:
            _fail(node, "arity", phase,
                  f"row {i} has {len(row)} values for {width} columns")


def _check_scan(node: P.TableScanNode, phase: str) -> None:
    if len(node.column_names) != len(set(node.column_names)):
        _fail(node, "arity", phase,
              f"duplicate scan columns: {node.column_names}")


def _check_match_recognize(node: P.MatchRecognizeNode, phase: str) -> None:
    src = node.source.output_types
    for c in node.partition_channels or ():
        _check_channel(node, c, src, phase, "partition")
    for c, _asc, _nf in node.sort_channels or ():
        _check_channel(node, c, src, phase, "sort")
    if len(node.measure_types or ()) != len(node.measures or ()):
        _fail(node, "arity", phase,
              f"{len(node.measures or ())} measures vs "
              f"{len(node.measure_types or ())} measure types")


def _check_remote_source(node, phase: str) -> None:
    if node.types is None or node.names is None:
        _fail(node, "arity", phase, "RemoteSourceNode without types/names")


_NODE_CHECKS = {
    "FilterNode": _check_filter,
    "ProjectNode": _check_project,
    "AggregationNode": _check_aggregation,
    "JoinNode": _check_join,
    "WindowNode": _check_window,
    "SortNode": _check_sorted,
    "TopNNode": _check_sorted,
    "ExchangeNode": _check_exchange,
    "UnionNode": _check_union,
    "SetOpNode": _check_setop,
    "UnnestNode": _check_unnest,
    "ValuesNode": _check_values,
    "TableScanNode": _check_scan,
    "MatchRecognizeNode": _check_match_recognize,
    "RemoteSourceNode": _check_remote_source,
}


# ------------------------------------------------------------- fragments


def validate_fragments(fragments: List, phase: str = "fragmentation") -> None:
    """Fragment-level invariants (trino_tpu/sql/planner/sanity.py). The
    port runs the local path only and has no fragmenter."""
    raise NotImplementedError("plan fragments are not ported")
