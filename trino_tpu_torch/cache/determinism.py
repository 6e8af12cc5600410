"""Determinism analysis: is a statement's result a pure function of its
inputs' data versions? (A copy of trino_tpu/cache/determinism.py.)

Reference: the reference engine tags every scalar function with
``@ScalarFunction(deterministic = ...)`` and plans consult
``isDeterministic`` before reusing expressions; here the same judgment
gates the result cache. A query is UNCACHABLE when it references:

- non-deterministic scalar functions (``random()``, ``now()``,
  ``current_timestamp``, ...) — their value varies per evaluation or per
  query, so a cached result would freeze them;
- table functions — they materialize rows AT PLAN TIME
  (planner._plan_table_function folds them into a ValuesNode), so the
  plan fingerprint cannot distinguish a re-invocation;
- anything that is not a plain SELECT (DML/DDL/session control bypass
  long before this pass runs).

The walk covers BOTH representations: the parsed AST (catches calls that
constant-fold away before the optimized plan — and table-function
invocations, which leave no plan node behind) and the optimized IR plan
(catches calls introduced by expansion, e.g. SQL routines whose bodies
mention ``random()``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.parser import ast
from trino_tpu_torch.sql.planner import plan as P

# canonical IR names AND surface spellings (the analyzer maps surface ->
# canonical, e.g. rand -> random; both sides appear here so the AST walk
# and the IR walk share one set)
NONDETERMINISTIC_FUNCTIONS = frozenset({
    "random", "rand", "now", "current_timestamp", "current_date",
    "current_time", "localtimestamp", "localtime", "uuid", "shuffle",
})

# the system catalog's tables materialize from LIVE coordinator state at
# scan time (connector/system/): two evaluations of the same plan see
# different rows by design, so any scan over it is non-deterministic —
# caught here IN ADDITION to the connector's None data_version (belt and
# braces: both independently keep these plans out of the result and plan
# caches)
LIVE_SYSTEM_CATALOG = "system"


def scans_live_table_reason(root: P.PlanNode) -> Optional[str]:
    """A reason string when the plan scans a live system table, else
    None."""
    for node in P.walk_plan(root):
        if isinstance(node, P.TableScanNode) \
                and node.catalog == LIVE_SYSTEM_CATALOG:
            return (f"live system table "
                    f"{node.catalog}.{node.schema}.{node.table}")
    return None


def _ast_reason(node) -> Optional[str]:
    """Generic dataclass-tree walk over the parser AST."""
    if isinstance(node, ast.FunctionCall) and \
            node.name in NONDETERMINISTIC_FUNCTIONS:
        return f"non-deterministic function {node.name}()"
    if isinstance(node, ast.TableFunctionCall):
        return f"table function {node.name}(...)"
    if isinstance(node, (tuple, list)):
        for x in node:
            r = _ast_reason(x)
            if r:
                return r
        return None
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            r = _ast_reason(getattr(node, f.name))
            if r:
                return r
    return None


def _expr_reason(e: ir.Expr) -> Optional[str]:
    for x in ir.walk(e):
        if isinstance(x, ir.Call) and x.name in NONDETERMINISTIC_FUNCTIONS:
            return f"non-deterministic function {x.name}()"
    return None


def _plan_reason(root: P.PlanNode) -> Optional[str]:
    """Walk every expression position of every plan node generically: any
    dataclass field holding ir.Expr values (directly, or inside
    lists/tuples like Case whens or window calls) is scanned."""
    for node in P.walk_plan(root):
        for f in dataclasses.fields(node):
            r = _value_reason(getattr(node, f.name))
            if r:
                return r
    return None


def _value_reason(v) -> Optional[str]:
    if isinstance(v, ir.Expr):
        return _expr_reason(v)
    if isinstance(v, (list, tuple)):
        for x in v:
            r = _value_reason(x)
            if r:
                return r
    return None


def contains_table_function(stmt) -> bool:
    """True when the statement invokes a table function. Distinct from
    full non-determinism: a plan holding ``random()`` re-draws on every
    EXECUTION (safe to reuse the plan, unsafe to reuse results), but a
    table function's rows freeze into a ValuesNode AT PLAN TIME — so the
    logical-plan cache must also refuse these."""

    def walk(node) -> bool:
        if isinstance(node, ast.TableFunctionCall):
            return True
        if isinstance(node, (tuple, list)):
            return any(walk(x) for x in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return any(walk(getattr(node, f.name))
                       for f in dataclasses.fields(node))
        return False

    return walk(stmt)


def uncachable_reason(stmt, root: Optional[P.PlanNode] = None) -> Optional[str]:
    """None when the statement is cacheable; otherwise a human-readable
    reason (surfaced as a span attribute on the cache/lookup span)."""
    if not isinstance(stmt, ast.Query):
        return f"not a SELECT ({type(stmt).__name__})"
    r = _ast_reason(stmt)
    if r:
        return r
    if root is not None:
        return scans_live_table_reason(root) or _plan_reason(root)
    return None
