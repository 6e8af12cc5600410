"""Prepared statements: the server-side registry + the parameter machinery
(the port of trino_tpu/server/prepared.py).

Reference: ``execution/PrepareTask.java`` / ``sql/tree/Parameter`` +
``planner/ParameterRewriter`` — PREPARE stores the statement PARSED,
EXECUTE binds constant-folded ``USING`` values and runs it. The serving
twist: the *parameterized* statement plans ONCE into the coordinator's
logical-plan cache with symbolic ``ir.Parameter`` placeholders, and every
EXECUTE substitutes its bound constants into a copy of that cached plan —
so a repeated point query pays bind time (microseconds) instead of
parse+analyze+plan+optimize.

Keying contract: the plan-cache key fingerprints the parameterized SHAPE
(inner statement + the bound types — one entry serves all bindings of the
same type signature), while the result-cache key carries the bound values,
so every distinct binding caches its own rows. Access control holds per
principal: the plan cache partitions by user (``PlanCache.key_for``), so
plan-time permission checks re-fire for each identity.

The registry is server-global, keyed ``(user, name)`` — one user's
PREPARE is visible to their later connections (the serving analog of the
reference's session-held map, which the per-query throwaway sessions
cannot hold), never to other principals. Bounded LRU. The local session
keeps its own prepared statements (``Session.prepared_statements``).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.parser import ast


class PreparedStatementError(ValueError):
    pass


def count_parameters(stmt) -> int:
    """Number of ``?`` markers a parsed statement carries (max index + 1 —
    the parser numbers them left to right)."""
    highest = -1

    def visit(node):
        nonlocal highest
        if isinstance(node, ast.Parameter):
            highest = max(highest, node.index)
        elif isinstance(node, (tuple, list)):
            for x in node:
                visit(x)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                visit(getattr(node, f.name))

    visit(stmt)
    return highest + 1


@dataclasses.dataclass
class PreparedStatement:
    """One registered statement: the parsed inner AST plus bookkeeping the
    ``system.runtime.prepared_statements`` table surfaces."""

    user: str
    name: str
    statement: ast.Statement  # the inner (post-FROM) statement, parsed
    sql: str                  # inner statement text (display/debug)
    param_count: int
    created_at: float
    executions: int = 0
    last_executed_at: Optional[float] = None

    def plan_cache_sql(self, ptypes: Tuple) -> str:
        """The plan-cache key text for one type signature: the
        parameterized statement's canonical (repr) shape + the bound
        types. All bindings of one signature share ONE plan entry; a
        binding with different types plans its own (the analyzer inferred
        different expression types, so it IS a different plan)."""
        sig = ",".join(str(t) for t in ptypes)
        return f"EXECUTE::{self.sql.strip()}::types[{sig}]"


class PreparedStatementRegistry:
    """Server-wide LRU of prepared statements keyed ``(user, name)``.

    Bounded so an EXECUTE-less client loop cannot grow coordinator
    memory; eviction is LRU over PREPARE/EXECUTE touches, with a
    PER-USER sub-bound so one principal's PREPARE volume evicts its own
    oldest statements, never another user's live ones (the registry is
    shared state, like the query-history ring's grow-only clamp).
    Thread-safe: every query thread races through it."""

    MAX_STATEMENTS = 512
    MAX_PER_USER = 128

    def __init__(self, max_statements: int = MAX_STATEMENTS,
                 max_per_user: int = MAX_PER_USER):
        self.max_statements = max_statements
        self.max_per_user = max_per_user
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str], PreparedStatement]" = \
            OrderedDict()

    def _set_gauge(self) -> None:
        from trino_tpu_torch.obs import metrics as M

        M.PREPARED_STATEMENTS.set(len(self._entries))

    def put(self, user: str, name: str, statement: ast.Statement,
            sql: str) -> PreparedStatement:
        entry = PreparedStatement(
            user=user, name=name, statement=statement, sql=sql,
            param_count=count_parameters(statement),
            created_at=time.time())
        with self._lock:
            self._entries[(user, name)] = entry
            self._entries.move_to_end((user, name))
            # per-user bound first: the offender evicts its own oldest
            mine = [k for k in self._entries if k[0] == user]
            for k in mine[: max(0, len(mine) - self.max_per_user)]:
                del self._entries[k]
            while len(self._entries) > self.max_statements:
                self._entries.popitem(last=False)
            self._set_gauge()
        return entry

    def get(self, user: str, name: str) -> Optional[PreparedStatement]:
        with self._lock:
            entry = self._entries.get((user, name))
            if entry is not None:
                self._entries.move_to_end((user, name))
            return entry

    def remove(self, user: str, name: str) -> bool:
        with self._lock:
            found = self._entries.pop((user, name), None) is not None
            self._set_gauge()
            return found

    def touch(self, user: str, name: str) -> None:
        """Record one EXECUTE against the statement (executions counter +
        last-executed timestamp, read by the system table)."""
        with self._lock:
            entry = self._entries.get((user, name))
            if entry is not None:
                entry.executions += 1
                entry.last_executed_at = time.time()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> List[PreparedStatement]:
        """Newest-touched-last entry list."""
        with self._lock:
            return [dataclasses.replace(e) for e in self._entries.values()]


def fold_execute_args(params) -> List[ir.Constant]:
    """Constant-fold the EXECUTE ... USING expressions to typed values
    (reference: the reference engine requires EXECUTE arguments to be
    constant expressions; they analyze against an empty scope)."""
    from trino_tpu_torch.sql.analyzer.expr_analyzer import ExprAnalyzer
    from trino_tpu_torch.sql.analyzer.scope import Scope
    from trino_tpu_torch.sql.planner.planner import _fold_constant

    analyzer = ExprAnalyzer(Scope([], None))
    values: List[ir.Constant] = []
    for i, e in enumerate(params):
        c = _fold_constant(analyzer.analyze(e))
        if c is None:
            raise PreparedStatementError(
                f"EXECUTE parameter {i + 1} must be a constant expression")
        values.append(c)
    return values


def check_arity(prepared: PreparedStatement, values) -> None:
    if len(values) != prepared.param_count:
        raise PreparedStatementError(
            f"prepared statement '{prepared.name}' expects "
            f"{prepared.param_count} parameters, but EXECUTE supplied "
            f"{len(values)}")


def bind_plan_parameters(root, values: List[ir.Constant]):
    """Substitute bound constants for every ``ir.Parameter`` in the
    cached optimized plan (the ParameterRewriter analog, run on the plan
    IR instead of the AST so planning itself is skipped).

    Copy-on-write: only nodes on a path to a parameter are rebuilt
    (``dataclasses.replace`` with the original node id restored —
    ``replace`` would re-run the id factory and break the
    ``dynamic_filters`` join-id references and stats keying); every
    parameter-free subtree is SHARED with the cached plan, which is never
    mutated — bind cost scales with parameter count, not plan size.
    Sharing is safe because nothing executes a plan destructively: the
    local executors only read it and ``fragment_plan`` deepcopies before
    cutting. Types need no coercion here: the plan-cache key includes the
    binding's type signature, so a cached plan's parameter types always
    equal the bound constants' types by construction."""
    from trino_tpu_torch.sql.planner import plan as P

    def expr_has_param(e) -> bool:
        return any(isinstance(x, ir.Parameter) for x in ir.walk(e))

    def rewrite_expr(e):
        if isinstance(e, ir.Parameter):
            if e.index >= len(values):
                raise PreparedStatementError(
                    f"unbound parameter ?{e.index + 1}")
            return ir.Constant(e.type, values[e.index].value)
        if not expr_has_param(e):
            return e
        if isinstance(e, ir.Call):
            return ir.Call(e.type, e.name,
                           tuple(rewrite_expr(a) for a in e.args))
        if isinstance(e, ir.Case):
            return ir.Case(
                e.type,
                tuple((rewrite_expr(c), rewrite_expr(v))
                      for c, v in e.whens),
                rewrite_expr(e.default) if e.default is not None else None)
        if isinstance(e, ir.Cast):
            return ir.Cast(e.type, rewrite_expr(e.value))
        if isinstance(e, ir.Lambda):
            return ir.Lambda(e.type, rewrite_expr(e.body), e.n_params)
        return e

    def rewrite_value(v):
        if isinstance(v, ir.Expr):
            return rewrite_expr(v)
        if isinstance(v, P.PlanNode):
            return rebuild(v)
        if isinstance(v, list):
            nl = [rewrite_value(x) for x in v]
            return nl if any(a is not b for a, b in zip(nl, v)) else v
        if isinstance(v, tuple):
            nt = tuple(rewrite_value(x) for x in v)
            return nt if any(a is not b for a, b in zip(nt, v)) else v
        return v

    def rebuild(node):
        changes = {}
        for f in dataclasses.fields(node):
            if f.name == "id":
                continue
            v = getattr(node, f.name)
            nv = rewrite_value(v)
            if nv is not v:
                changes[f.name] = nv
        if not changes:
            return node
        new = dataclasses.replace(node, **changes)
        new.id = node.id  # keep plan-node identity (see docstring)
        return new

    return rebuild(root)


def plan_has_parameters(root) -> bool:
    """True when any expression in the plan still holds an
    ``ir.Parameter`` (tests + the bind pass's own sanity)."""
    from trino_tpu_torch.sql.planner import plan as P

    def expr_has(e) -> bool:
        return any(isinstance(x, ir.Parameter) for x in ir.walk(e))

    def value_has(v) -> bool:
        if isinstance(v, ir.Expr):
            return expr_has(v)
        if isinstance(v, (list, tuple)):
            return any(value_has(x) for x in v)
        return False

    for node in P.walk_plan(root):
        for f in dataclasses.fields(node):
            if f.name in ("id", "source", "left", "right", "sources_"):
                continue
            if value_has(getattr(node, f.name)):
                return True
    return False
