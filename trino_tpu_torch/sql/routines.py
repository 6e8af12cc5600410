"""SQL routines (user-defined scalar functions): a copy of
trino_tpu/sql/routines.py.

Reference: ``sql/routine/SqlRoutineCompiler.java`` + the CREATE FUNCTION
task family (``execution/CreateFunctionTask``) — the reference compiles
routine ASTs to bytecode per call site. Here a scalar routine's body is
a SQL expression, so the "compiler" is CALL-SITE INLINING — every
invocation expands to the body AST with parameters substituted (wrapped
in casts to the declared types), then flows through the normal analyzer
and lowering like any other expression. No interpretation, no per-row
dispatch: an inlined routine runs as the same device ops as hand-written
SQL.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from trino_tpu_torch.sql.parser import ast

MAX_EXPANSION_DEPTH = 16  # recursion guard (reference: routines are non-recursive)


@dataclasses.dataclass(frozen=True)
class UdfDef:
    """One registered scalar routine."""

    name: str
    params: Tuple[Tuple[str, str], ...]  # (param name, type string)
    returns: str  # type string
    body: ast.Expression


class RoutineError(ValueError):
    pass


def validate(udf: UdfDef) -> None:
    """CREATE-time validation: the body must analyze against a scope of
    exactly the declared parameters (catches unknown columns/functions
    before any query uses the routine — CreateFunctionTask's analysis)."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.sql.analyzer.expr_analyzer import ExprAnalyzer
    from trino_tpu_torch.sql.analyzer.scope import Field, Scope

    fields = [Field(p, T.parse_type(t), None) for p, t in udf.params]
    out = ExprAnalyzer(Scope(fields, None)).analyze(udf.body)
    ret = T.parse_type(udf.returns)
    if T.common_super_type(out.type, ret) is None:
        raise RoutineError(
            f"function {udf.name} body type {out.type} does not coerce to "
            f"declared RETURNS {ret}")


# --------------------------------------------------------- AST expansion


def _rewrite_value(v, fn):
    if isinstance(v, tuple):
        return tuple(_rewrite_value(x, fn) for x in v)
    if isinstance(v, list):
        return [_rewrite_value(x, fn) for x in v]
    if isinstance(v, dict):  # e.g. TableFunctionCall.named_args
        return {k: _rewrite_value(x, fn) for k, x in v.items()}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _rewrite_node(v, fn)
    return v


def _rewrite_node(node, fn):
    """Generic bottom-up rewrite over the frozen AST dataclasses."""
    changed = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        nv = _rewrite_value(v, fn)
        if nv is not v and nv != v:
            changed[f.name] = nv
    out = dataclasses.replace(node, **changed) if changed else node
    if isinstance(out, ast.Expression):
        return fn(out)
    return out


def _substitute_params(body: ast.Expression, mapping: Dict[str, ast.Expression]):
    def sub(e: ast.Expression):
        if isinstance(e, ast.Identifier) and len(e.parts) == 1 \
                and e.name.lower() in mapping:
            return mapping[e.name.lower()]
        return e

    return _rewrite_node(body, sub)


def expand_udfs(stmt, udfs: Dict[str, UdfDef], depth: int = 0):
    """Inline every registered-routine call in ``stmt`` (any AST node).
    Nested routine calls expand recursively up to MAX_EXPANSION_DEPTH."""
    if not udfs:
        return stmt
    if depth > MAX_EXPANSION_DEPTH:
        raise RoutineError("function expansion too deep (recursive routine?)")

    def expand_call(e: ast.Expression):
        if not isinstance(e, ast.FunctionCall):
            return e
        udf = udfs.get(e.name.lower())
        if udf is None:
            return e
        if len(e.args) != len(udf.params):
            raise RoutineError(
                f"function {udf.name} expects {len(udf.params)} arguments, "
                f"got {len(e.args)}")
        mapping = {
            p.lower(): ast.Cast(arg, t)  # coerce args to declared types
            for (p, t), arg in zip(udf.params, e.args)
        }
        inlined = _substitute_params(udf.body, mapping)
        # the body may itself call routines
        inlined = expand_udfs(inlined, udfs, depth + 1)
        return ast.Cast(inlined, udf.returns)

    return _rewrite_node(stmt, expand_call)
