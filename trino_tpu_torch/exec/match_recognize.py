"""MATCH_RECOGNIZE: row pattern matching (host tier).

Reference: ``operator/window/pattern/`` (the IrRowPattern machine +
PatternRecognitionPartition) and ``sql/tree/PatternRecognitionRelation``.
Subset implemented: ONE ROW PER MATCH output (partition keys + measures),
AFTER MATCH SKIP PAST LAST ROW / SKIP TO NEXT ROW, concatenation patterns
with ?/*/+ quantifiers (greedy with backtracking), DEFINE predicates over
current-row columns, pattern-variable-qualified columns (LAST-row
semantics), PREV/NEXT(col[, n]) physical navigation, FIRST/LAST(var.col),
CLASSIFIER() and MATCH_NUMBER().

Execution is HOST-side over concrete rows (the eager tier): pattern
matching is inherently sequential/backtracking — the one operator family
whose inner loop does not vectorize onto the device. Partitions at this
operator are post-aggregation-scale; the distributed tier gathers into the
coordinator-local fragment first (fragmenter routes it like a SortNode).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.sql.parser import ast

MAX_BACKTRACK_STEPS = 1_000_000  # per-partition guard


class MatchError(ValueError):
    pass


@dataclasses.dataclass
class Ctx:
    rows: List[dict]  # partition rows (ordered), name -> python value
    i: int  # current row index under evaluation
    var: str  # variable being tested (classifier of the current row)
    assigns: List[Tuple[int, str]]  # rows matched so far (row_idx, var)
    match_number: int
    final: bool = False  # measures evaluate FINAL (whole match known)

    def rows_of(self, var: str) -> List[int]:
        return [r for r, v in self.assigns if v == var]


def _evaluate(e: ast.Expression, ctx: Ctx):
    """AST -> python value under pattern-matching semantics. NULL = None
    with SQL three-valued comparisons (None propagates)."""
    if isinstance(e, ast.Literal):
        from trino_tpu_torch.data.page import _from_repr
        from trino_tpu_torch.sql.analyzer.expr_analyzer import analyze_literal

        c = analyze_literal(e)
        if c.value is None:
            return None
        if c.type.is_varchar:
            return c.value
        return _from_repr(c.type, c.value)
    if isinstance(e, ast.Identifier):
        if len(e.parts) == 2:
            # var-qualified: value of the LAST row assigned to that
            # variable so far (reference: pattern navigation defaults)
            var, col = e.parts[0].lower(), e.parts[1].lower()
            rows = [r for r, v in ctx.assigns if v == var]
            if ctx.var == var and not ctx.final:
                rows = rows + [ctx.i]  # the row under test counts as var
            if not rows:
                return None
            return ctx.rows[rows[-1]].get(col)
        name = e.name.lower()
        return ctx.rows[ctx.i].get(name) if not ctx.final else (
            ctx.rows[ctx.assigns[-1][0]].get(name))
    if isinstance(e, ast.FunctionCall):
        name = e.name.lower()
        if name in ("prev", "next"):
            n = 1
            if len(e.args) == 2:
                n = int(_evaluate(e.args[1], ctx))
            base = ctx.i if not ctx.final else ctx.assigns[-1][0]
            j = base - n if name == "prev" else base + n
            if not 0 <= j < len(ctx.rows):
                return None
            inner = e.args[0]
            if isinstance(inner, ast.Identifier):
                return ctx.rows[j].get(inner.parts[-1].lower())
            sub = dataclasses.replace(ctx, i=j, final=False)
            return _evaluate(inner, sub)
        if name in ("first", "last"):
            inner = e.args[0]
            if not isinstance(inner, ast.Identifier):
                raise MatchError(f"{name}() expects a column reference")
            if len(inner.parts) == 2:
                var, col = inner.parts[0].lower(), inner.parts[1].lower()
                rows = ctx.rows_of(var)
                if ctx.var == var and not ctx.final:
                    rows = rows + [ctx.i]
            else:
                col = inner.name.lower()
                rows = [r for r, _ in ctx.assigns]
                if not ctx.final:
                    rows = rows + [ctx.i]
            if not rows:
                return None
            return ctx.rows[rows[0] if name == "first" else rows[-1]].get(col)
        if name == "classifier":
            if ctx.final:
                return ctx.assigns[-1][1].upper()
            return ctx.var.upper()
        if name == "match_number":
            return ctx.match_number
        if name == "abs":
            v = _evaluate(e.args[0], ctx)
            return None if v is None else abs(v)
        if name == "coalesce":
            for a in e.args:
                v = _evaluate(a, ctx)
                if v is not None:
                    return v
            return None
        raise MatchError(f"MATCH_RECOGNIZE: unsupported function {name}")
    if isinstance(e, ast.Arithmetic):
        a = _evaluate(e.left, ctx)
        b = _evaluate(e.right, ctx)
        if a is None or b is None:
            return None
        return {"+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b,
                "/": lambda: a / b, "%": lambda: a % b}[e.op]()
    if isinstance(e, ast.Negative):
        v = _evaluate(e.value, ctx)
        return None if v is None else -v
    if isinstance(e, ast.Comparison):
        a = _evaluate(e.left, ctx)
        b = _evaluate(e.right, ctx)
        if a is None or b is None:
            return None
        return {"=": a == b, "<>": a != b, "!=": a != b, "<": a < b,
                "<=": a <= b, ">": a > b, ">=": a >= b}[e.op]
    if isinstance(e, ast.LogicalBinary):
        a = _evaluate(e.left, ctx)
        b = _evaluate(e.right, ctx)
        if e.op == "and":
            if a is False or b is False:
                return False
            return None if a is None or b is None else True
        if a is True or b is True:
            return True
        return None if a is None or b is None else False
    if isinstance(e, ast.Not):
        v = _evaluate(e.value, ctx)
        return None if v is None else not v
    if isinstance(e, ast.IsNull):
        v = _evaluate(e.value, ctx)
        out = v is None
        return (not out) if e.negated else out
    if isinstance(e, ast.Between):
        v = _evaluate(e.value, ctx)
        lo = _evaluate(e.low, ctx)
        hi = _evaluate(e.high, ctx)
        if v is None or lo is None or hi is None:
            return None
        out = lo <= v <= hi
        return (not out) if e.negated else out
    raise MatchError(
        f"MATCH_RECOGNIZE: unsupported expression {type(e).__name__}")


def _pred_holds(defines: Dict[str, ast.Expression], var: str, ctx: Ctx) -> bool:
    pred = defines.get(var)
    if pred is None:
        return True  # undefined variable matches any row (spec)
    return _evaluate(pred, dataclasses.replace(ctx, var=var)) is True


def _match_at(rows, start: int, pattern, defines, match_number: int,
              budget: List[int]) -> Optional[List[Tuple[int, str]]]:
    """Greedy backtracking match of the quantified concatenation pattern
    anchored at ``start``; returns the row->variable assignment or None."""

    def rec(e_idx: int, row: int, assigns):
        budget[0] -= 1
        if budget[0] <= 0:
            raise MatchError("MATCH_RECOGNIZE backtracking budget exceeded")
        if e_idx == len(pattern):
            return assigns
        var, quant = pattern[e_idx]

        def holds(r):
            return r < len(rows) and _pred_holds(
                defines, var,
                Ctx(rows, r, var, assigns, match_number))

        if quant == "1":
            if holds(row):
                return rec(e_idx + 1, row + 1, assigns + [(row, var)])
            return None
        if quant == "?":
            if holds(row):
                out = rec(e_idx + 1, row + 1, assigns + [(row, var)])
                if out is not None:
                    return out
            return rec(e_idx + 1, row, assigns)
        # greedy * / +: consume as many as the predicate admits, then
        # backtrack down to the minimum count
        taken = []
        r = row
        while holds(r):
            taken.append((r, var))
            r += 1
        min_take = 1 if quant == "+" else 0
        for k in range(len(taken), min_take - 1, -1):
            out = rec(e_idx + 1, row + k, assigns + taken[:k])
            if out is not None:
                return out
        return None

    return rec(0, start, [])


def run_match_recognize(rows: List[dict], order_key, pattern, defines,
                        measures, after_match: str):
    """-> list of (assigns, measure python values) per match, over ONE
    partition (rows already restricted to it). ``order_key(row) -> tuple``
    orders the partition; measures evaluate FINAL."""
    rows = sorted(rows, key=order_key)
    defines = dict(defines)
    out = []
    budget = [MAX_BACKTRACK_STEPS]
    i = 0
    match_number = 1
    while i < len(rows):
        assigns = _match_at(rows, i, pattern, defines, match_number, budget)
        if assigns:
            ctx = Ctx(rows, assigns[-1][0], assigns[-1][1], assigns,
                      match_number, final=True)
            out.append(tuple(_evaluate(m, ctx) for m, _ in measures))
            match_number += 1
            if after_match == "past_last":
                i = assigns[-1][0] + 1
            else:  # next_row
                i = i + 1
        else:
            # no match anchored here (or an empty match): advance
            i += 1
    return out
