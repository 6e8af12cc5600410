"""Post-analysis expression IR.

Reference: ``core/trino-main/.../sql/ir/`` — Trino keeps a small rowful
expression IR distinct from the parser AST (Call, Case, Cast, Comparison,
Constant, Reference, Logical, ...). Ours mirrors that scope; analysis resolves
parser AST names into ``ColumnRef`` channel indices and all operators into
``Call`` by canonical function name. The IR lowers to jax in
``trino_tpu_torch.ops.expr_lower`` (the role played by
``sql/gen/ExpressionCompiler.java`` + ``PageFunctionCompiler.java`` in the
reference — there bytecode, here traced XLA).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T


class Expr:
    type: T.Type

    def children(self) -> Sequence["Expr"]:
        return ()


@dataclasses.dataclass(frozen=True)
class Constant(Expr):
    """A literal. ``value`` is a Python value (int/float/bool/str/None).

    Dates are epoch days (int), decimals scaled ints, varchar a Python str
    (encoded to dictionary codes at lowering time, when the input columns'
    dictionaries are known).
    """

    type: T.Type
    value: Any

    def __repr__(self):
        return f"Const({self.value!r}:{self.type})"


@dataclasses.dataclass(frozen=True)
class ColumnRef(Expr):
    """Reference to channel ``index`` of the operator's input page."""

    type: T.Type
    index: int
    name: str = ""  # debug only

    def __repr__(self):
        return f"#{self.index}:{self.name or self.type}"


@dataclasses.dataclass(frozen=True)
class Lambda(Expr):
    """A lambda argument of a higher-order array function (reference:
    sql/ir LambdaExpression). ``body`` is analyzed in an element scope where
    ColumnRef(0..n_params-1) are the lambda parameters; the lowering
    evaluates it over the FLATTENED child column(s)."""

    type: T.Type  # body's type
    body: "Expr" = None
    n_params: int = 1

    def children(self):
        return (self.body,)

    def __repr__(self):
        return f"Lambda({self.body!r})"


@dataclasses.dataclass(frozen=True)
class Parameter(Expr):
    """A prepared-statement parameter placeholder (reference: sql/ir
    Constant's role in planner/ParameterRewriter, kept SYMBOLIC here).

    Carries the type inferred from the first EXECUTE's binding so the
    whole analyzer/optimizer pipeline type-checks normally, but no
    optimizer pass treats it as a constant — the value must not bake into
    the cached plan (no constant folding, no pushdown into scan
    constraints). ``server/prepared.bind_plan_parameters`` substitutes a
    ``Constant`` per EXECUTE; an unbound parameter reaching the executor's
    lowering fails loudly (expr_lower has no case for it, by design)."""

    type: T.Type
    index: int

    def __repr__(self):
        return f"?{self.index}:{self.type}"


@dataclasses.dataclass(frozen=True)
class OuterRef(Expr):
    """Correlated reference to channel ``index`` of the OUTER query's scope.

    Appears only transiently during subquery planning; decorrelation
    (reference: sql/planner/iterative/rule/ correlated-subquery rules)
    rewrites it into join criteria before execution.
    """

    type: T.Type
    index: int
    name: str = ""

    def __repr__(self):
        return f"outer#{self.index}:{self.name or self.type}"


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    """Scalar function / operator call by canonical name.

    Canonical names: add sub mul div mod negate, eq ne lt le gt ge,
    and or not, is_null, between, in_list, like, coalesce, nullif,
    extract_year extract_month extract_day, date_add_months, abs, ...
    (registry: trino_tpu_torch.ops.functions.FUNCTIONS).
    """

    type: T.Type
    name: str
    args: Tuple[Expr, ...]

    def children(self):
        return self.args

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    """CASE WHEN c1 THEN v1 ... ELSE d END (searched form)."""

    type: T.Type
    whens: Tuple[Tuple[Expr, Expr], ...]
    default: Optional[Expr]

    def children(self):
        out: List[Expr] = []
        for c, v in self.whens:
            out += [c, v]
        if self.default is not None:
            out.append(self.default)
        return out

    def __repr__(self):
        parts = " ".join(f"WHEN {c!r} THEN {v!r}" for c, v in self.whens)
        return f"CASE {parts} ELSE {self.default!r} END"


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    type: T.Type
    value: Expr

    def children(self):
        return (self.value,)

    def __repr__(self):
        return f"cast({self.value!r} as {self.type})"


def walk(e: Expr):
    yield e
    for c in e.children():
        yield from walk(c)


def referenced_channels(e: Expr) -> List[int]:
    """Input channels an expression reads. Lambda bodies are element-scoped
    — their ColumnRefs name lambda parameters, not input channels — so the
    walk does not descend into them."""
    out = set()

    def visit(x: Expr):
        if isinstance(x, Lambda):
            return
        if isinstance(x, ColumnRef):
            out.add(x.index)
        for c in x.children():
            visit(c)

    visit(e)
    return sorted(out)


def remap_channels(e: Expr, mapping: dict) -> Expr:
    """Rewrite ColumnRef indices through ``mapping`` (for projection
    pushdown). Lambda bodies are element-scoped and pass through unchanged."""
    if isinstance(e, Lambda):
        return e
    if isinstance(e, ColumnRef):
        return ColumnRef(e.type, mapping[e.index], e.name)
    if isinstance(e, Call):
        return Call(e.type, e.name, tuple(remap_channels(a, mapping) for a in e.args))
    if isinstance(e, Case):
        return Case(
            e.type,
            tuple((remap_channels(c, mapping), remap_channels(v, mapping)) for c, v in e.whens),
            remap_channels(e.default, mapping) if e.default is not None else None,
        )
    if isinstance(e, Cast):
        return Cast(e.type, remap_channels(e.value, mapping))
    return e
