"""Parser AST.

Reference: ``core/trino-parser/src/main/java/io/trino/sql/tree/`` (289 node
classes). This is the *parser* AST — distinct from the post-analysis IR in
``trino_tpu_torch.sql.ir``, mirroring the reference's AST/IR split. Round-1 scope:
the query surface TPC-H/TPC-DS need (SELECT/joins/subqueries/CTEs/CASE/
EXISTS/IN/aggregates/window-less) plus EXPLAIN.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class Node:
    pass


class Expression(Node):
    pass


class Relation(Node):
    pass


class Statement(Node):
    pass


# --- expressions -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Literal(Expression):
    kind: str  # 'number' | 'string' | 'boolean' | 'null' | 'date' | 'timestamp'
    value: object


@dataclasses.dataclass(frozen=True)
class IntervalLiteral(Expression):
    value: int
    unit: str  # 'year' | 'month' | 'day' | 'hour' | 'minute' | 'second'
    sign: int = 1


@dataclasses.dataclass(frozen=True)
class Identifier(Expression):
    parts: Tuple[str, ...]  # possibly qualified: (table, column) or (column,)

    @property
    def name(self) -> str:
        return self.parts[-1]


@dataclasses.dataclass(frozen=True)
class Star(Expression):
    qualifier: Optional[Tuple[str, ...]] = None  # t.* has qualifier ('t',)


@dataclasses.dataclass(frozen=True)
class FunctionCall(Expression):
    name: str
    args: Tuple[Expression, ...]
    distinct: bool = False
    is_star: bool = False  # count(*)


@dataclasses.dataclass(frozen=True)
class WindowFunction(Expression):
    """fn(args) OVER (PARTITION BY ... ORDER BY ... [frame]).

    Reference: sql/tree/WindowSpecification + FunctionCall.window. ``frame``
    is (mode, start_bound, end_bound) as lowercase strings, None = default
    (RANGE UNBOUNDED PRECEDING -> CURRENT ROW when ORDER BY present, whole
    partition otherwise)."""

    name: str
    args: Tuple[Expression, ...]
    partition_by: Tuple[Expression, ...] = ()
    order_by: Tuple["SortItem", ...] = ()
    is_star: bool = False  # count(*) over (...)
    frame: Optional[Tuple[str, str, str]] = None


@dataclasses.dataclass(frozen=True)
class Arithmetic(Expression):
    op: str  # + - * / %
    left: Expression
    right: Expression


@dataclasses.dataclass(frozen=True)
class Negative(Expression):
    value: Expression


@dataclasses.dataclass(frozen=True)
class Comparison(Expression):
    op: str  # = <> < <= > >=
    left: Expression
    right: Expression


@dataclasses.dataclass(frozen=True)
class LogicalBinary(Expression):
    op: str  # and | or
    left: Expression
    right: Expression


@dataclasses.dataclass(frozen=True)
class Not(Expression):
    value: Expression


@dataclasses.dataclass(frozen=True)
class IsNull(Expression):
    value: Expression
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Between(Expression):
    value: Expression
    low: Expression
    high: Expression
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InList(Expression):
    value: Expression
    items: Tuple[Expression, ...]
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InSubquery(Expression):
    value: Expression
    query: "Query"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Exists(Expression):
    query: "Query"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class ScalarSubquery(Expression):
    query: "Query"


@dataclasses.dataclass(frozen=True)
class Like(Expression):
    value: Expression
    pattern: Expression
    escape: Optional[Expression] = None
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class SearchedCase(Expression):
    whens: Tuple[Tuple[Expression, Expression], ...]
    default: Optional[Expression]


@dataclasses.dataclass(frozen=True)
class SimpleCase(Expression):
    operand: Expression
    whens: Tuple[Tuple[Expression, Expression], ...]
    default: Optional[Expression]


@dataclasses.dataclass(frozen=True)
class Cast(Expression):
    value: Expression
    type_name: str


@dataclasses.dataclass(frozen=True)
class Extract(Expression):
    field: str  # year month day quarter ...
    value: Expression


@dataclasses.dataclass(frozen=True)
class ArrayConstructor(Expression):
    items: Tuple[Expression, ...]


@dataclasses.dataclass(frozen=True)
class Lambda(Expression):
    """x -> expr (reference: sql/tree/LambdaExpression.java); valid only as
    an argument of the higher-order array functions."""

    params: Tuple[str, ...]
    body: Expression


@dataclasses.dataclass(frozen=True)
class Subscript(Expression):
    base: Expression
    index: Expression


@dataclasses.dataclass(frozen=True)
class AtTimeZone(Expression):
    """value AT TIME ZONE 'zone' (reference: grammar atTimeZone +
    DateTimeFunctions.timeZone*)."""

    value: Expression
    zone: str


# --- relations -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Table(Relation):
    parts: Tuple[str, ...]  # catalog.schema.table, schema.table, or table


@dataclasses.dataclass(frozen=True)
class AliasedRelation(Relation):
    relation: Relation
    alias: str
    column_aliases: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class Join(Relation):
    join_type: str  # inner | left | right | full | cross | implicit
    left: Relation
    right: Relation
    on: Optional[Expression] = None
    using: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class SubqueryRelation(Relation):
    query: "Query"


@dataclasses.dataclass(frozen=True)
class TableFunctionCall(Relation):
    """TABLE(fn(args...)) — polymorphic table function invocation
    (reference: sql/tree/TableFunctionInvocation + spi/function/table/)."""

    name: str
    args: Tuple[Expression, ...]
    named_args: dict = None

    def __hash__(self):  # dict field: hash by identity-relevant parts
        return hash((self.name, self.args, tuple(sorted(
            (self.named_args or {}).items(), key=lambda kv: kv[0]))))


@dataclasses.dataclass(frozen=True)
class MatchRecognize(Relation):
    """relation MATCH_RECOGNIZE (...) (reference: grammar
    patternRecognition + sql/tree/PatternRecognitionRelation). Subset:
    ONE ROW PER MATCH, AFTER MATCH SKIP PAST LAST ROW / TO NEXT ROW,
    concatenation patterns with ?/*/+ quantifiers."""

    input: Relation
    partition_by: Tuple[Expression, ...] = ()
    order_by: Tuple[Tuple[Expression, bool], ...] = ()  # (expr, ascending)
    measures: Tuple[Tuple[Expression, str], ...] = ()
    after_match: str = "past_last"  # past_last | next_row
    pattern: Tuple[Tuple[str, str], ...] = ()  # (variable, quantifier)
    defines: Tuple[Tuple[str, Expression], ...] = ()

    def __hash__(self):
        return hash((self.input, self.partition_by, self.pattern))


@dataclasses.dataclass(frozen=True)
class Unnest(Relation):
    """UNNEST(e1, e2, ...) [WITH ORDINALITY] — a lateral relation whose
    argument expressions may reference columns of the preceding FROM items.
    Reference: SqlBase.g4 unnest rule + RelationPlanner.visitUnnest."""

    exprs: Tuple[Expression, ...]
    ordinality: bool = False


# --- query structure -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SelectItem(Node):
    expr: Expression
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SortItem(Node):
    expr: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = default (last for asc, first for desc)


@dataclasses.dataclass(frozen=True)
class QuerySpec(Node):
    select_items: Tuple[SelectItem, ...]
    distinct: bool
    from_: Optional[Relation]
    where: Optional[Expression]
    group_by: Tuple[Expression, ...]
    having: Optional[Expression]
    # GROUPING SETS / ROLLUP / CUBE: a tuple of grouping sets (each a tuple
    # of expressions); the planner expands them (reference: GroupIdNode)
    grouping_sets: Optional[Tuple[Tuple[Expression, ...], ...]] = None


@dataclasses.dataclass(frozen=True)
class SetOperation(Node):
    op: str  # union | intersect | except
    all: bool
    left: "QueryBody"
    right: "QueryBody"


@dataclasses.dataclass(frozen=True)
class Values(Node):
    """VALUES (e, ...), ... as a query body (reference: sql/tree/Values)."""

    rows: Tuple[Tuple[Expression, ...], ...]


QueryBody = object  # QuerySpec | SetOperation | Values | Query (parenthesized)


@dataclasses.dataclass(frozen=True)
class WithQuery(Node):
    name: str
    query: "Query"
    column_aliases: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class Query(Statement):
    body: QueryBody
    with_queries: Tuple[WithQuery, ...] = ()
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Explain(Statement):
    statement: Statement
    analyze: bool = False
    mode: str = "logical"  # logical | distributed
    fmt: str = "text"
    # EXPLAIN ANALYZE VERBOSE: add device detail (output/peak bytes,
    # compile-cache disposition, spill counts) to the annotated plan
    verbose: bool = False


@dataclasses.dataclass(frozen=True)
class CreateTable(Statement):
    """CREATE TABLE name (col type, ...) (reference: sql/tree/CreateTable)."""

    name: tuple  # qualified name parts
    columns: tuple  # ((name, type_text), ...)
    not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateTableAs(Statement):
    """CREATE TABLE name AS query (reference: sql/tree/CreateTableAsSelect)."""

    name: tuple
    query: "Query" = None
    not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateMaterializedView(Statement):
    """CREATE [OR REPLACE] MATERIALIZED VIEW [IF NOT EXISTS] name AS query
    (reference: sql/tree/CreateMaterializedView + the connector SPI's
    getMaterializedView/MaterializedViewFreshness flow)."""

    name: tuple  # qualified name parts
    query: "Query" = None
    not_exists: bool = False
    or_replace: bool = False


@dataclasses.dataclass(frozen=True)
class RefreshMaterializedView(Statement):
    """REFRESH MATERIALIZED VIEW name (reference:
    sql/tree/RefreshMaterializedView + RefreshMaterializedViewTask)."""

    name: tuple


@dataclasses.dataclass(frozen=True)
class DropMaterializedView(Statement):
    name: tuple
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class Insert(Statement):
    """INSERT INTO name [(cols)] query (VALUES arrives as a Values query
    body; reference: sql/tree/Insert)."""

    name: tuple
    columns: tuple  # () = table order
    query: "Query" = None


@dataclasses.dataclass(frozen=True)
class DropTable(Statement):
    name: tuple
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class Delete(Statement):
    """DELETE FROM t [WHERE pred] (reference: sql/tree/Delete +
    execution via connector row-change machinery)."""

    name: tuple
    where: Expression = None


@dataclasses.dataclass(frozen=True)
class Update(Statement):
    """UPDATE t SET c = e, ... [WHERE pred] (reference: sql/tree/Update)."""

    name: tuple
    assignments: tuple  # ((column, Expression), ...)
    where: Expression = None


@dataclasses.dataclass(frozen=True)
class CreateFunction(Statement):
    """CREATE [OR REPLACE] FUNCTION name(p type, ...) RETURNS t RETURN expr
    (reference: sql/tree/CreateFunction + CreateFunctionTask)."""

    name: tuple
    params: tuple  # ((name, type string), ...)
    returns: str
    body: Expression
    or_replace: bool = False


@dataclasses.dataclass(frozen=True)
class DropFunction(Statement):
    name: tuple
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class Parameter(Expression):
    """A ``?`` placeholder in a prepared statement (reference:
    sql/tree/Parameter.java); bound at EXECUTE ... USING time."""

    index: int


@dataclasses.dataclass(frozen=True)
class Prepare(Statement):
    name: str
    statement: "Statement"


@dataclasses.dataclass(frozen=True)
class ExecutePrepared(Statement):
    name: str
    params: Tuple[Expression, ...] = ()


@dataclasses.dataclass(frozen=True)
class Deallocate(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class StartTransaction(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class Commit(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class Rollback(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class Call(Statement):
    """CALL catalog.schema.procedure(arg, ...) (reference: sql/tree/Call +
    execution/CallTask routing to the connector procedure SPI). Arguments
    must be constant expressions."""

    name: Tuple[str, ...]
    args: Tuple[Expression, ...] = ()


@dataclasses.dataclass(frozen=True)
class SetSession(Statement):
    """SET SESSION name = value (reference: sql/tree/SetSession.java)."""

    name: str
    value: object


@dataclasses.dataclass(frozen=True)
class ResetSession(Statement):
    name: str


@dataclasses.dataclass(frozen=True)
class ShowSession(Statement):
    pass


@dataclasses.dataclass(frozen=True)
class ShowTables(Statement):
    schema: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class ShowSchemas(Statement):
    catalog: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ShowColumns(Statement):
    table: Tuple[str, ...] = ()
