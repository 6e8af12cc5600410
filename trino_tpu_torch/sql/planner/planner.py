"""AST -> logical plan.

Reference: ``core/trino-main/.../sql/planner/LogicalPlanner.java:167`` +
``QueryPlanner``/``RelationPlanner`` — plans relations, predicates,
aggregations, sorts; subqueries are decorrelated into semi/anti joins or
single-row cross joins (the role of Trino's ApplyNode + correlated-subquery
rewrite rules, done here directly at planning time).

Join planning for implicit (comma) joins builds the join from WHERE equi
conjuncts greedily in FROM order — the CBO join-reordering pass
(reference ReorderJoins) refines this in the optimizer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.analyzer.expr_analyzer import (
    AGGREGATE_FUNCTIONS,
    AnalysisError,
    ExprAnalyzer,
    WINDOW_ONLY_FUNCTIONS,
    aggregate_result_type,
    find_aggregates,
    find_windows,
    window_result_type,
)
from trino_tpu_torch.sql.analyzer.scope import Field, Scope
from trino_tpu_torch.sql.parser import ast
from trino_tpu_torch.sql.planner import plan as P


class PlanningError(ValueError):
    pass


@dataclasses.dataclass
class RelationPlan:
    node: P.PlanNode
    scope: Scope


def split_conjuncts(e: Optional[ast.Expression]) -> List[ast.Expression]:
    if e is None:
        return []
    if isinstance(e, ast.LogicalBinary) and e.op == "and":
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def ir_conjuncts(e: Optional[ir.Expr]) -> List[ir.Expr]:
    if e is None:
        return []
    if isinstance(e, ir.Call) and e.name == "and":
        return ir_conjuncts(e.args[0]) + ir_conjuncts(e.args[1])
    return [e]


def combine_conjuncts(parts: Sequence[ir.Expr]) -> Optional[ir.Expr]:
    out = None
    for p in parts:
        out = p if out is None else ir.Call(T.BOOLEAN, "and", (out, p))
    return out


def decorrelate_to_joint(e: ir.Expr, nleft: int) -> ir.Expr:
    """Rewrite an expression analyzed in an inner scope (OuterRefs to the
    outer query) onto the joint channel space of a join: OuterRef(i) ->
    channel i, inner ColumnRef(j) -> channel nleft + j."""
    if isinstance(e, ir.OuterRef):
        return ir.ColumnRef(e.type, e.index, e.name)
    if isinstance(e, ir.ColumnRef):
        return ir.ColumnRef(e.type, nleft + e.index, e.name)
    if isinstance(e, ir.Call):
        return ir.Call(e.type, e.name, tuple(decorrelate_to_joint(a, nleft) for a in e.args))
    if isinstance(e, ir.Case):
        return ir.Case(
            e.type,
            tuple(
                (decorrelate_to_joint(c, nleft), decorrelate_to_joint(v, nleft))
                for c, v in e.whens
            ),
            decorrelate_to_joint(e.default, nleft) if e.default is not None else None,
        )
    if isinstance(e, ir.Cast):
        return ir.Cast(e.type, decorrelate_to_joint(e.value, nleft))
    return e


class Planner:
    def __init__(self, session):
        self.session = session
        self.catalogs = session.catalogs
        self.default_catalog = session.properties.get("catalog", "tpch")
        self.default_schema = session.properties.get("schema", "tiny")

    # ------------------------------------------------------------------ api
    def plan(self, query: ast.Query) -> P.OutputNode:
        rp = self.plan_query(query, outer_scope=None, ctes={})
        return P.OutputNode(rp.node, [f.name or f"_col{i}" for i, f in enumerate(rp.scope.fields)])

    # ------------------------------------------------------------- relations
    def plan_query(
        self, query: ast.Query, outer_scope: Optional[Scope], ctes: Dict[str, ast.WithQuery]
    ) -> RelationPlan:
        ctes = dict(ctes)
        for wq in query.with_queries:
            ctes[wq.name.lower()] = wq
        body = query.body
        if isinstance(body, ast.Values):
            vp = self._plan_values(body, outer_scope)
            node = vp.node
            if query.order_by:
                raise PlanningError("ORDER BY on VALUES: not yet supported")
            if query.limit is not None:
                node = P.LimitNode(node, query.limit)
            return RelationPlan(node, vp.scope)
        if isinstance(body, ast.SetOperation):
            sp = self._plan_set_operation(body, outer_scope, ctes)
            node = sp.node
            if query.order_by:
                node = self._plan_order_by(
                    query, node, sp.scope, replacements={}, select_asts=[],
                )
            if query.limit is not None:
                if isinstance(node, P.SortNode):
                    node = P.TopNNode(node.source, query.limit, node.sort_channels)
                else:
                    node = P.LimitNode(node, query.limit)
            return RelationPlan(node, sp.scope)
        if isinstance(body, ast.Query):
            inner = self.plan_query(body, outer_scope, ctes)
            body_plan = inner
        else:
            body_plan = self.plan_query_spec(body, outer_scope, ctes, query)
            return body_plan  # ORDER BY/LIMIT handled inside (needs agg scope)
        # parenthesized query: apply outer ORDER BY/LIMIT
        node = body_plan.node
        if query.order_by:
            raise PlanningError("ORDER BY on parenthesized query: not yet supported")
        if query.limit is not None:
            node = P.LimitNode(node, query.limit)
        return RelationPlan(node, body_plan.scope)

    def _plan_set_operation(
        self, body: ast.SetOperation, outer_scope, ctes
    ) -> RelationPlan:
        """UNION [ALL] / INTERSECT / EXCEPT (reference:
        SetOperationNodeTranslator): sides unify per-column to the common
        super type (cast projections inserted); UNION distinct = UnionNode +
        grouping aggregation; INTERSECT/EXCEPT = whole-row SetOpNode."""
        left = self._plan_body(body.left, outer_scope, ctes)
        right = self._plan_body(body.right, outer_scope, ctes)
        lf, rf = left.scope.fields, right.scope.fields
        if len(lf) != len(rf):
            raise PlanningError(
                f"set operation column counts differ: {len(lf)} vs {len(rf)}")
        types = []
        for i, (a, b) in enumerate(zip(lf, rf)):
            t = T.common_super_type(a.type, b.type)
            if t is None:
                raise PlanningError(
                    f"set operation column {i}: incompatible types {a.type} / {b.type}")
            types.append(t)
        names = [f.name or f"_col{i}" for i, f in enumerate(lf)]
        lnode = _cast_to(left.node, types, names)
        rnode = _cast_to(right.node, types, names)
        if body.op == "union":
            node: P.PlanNode = P.UnionNode(sources_=[lnode, rnode], names=names)
            if not body.all:
                node = P.AggregationNode(
                    node, list(range(len(types))), [], step="single", names=names)
        else:
            if body.all:
                raise PlanningError(f"{body.op.upper()} ALL: not yet supported")
            node = P.SetOpNode(op=body.op, left=lnode, right=rnode)
        fields = [Field(n, t, None) for n, t in zip(names, types)]
        return RelationPlan(node, Scope(fields, outer_scope))

    def _plan_body(self, body, outer_scope, ctes) -> RelationPlan:
        """Plan one side of a set operation (QuerySpec / nested set op /
        Values / parenthesized Query)."""
        if isinstance(body, ast.SetOperation):
            return self._plan_set_operation(body, outer_scope, ctes)
        if isinstance(body, ast.Values):
            return self._plan_values(body, outer_scope)
        if isinstance(body, ast.Query):
            return self.plan_query(body, outer_scope, ctes)
        if isinstance(body, ast.QuerySpec):
            return self.plan_query_spec(
                body, outer_scope, ctes,
                ast.Query(body=body, with_queries=(), order_by=(), limit=None),
            )
        raise PlanningError(f"unsupported set operation operand: {type(body).__name__}")

    def _plan_values(self, body: ast.Values, outer_scope: Optional[Scope]) -> RelationPlan:
        """VALUES rows -> ValuesNode (reference: sql/tree/Values +
        QueryPlanner.planValues). Rows are constant-folded; per-column types
        unify to the common super type."""
        from trino_tpu_torch.data.page import _from_repr
        from trino_tpu_torch.sql.analyzer.expr_analyzer import ExprAnalyzer

        analyzer = ExprAnalyzer(Scope([], outer_scope))
        ir_rows = []
        width = None
        for row in body.rows:
            if width is None:
                width = len(row)
            elif len(row) != width:
                raise PlanningError("VALUES rows have mismatched column counts")
            ir_rows.append([analyzer.analyze(e) for e in row])
        types = []
        for ci in range(width or 0):
            t = T.UNKNOWN
            for r in ir_rows:
                t2 = T.common_super_type(t, r[ci].type)
                if t2 is None:
                    raise PlanningError(
                        f"VALUES column {ci}: incompatible types {t} and {r[ci].type}")
                t = t2
            types.append(t if t != T.UNKNOWN else T.BIGINT)
        py_rows = []
        for r in ir_rows:
            vals = []
            for ci, e in enumerate(r):
                c = _fold_constant(e)
                if c is None:
                    raise PlanningError("VALUES expressions must be constants")
                if c.value is None:
                    vals.append(None)
                elif types[ci].is_varchar or types[ci] == T.BOOLEAN:
                    vals.append(c.value)  # repr == Python value
                else:
                    vals.append(_from_repr(types[ci], _rescale(c, types[ci])))
            py_rows.append(tuple(vals))
        names = [f"_col{i}" for i in range(width or 0)]
        node = P.ValuesNode(types, names, py_rows)
        return RelationPlan(node, Scope([Field(n, t, None) for n, t in zip(names, types)], outer_scope))

    def plan_relation(
        self, rel: ast.Relation, outer_scope: Optional[Scope], ctes: Dict[str, ast.WithQuery]
    ) -> RelationPlan:
        if isinstance(rel, ast.Table):
            name = rel.parts[-1].lower()
            if len(rel.parts) == 1 and name in ctes:
                wq = ctes[name]
                sub = self.plan_query(wq.query, outer_scope, ctes)
                names = (
                    list(wq.column_aliases)
                    if wq.column_aliases
                    else [f.name for f in sub.scope.fields]
                )
                fields = [
                    Field(n, f.type, wq.name) for n, f in zip(names, sub.scope.fields)
                ]
                return RelationPlan(sub.node, Scope(fields, outer_scope))
            mv_plan = self._plan_matview(rel, outer_scope)
            if mv_plan is not None:
                return mv_plan
            return self.plan_table_scan(rel, outer_scope)
        if isinstance(rel, ast.AliasedRelation):
            inner = self.plan_relation(rel.relation, outer_scope, ctes)
            names = (
                list(rel.column_aliases)
                if rel.column_aliases
                else [f.name for f in inner.scope.fields]
            )
            fields = [Field(n, f.type, rel.alias) for n, f in zip(names, inner.scope.fields)]
            return RelationPlan(inner.node, Scope(fields, outer_scope))
        if isinstance(rel, ast.SubqueryRelation):
            sub = self.plan_query(rel.query, outer_scope, ctes)
            fields = [Field(f.name, f.type, None) for f in sub.scope.fields]
            return RelationPlan(sub.node, Scope(fields, outer_scope))
        if isinstance(rel, ast.Join):
            return self.plan_join(rel, outer_scope, ctes)
        if isinstance(rel, ast.Unnest):
            # standalone FROM UNNEST(...): constant arguments, one dummy row
            return self.plan_unnest(
                rel, RelationPlan(P.ValuesNode([], [], [()]), Scope([], outer_scope)),
                None, None, outer_scope,
            )
        if isinstance(rel, ast.TableFunctionCall):
            return self._plan_table_function(rel, outer_scope)
        if isinstance(rel, ast.MatchRecognize):
            return self._plan_match_recognize(rel, outer_scope, ctes)
        raise PlanningError(f"unsupported relation {type(rel).__name__}")

    def _plan_match_recognize(self, rel: "ast.MatchRecognize", outer_scope,
                              ctes) -> RelationPlan:
        """MATCH_RECOGNIZE -> MatchRecognizeNode. Partition/order resolve
        to input channels; DEFINE/MEASURES stay AST for the host matcher
        but are TYPE-checked here by stripping pattern navigation
        (PREV/FIRST/... -> argument, var-qualifiers -> bare columns) and
        analyzing against the input scope — typos fail at plan time."""
        from trino_tpu_torch.sql.routines import _rewrite_node

        inner = self.plan_relation(rel.input, outer_scope, ctes)
        analyzer = ExprAnalyzer(inner.scope)

        def channel(e: ast.Expression, what: str) -> int:
            out = analyzer.analyze(e)
            if not isinstance(out, ir.ColumnRef):
                raise PlanningError(
                    f"MATCH_RECOGNIZE {what} must be an input column")
            return out.index

        part = [channel(e, "PARTITION BY") for e in rel.partition_by]
        order = [(channel(e, "ORDER BY"), asc, None)
                 for e, asc in rel.order_by]
        pattern_vars = {v for v, _ in rel.pattern}
        for v, _ in rel.defines:
            if v not in pattern_vars:
                raise PlanningError(f"DEFINE {v} not in PATTERN")

        def strip(e: ast.Expression) -> ast.Expression:
            def fn(x):
                if isinstance(x, ast.Identifier) and len(x.parts) == 2 \
                        and x.parts[0].lower() in pattern_vars:
                    return ast.Identifier((x.parts[1],))
                if isinstance(x, ast.FunctionCall):
                    n = x.name.lower()
                    if n in ("prev", "next", "first", "last") and x.args:
                        return x.args[0]
                    if n == "classifier":
                        return ast.Literal("string", "X")
                    if n == "match_number":
                        return ast.Literal("number", "1")
                return x

            return _rewrite_node(e, fn)

        measure_types = []
        for e, _name in rel.measures:
            measure_types.append(analyzer.analyze(strip(e)).type)
        for _v, pred in rel.defines:
            analyzer.analyze(strip(pred))  # column/type validation only
        node = P.MatchRecognizeNode(
            source=inner.node, partition_channels=part, sort_channels=order,
            pattern=tuple(rel.pattern), defines=tuple(rel.defines),
            measures=tuple(rel.measures), measure_types=measure_types,
            after_match=rel.after_match,
            input_names=[f.name for f in inner.scope.fields])
        fields = [Field(n, t, None)
                  for n, t in zip(node.output_names, node.output_types)]
        return RelationPlan(node, Scope(fields, outer_scope))

    def _plan_table_function(self, rel: "ast.TableFunctionCall", outer_scope
                             ) -> RelationPlan:
        """TABLE(fn(...)) -> constant relation (reference:
        sql/tree/TableFunctionInvocation; the processor runs at plan time —
        arguments must be constants)."""
        from trino_tpu_torch.exec.table_functions import resolve

        analyzer = ExprAnalyzer(Scope([], outer_scope))

        def const(e):
            c = _fold_constant(analyzer.analyze(e))
            if c is None:
                raise PlanningError(
                    f"table function {rel.name} arguments must be constants")
            return c.value

        args = [const(e) for e in rel.args]
        named = {k: const(v) for k, v in (rel.named_args or {}).items()}
        names, types, rows = resolve(self.session, rel.name, args, named)
        node = P.ValuesNode(list(types), list(names), rows)
        return RelationPlan(
            node, Scope([Field(n, t, rel.name) for n, t in zip(names, types)],
                        outer_scope))

    def plan_unnest(
        self, rel: ast.Unnest, left: RelationPlan, alias, col_aliases, outer_scope
    ) -> RelationPlan:
        """Lateral UNNEST: argument expressions resolve against the columns
        of the preceding FROM items (reference: RelationPlanner.visitUnnest +
        planUnnest in QueryPlanner)."""
        analyzer = ExprAnalyzer(left.scope)
        exprs = [analyzer.analyze(e) for e in rel.exprs]
        for e in exprs:
            if not (e.type.is_array or e.type.is_map):
                raise PlanningError(f"UNNEST argument must be array or map, got {e.type}")
        node = P.UnnestNode(
            source=left.node, unnest_exprs=exprs, ordinality=rel.ordinality
        )
        produced = node.output_types[len(left.node.output_types):]
        default_names = node.output_names[len(left.node.output_names):]
        names = list(col_aliases) if col_aliases else default_names
        if len(names) < len(produced):
            names = names + default_names[len(names):]
        unnest_fields = [
            Field(n, t, alias) for n, t, in zip(names, produced)
        ]
        return RelationPlan(node, Scope(left.scope.fields + unnest_fields, outer_scope))

    def _plan_matview(self, rel: ast.Table, outer_scope: Optional[Scope]
                      ) -> Optional[RelationPlan]:
        """FROM <materialized view name>: expand the registered
        definition like a view (reference: view expansion in
        StatementAnalyzer + getMaterializedView). Always correct —
        freshness is irrelevant to an inline expansion — and the
        expanded plan then flows through the transparent substitution
        pass (trino_tpu/matview/substitute.py), which rewrites it into a
        storage-table scan exactly when the view is fresh. A connector
        table of the same resolved name wins (the registry never
        shadows real tables); plan-time access control on the base
        tables fires inside the expansion for the CURRENT principal."""
        registry = getattr(self.session, "matviews", None)
        if registry is None or registry.empty():
            return None
        parts = [p.lower() for p in rel.parts]
        if len(parts) == 1:
            catalog, schema, name = (self.default_catalog,
                                     self.default_schema, parts[0])
        elif len(parts) == 2:
            catalog, schema, name = self.default_catalog, parts[0], parts[1]
        elif len(parts) == 3:
            catalog, schema, name = parts
        else:
            return None
        mv = registry.get(catalog, schema, name)
        if mv is None:
            return None
        conn = self.catalogs.get(catalog)
        try:
            if conn is not None and conn.get_table(schema, name) is not None:
                return None  # a real table always wins over the registry
        except Exception:  # noqa: BLE001 — metadata probe only
            pass
        expanding = getattr(self, "_mv_expanding", None)
        if expanding is None:
            expanding = self._mv_expanding = set()
        key = (catalog, schema, name)
        if key in expanding:
            raise PlanningError(
                f"materialized view cycle detected at {mv.qualified}")
        stmt = mv.definition
        udfs = getattr(self.session, "udfs", None)
        if udfs:
            from trino_tpu_torch.sql.routines import expand_udfs

            stmt = expand_udfs(stmt, udfs)
        expanding.add(key)
        # the definition's unqualified names keep resolving against the
        # CREATOR's defaults, whatever session expands the view
        saved = (self.default_catalog, self.default_schema)
        self.default_catalog = mv.default_catalog
        self.default_schema = mv.default_schema
        try:
            sub = self.plan_query(stmt, outer_scope, {})
        finally:
            self.default_catalog, self.default_schema = saved
            expanding.discard(key)
        fields = [Field(f.name, f.type, name) for f in sub.scope.fields]
        return RelationPlan(sub.node, Scope(fields, outer_scope))

    def plan_table_scan(self, rel: ast.Table, outer_scope: Optional[Scope]) -> RelationPlan:
        parts = [p.lower() for p in rel.parts]
        if len(parts) == 1:
            catalog, schema, table = self.default_catalog, self.default_schema, parts[0]
        elif len(parts) == 2:
            catalog, schema, table = self.default_catalog, parts[0], parts[1]
        elif len(parts) == 3:
            catalog, schema, table = parts
        else:
            raise PlanningError(f"bad table name {'.'.join(rel.parts)}")
        conn = self.catalogs.get(catalog)
        if conn is None:
            raise PlanningError(f"catalog not found: {catalog}")
        if schema == "information_schema":
            return self._plan_information_schema(catalog, conn, table, outer_scope)
        meta = conn.get_table(schema, table)
        if meta is None and len(parts) == 2 and parts[0] in self.catalogs:
            # single-table-schema convenience: a two-part name whose head
            # is a CATALOG resolves to that catalog's schema-named-like-
            # the-table relation — so ``system.metrics`` reaches
            # system.metrics.metrics without a USE system. Gated on the
            # connector DECLARING the jmx-style one-relation-per-schema
            # convention: a typo'd schema name against an ordinary
            # multi-table catalog must keep erroring, never silently
            # resolve into a different catalog's data
            alt_conn = self.catalogs[parts[0]]
            if getattr(alt_conn, "single_table_schemas", False):
                alt_meta = alt_conn.get_table(parts[1], parts[1])
                if alt_meta is not None:
                    catalog, schema, table = parts[0], parts[1], parts[1]
                    conn, meta = alt_conn, alt_meta
        if meta is None:
            raise PlanningError(f"table not found: {catalog}.{schema}.{table}")
        # authorization seam (reference: AccessControl.checkCanSelectFromColumns
        # called from StatementAnalyzer)
        ac = getattr(self.session, "access_control", None)
        if ac is not None:
            ac.check_can_select(self.session.identity, catalog, schema, table)
        node = P.TableScanNode(
            catalog=catalog,
            schema=schema,
            table=table,
            column_names=[c.name for c in meta.columns],
            column_types=[c.type for c in meta.columns],
        )
        fields = [Field(c.name, c.type, table) for c in meta.columns]
        return RelationPlan(node, Scope(fields, outer_scope))

    def _plan_information_schema(self, catalog: str, conn, table: str,
                                 outer_scope) -> RelationPlan:
        """information_schema views synthesized from connector metadata
        (reference: ``connector/informationschema/`` — schemata, tables,
        columns per catalog). Materialized at plan time as a constant
        relation (metadata scale)."""
        from trino_tpu_torch.server.security import AccessDeniedError

        ac = getattr(self.session, "access_control", None)
        identity = getattr(self.session, "identity", None)

        def visible(s: str, t: str) -> bool:
            """Metadata visibility follows table access (reference:
            information_schema rows are filtered through access control —
            names must not leak to identities that cannot select)."""
            if ac is None:
                return True
            try:
                ac.check_can_select(identity, catalog, s, t)
                return True
            except AccessDeniedError:
                return False

        if table == "schemata":
            cols = [("catalog_name", T.varchar()), ("schema_name", T.varchar())]
            rows = [(catalog, s) for s in conn.list_schemas()]
        elif table == "tables":
            cols = [("table_catalog", T.varchar()), ("table_schema", T.varchar()),
                    ("table_name", T.varchar()), ("table_type", T.varchar())]
            rows = [
                (catalog, s, t, "BASE TABLE")
                for s in conn.list_schemas()
                for t in conn.list_tables(s)
                if visible(s, t)
            ]
        elif table == "columns":
            cols = [("table_catalog", T.varchar()), ("table_schema", T.varchar()),
                    ("table_name", T.varchar()), ("column_name", T.varchar()),
                    ("ordinal_position", T.BIGINT), ("data_type", T.varchar())]
            rows = []
            for s in conn.list_schemas():
                for t in conn.list_tables(s):
                    if not visible(s, t):
                        continue
                    meta = conn.get_table(s, t)
                    if meta is None:
                        continue
                    for i, c in enumerate(meta.columns):
                        rows.append((catalog, s, t, c.name, i + 1, str(c.type)))
        else:
            raise PlanningError(
                f"information_schema has no table {table!r} "
                "(schemata, tables, columns)")
        node = P.ValuesNode([t for _, t in cols], [n for n, _ in cols], rows)
        fields = [Field(n, t, table) for n, t in cols]
        return RelationPlan(node, Scope(fields, outer_scope))

    # ------------------------------------------------- join-order selection
    def _reorder_implicit_joins(self, from_rel, spec, ctes):
        """Reorder a FROM comma-list (a chain of implicit/cross joins) so
        every join has an equi edge when one exists: start from the largest
        relation (the fact), repeatedly append the SMALLEST relation
        connected by a WHERE equality to the relations already joined.

        Reference role: ReorderJoins + DetermineJoinDistributionType in
        miniature — without it, a FROM list like TPC-DS q64's (18 relations
        whose equi predicates don't follow list order) plans Cartesian
        products (a date_dim cross join = 73k x fact rows before the filter
        lands). Name-based and best-effort: relations whose columns can't
        be resolved just keep list order. Skipped for SELECT * (reordering
        would change the star's column order)."""
        if not isinstance(from_rel, ast.Join) or from_rel.join_type not in (
            "cross", "implicit"
        ):
            return from_rel
        if any(isinstance(it.expr, ast.Star) for it in spec.select_items or ()):
            return from_rel

        # flatten the implicit chain
        rels: List = []

        def flatten(r):
            if isinstance(r, ast.Join) and r.join_type in ("cross", "implicit"):
                flatten(r.left)
                flatten(r.right)
            else:
                rels.append(r)

        flatten(from_rel)
        if len(rels) < 3:
            return from_rel
        if any(self._unwrap_unnest(r)[0] is not None for r in rels):
            return from_rel  # UNNEST is lateral: list order is a data dependency
        names, sizes, ndv_fns = [], [], []
        for r in rels:
            n, s, nf = self._relation_columns_and_size(r, ctes)
            names.append(n)
            sizes.append(s)
            ndv_fns.append(nf)

        def owner(ident: ast.Identifier):
            parts = [p.lower() for p in ident.parts]
            if len(parts) >= 2:
                q = parts[-2]
                for i, r in enumerate(rels):
                    if self._relation_alias(r) == q:
                        return i
                return None
            hits = [i for i, cols in enumerate(names) if parts[-1] in cols]
            return hits[0] if len(hits) == 1 else None

        edges = []  # (rel_a, rel_b, col_a, col_b)
        for conj in split_conjuncts(spec.where):
            if (isinstance(conj, ast.Comparison) and conj.op == "="
                    and isinstance(conj.left, ast.Identifier)
                    and isinstance(conj.right, ast.Identifier)):
                a, b = owner(conj.left), owner(conj.right)
                if a is not None and b is not None and a != b:
                    edges.append((a, b, conj.left.parts[-1].lower(),
                                  conj.right.parts[-1].lower()))
        if not edges:
            return from_rel

        def edge_ndv(i, col):
            ndv = ndv_fns[i](col)
            return ndv if ndv else sizes[i]

        def join_estimate(cur_rows, cand, prefix):
            """|prefix ⨝ cand| ≈ cur * |cand| / Π max(ndv_left, ndv_right)
            over the connecting equi edges — the textbook containment
            formula (reference: JoinStatsRule). Chooses the SELECTIVE edge
            (suppkey, ndv 10k) over the exploding one (nationkey, ndv 25)
            where plain smallest-relation-first cannot tell them apart."""
            denom = 1.0
            connected = False
            for a, b, ca, cb in edges:
                if a == cand and b in prefix:
                    denom *= max(edge_ndv(a, ca), edge_ndv(b, cb), 1)
                    connected = True
                elif b == cand and a in prefix:
                    denom *= max(edge_ndv(b, cb), edge_ndv(a, ca), 1)
                    connected = True
            if not connected:
                return cur_rows * sizes[cand], False
            return cur_rows * sizes[cand] / denom, True

        remaining = set(range(len(rels)))
        start = max(remaining, key=lambda i: sizes[i])
        order = [start]
        prefix = {start}
        cur_rows = float(sizes[start])
        remaining.discard(start)
        while remaining:
            scored = [
                (i,) + join_estimate(cur_rows, i, prefix) for i in remaining
            ]
            connected = [s for s in scored if s[2]]
            pool = connected or scored
            nxt, est, _ = min(pool, key=lambda s: (s[1], sizes[s[0]]))
            order.append(nxt)
            prefix.add(nxt)
            cur_rows = max(est, 1.0)
            remaining.discard(nxt)
        if order == list(range(len(rels))):
            return from_rel
        out = rels[order[0]]
        for i in order[1:]:
            out = ast.Join(join_type="implicit", left=out, right=rels[i])
        return out

    def _relation_alias(self, r) -> Optional[str]:
        if isinstance(r, ast.AliasedRelation):
            return r.alias.lower()
        if isinstance(r, ast.Table):
            return r.parts[-1].lower()
        return None

    @staticmethod
    def _no_ndv(_col):
        return None

    def _relation_columns_and_size(self, r, ctes):
        """(column-name set, row estimate, ndv-lookup) for join-order
        attribution; the ndv lookup backs the cost-based edge choice."""
        if isinstance(r, ast.AliasedRelation):
            cols, size, ndv = self._relation_columns_and_size(r.relation, ctes)
            if r.column_aliases:
                cols = {c.lower() for c in r.column_aliases}
            return cols, size, ndv
        if isinstance(r, ast.Table):
            cte = ctes.get(r.parts[-1].lower()) if len(r.parts) == 1 else None
            if cte is not None:
                body = cte.query.body if isinstance(cte.query, ast.Query) else None
                cols = set()
                if isinstance(body, ast.QuerySpec):
                    for it in body.select_items or ():
                        if it.alias:
                            cols.add(it.alias.lower())
                        elif isinstance(it.expr, ast.Identifier):
                            cols.add(it.expr.parts[-1].lower())
                if cte.column_aliases:
                    cols = {c.lower() for c in cte.column_aliases}
                return cols, 100_000, self._no_ndv
            try:
                parts = [p.lower() for p in r.parts]
                if len(parts) == 1:
                    catalog, schema, table = (
                        self.default_catalog, self.default_schema, parts[0])
                elif len(parts) == 2:
                    catalog, schema, table = self.default_catalog, parts[0], parts[1]
                else:
                    catalog, schema, table = parts[:3]
                conn = self.catalogs[catalog]
                meta = conn.get_table(schema, table)
                rows = conn.table_row_count(schema, table) or 10_000

                def ndv(col, _c=conn, _s=schema, _t=table):
                    try:
                        cs = _c.column_stats(_s, _t, col)
                    except Exception:  # noqa: BLE001
                        return None
                    return cs.ndv if cs is not None else None

                return {c.name.lower() for c in meta.columns}, rows, ndv
            except Exception:  # noqa: BLE001 — best-effort attribution
                return set(), 10_000, self._no_ndv
        return set(), 10_000

    @staticmethod
    def _unwrap_unnest(r: ast.Relation):
        """(unnest, alias, col_aliases) if ``r`` is an UNNEST relation."""
        if isinstance(r, ast.Unnest):
            return r, None, None
        if isinstance(r, ast.AliasedRelation) and isinstance(r.relation, ast.Unnest):
            return r.relation, r.alias, r.column_aliases
        return None, None, None

    def plan_join(
        self, rel: ast.Join, outer_scope: Optional[Scope], ctes: Dict[str, ast.WithQuery]
    ) -> RelationPlan:
        left = self.plan_relation(rel.left, outer_scope, ctes)
        un, un_alias, un_cols = self._unwrap_unnest(rel.right)
        if un is not None:
            if rel.join_type not in ("cross", "implicit", "inner"):
                raise PlanningError(f"{rel.join_type} JOIN UNNEST not supported")
            if rel.using:
                raise PlanningError("JOIN UNNEST ... USING not supported")
            out = self.plan_unnest(un, left, un_alias, un_cols, outer_scope)
            if rel.on is not None:
                pred = ExprAnalyzer(out.scope).analyze(rel.on)
                return RelationPlan(P.FilterNode(out.node, pred), out.scope)
            return out
        right = self.plan_relation(rel.right, outer_scope, ctes)
        joint_fields = left.scope.fields + right.scope.fields
        joint_scope = Scope(joint_fields, outer_scope)
        nleft = len(left.scope.fields)

        if rel.join_type in ("cross", "implicit"):
            node = P.JoinNode(
                join_type="inner", left=left.node, right=right.node,
                left_keys=[], right_keys=[], filter=None,
            )
            return RelationPlan(node, joint_scope)

        if rel.using:
            conj = []
            for c in rel.using:
                conj.append(
                    ast.Comparison("=", ast.Identifier((c,)), ast.Identifier((c,)))
                )
            raise PlanningError("JOIN USING: not yet supported")

        analyzer = ExprAnalyzer(joint_scope)
        predicate = analyzer.analyze(rel.on) if rel.on is not None else None
        left_keys, right_keys, residual = self._extract_equi_keys(predicate, nleft)
        if rel.join_type in ("inner", "left"):
            node = P.JoinNode(
                join_type=rel.join_type, left=left.node, right=right.node,
                left_keys=left_keys, right_keys=right_keys,
                filter=combine_conjuncts(residual),
            )
            return RelationPlan(node, joint_scope)
        raise PlanningError(f"{rel.join_type} join: not yet supported")

    @staticmethod
    def _extract_equi_keys(
        predicate: Optional[ir.Expr], nleft: int
    ) -> Tuple[List[int], List[int], List[ir.Expr]]:
        left_keys: List[int] = []
        right_keys: List[int] = []
        residual: List[ir.Expr] = []
        for c in ir_conjuncts(predicate):
            if (
                isinstance(c, ir.Call)
                and c.name == "eq"
                and isinstance(c.args[0], ir.ColumnRef)
                and isinstance(c.args[1], ir.ColumnRef)
            ):
                a, b = c.args[0].index, c.args[1].index
                if a < nleft <= b:
                    left_keys.append(a)
                    right_keys.append(b - nleft)
                    continue
                if b < nleft <= a:
                    left_keys.append(b)
                    right_keys.append(a - nleft)
                    continue
            residual.append(c)
        return left_keys, right_keys, residual

    # ---------------------------------------------------------- query spec
    def plan_query_spec(
        self,
        spec: ast.QuerySpec,
        outer_scope: Optional[Scope],
        ctes: Dict[str, ast.WithQuery],
        query: ast.Query,
    ) -> RelationPlan:
        if spec.grouping_sets is not None:
            return self._plan_grouping_sets(spec, outer_scope, ctes, query)
        # FROM (implicit-join chains reordered by connectivity + size first
        # — see _reorder_implicit_joins)
        if spec.from_ is not None:
            from_rel = self._reorder_implicit_joins(spec.from_, spec, ctes)
            rp = self.plan_relation(from_rel, outer_scope, ctes)
        else:
            rp = RelationPlan(P.ValuesNode([], [], [()]), Scope([], outer_scope))
        node, scope = rp.node, rp.scope

        # WHERE: split into plain conjuncts and subquery predicates
        plain: List[ir.Expr] = []
        for conj in split_conjuncts(spec.where):
            node, scope, handled = self._plan_predicate_subquery(conj, node, scope, ctes)
            if handled:
                continue
            analyzer = ExprAnalyzer(scope)
            e = analyzer.analyze(conj)
            if analyzer.outer_refs:
                raise PlanningError("correlated predicate in unsupported position")
            plain.append(e)
        if plain:
            node = P.FilterNode(node, combine_conjuncts(plain))

        has_aggs = (
            bool(spec.group_by)
            or bool(spec.having)
            or any(find_aggregates(si.expr) for si in spec.select_items if not isinstance(si.expr, ast.Star))
        )
        if has_aggs:
            return self._plan_aggregation(spec, query, node, scope, outer_scope, ctes)

        # plain SELECT (window functions evaluate between FROM/WHERE and the
        # final projection — reference: QueryPlanner.window())
        replacements: Dict[ast.Expression, ir.Expr] = {}
        node = self._plan_windows(spec, query, node, scope, replacements)
        select_irs, names, scope_after = self._plan_select_items(
            spec, scope, ctes, node, replacements
        )
        n_visible = len(select_irs)
        extra_ast_to_ch = self._append_order_by_windows(
            query, spec, select_irs, names, replacements
        )
        self._append_order_by_hidden(
            query, spec, select_irs, names, scope, replacements, extra_ast_to_ch
        )
        node_proj = P.ProjectNode(node, select_irs, names)
        out_fields = [
            Field(n, e.type, None)
            for n, e in zip(names[:n_visible], select_irs[:n_visible])
        ]
        out_scope = Scope(out_fields, outer_scope)
        node = node_proj
        if spec.distinct:
            if extra_ast_to_ch:
                raise PlanningError("DISTINCT with window in ORDER BY only")
            node = P.AggregationNode(
                node, list(range(len(select_irs))), [], step="single", names=names
            )
        if query.order_by:
            # select-item index -> first output channel (Star items expand)
            item_channels = []
            ch = 0
            for si in spec.select_items:
                item_channels.append(ch)
                if isinstance(si.expr, ast.Star):
                    ch += len(
                        scope.channels_of_alias(si.expr.qualifier[0])
                        if si.expr.qualifier
                        else scope.fields
                    )
                else:
                    ch += 1
            node = self._plan_order_by(
                query, node, out_scope, replacements=replacements,
                select_asts=spec.select_items, extra_ast_to_ch=extra_ast_to_ch,
                item_channels=item_channels,
            )
        if query.limit is not None:
            if query.order_by and isinstance(node, P.SortNode):
                node = P.TopNNode(node.source, query.limit, node.sort_channels)
            else:
                node = P.LimitNode(node, query.limit)
        node = self._drop_hidden(node, names, n_visible)
        return RelationPlan(node, out_scope)

    def _plan_grouping_sets(self, spec, outer_scope, ctes, query) -> RelationPlan:
        """GROUPING SETS / ROLLUP / CUBE by expansion: one aggregation per
        set, keys absent from a set become NULL in its select list, results
        concatenate (UNION ALL shape). The reference computes all sets in
        one pass over a GroupIdNode-expanded input (sql/planner/
        QueryPlanner.planGroupingSets); the expansion here re-reads the
        source per set — correct, simpler, and each branch still takes the
        engine's fast single-set path."""
        all_keys = {k for gs in spec.grouping_sets for k in gs}

        def null_missing(e, present):
            if e in all_keys and e not in present:
                return ast.Literal("null", None)
            if isinstance(e, tuple):
                return tuple(null_missing(x, present) for x in e)
            if hasattr(e, "__dataclass_fields__") and isinstance(e, (ast.Expression,)):
                import dataclasses as _dc

                changes = {}
                for f in _dc.fields(e):
                    v = getattr(e, f.name)
                    if isinstance(v, (ast.Expression, tuple)):
                        nv = null_missing(v, present)
                        if nv is not v:
                            changes[f.name] = nv
                return _dc.replace(e, **changes) if changes else e
            return e

        branches = []
        for gs in spec.grouping_sets:
            present = set(gs)
            items = tuple(
                ast.SelectItem(null_missing(it.expr, present), it.alias)
                for it in spec.select_items
            )
            branches.append(
                dataclasses.replace(
                    spec, select_items=items, group_by=tuple(gs),
                    grouping_sets=None,
                )
            )
        # branches must not apply the query's ORDER BY/LIMIT — those wrap
        # the union below
        inner_q = dataclasses.replace(query, order_by=(), limit=None)
        plan = self.plan_query_spec(branches[0], outer_scope, ctes, inner_q)
        nodes = [plan.node]
        for b in branches[1:]:
            nodes.append(self.plan_query_spec(b, outer_scope, ctes, inner_q).node)
        width = len(nodes[0].output_types)
        out_types = []
        for i in range(width):
            t = nodes[0].output_types[i]
            for n in nodes[1:]:
                t2 = T.common_super_type(t, n.output_types[i])
                if t2 is None:
                    raise PlanningError("grouping sets branches: incompatible types")
                t = t2
            out_types.append(t)
        names = [f.name or f"_col{i}" for i, f in enumerate(plan.scope.fields)]
        casted = [_cast_to(n, out_types, names) for n in nodes]
        union = casted[0]
        for n in casted[1:]:
            union = P.UnionNode(sources_=[union, n], names=names)
        fields = [
            Field(f.name, t, None)
            for f, t in zip(plan.scope.fields, out_types)
        ]
        scope = Scope(fields, outer_scope)
        node: P.PlanNode = union
        if query is not None and query.order_by:
            node = self._plan_order_by(
                query, node, scope, replacements={}, select_asts=[])
        if query is not None and query.limit is not None:
            if isinstance(node, P.SortNode):
                node = P.TopNNode(node.source, query.limit, node.sort_channels)
            else:
                node = P.LimitNode(node, query.limit)
        return RelationPlan(node, scope)

    def _plan_select_items(self, spec, scope, ctes, node, replacements=None):
        select_irs: List[ir.Expr] = []
        names: List[str] = []
        for si in spec.select_items:
            if isinstance(si.expr, ast.Star):
                chans = (
                    scope.channels_of_alias(si.expr.qualifier[0])
                    if si.expr.qualifier
                    else range(len(scope.fields))
                )
                for ch in chans:
                    f = scope.fields[ch]
                    select_irs.append(ir.ColumnRef(f.type, ch, f.name or ""))
                    names.append(f.name or f"_col{len(names)}")
                continue
            analyzer = ExprAnalyzer(scope, replacements)
            e = analyzer.analyze(si.expr)
            select_irs.append(e)
            names.append(si.alias or _derive_name(si.expr) or f"_col{len(names)}")
        return select_irs, names, scope

    # -------------------------------------------------------------- windows
    def _plan_windows(self, spec, query, node, scope, replacements):
        """Plan window functions in the SELECT list: append a WindowNode per
        distinct (PARTITION BY, ORDER BY) spec, each adding one output
        channel per call; post-window expressions see the calls through
        ``replacements`` (reference: QueryPlanner.window + WindowNode)."""
        windows: List[ast.WindowFunction] = []
        for si in spec.select_items:
            if not isinstance(si.expr, ast.Star):
                for w in find_windows(si.expr):
                    if w not in windows:
                        windows.append(w)
        for s in query.order_by:
            for w in find_windows(s.expr):
                if w not in windows:
                    windows.append(w)
        if not windows:
            return node
        if spec.where is not None and find_windows(spec.where):
            raise PlanningError("window functions are not allowed in WHERE")

        # group by identical window specification -> one WindowNode each
        def spec_key(w: ast.WindowFunction):
            return (w.partition_by, w.order_by)

        groups: Dict[tuple, List[ast.WindowFunction]] = {}
        for w in windows:
            groups.setdefault(spec_key(w), []).append(w)

        for (pby, oby), ws in groups.items():
            width = len(node.output_types)
            analyzer = ExprAnalyzer(scope, replacements)
            # inputs: identity prefix + partition keys + order keys + args
            extra: List[ir.Expr] = []
            extra_names: List[str] = []

            def add_input(e: ir.Expr, tag: str) -> int:
                if isinstance(e, ir.ColumnRef) and e.index < width:
                    return e.index
                extra.append(e)
                extra_names.append(f"${tag}{len(extra)}")
                return width + len(extra) - 1

            part_ch = [add_input(analyzer.analyze(p), "pk") for p in pby]
            order_ch = [
                (add_input(analyzer.analyze(s.expr), "ok"), s.ascending, s.nulls_first)
                for s in oby
            ]
            calls: List[P.WindowCall] = []
            call_names: List[str] = []
            for w in ws:
                calls.append(self._window_call(w, analyzer, add_input, bool(oby)))
                call_names.append(w.name)
            if extra:
                node = P.ProjectNode.identity_prefix(node, extra, extra_names)
            wnode = P.WindowNode(node, part_ch, order_ch, calls, call_names)
            base = len(node.output_types)
            for i, w in enumerate(ws):
                replacements[w] = ir.ColumnRef(calls[i].output_type, base + i, w.name)
            node = wnode
        return node

    def _window_call(self, w: ast.WindowFunction, analyzer, add_input, has_order) -> P.WindowCall:
        fn = w.name
        if fn not in WINDOW_ONLY_FUNCTIONS and fn not in AGGREGATE_FUNCTIONS:
            raise PlanningError(f"unknown window function {fn}")
        frame, flo, fhi = self._window_frame(w, has_order)

        def call(*args, **kw):
            kw.setdefault("frame", frame)
            kw.setdefault("frame_lo", flo)
            kw.setdefault("frame_hi", fhi)
            return P.WindowCall(*args, **kw)

        if fn in ("rank", "dense_rank", "row_number", "percent_rank",
                  "cume_dist"):
            if not has_order:
                raise PlanningError(f"{fn}() requires window ORDER BY")
            if w.args:
                raise PlanningError(f"{fn}() takes no arguments")
            return call(fn, None, window_result_type(fn, None))
        if fn == "ntile":
            if not has_order:
                raise PlanningError("ntile() requires window ORDER BY")
            if len(w.args) != 1 or not (
                isinstance(w.args[0], ast.Literal) and w.args[0].kind == "number"
            ):
                raise PlanningError("ntile(n) requires a literal bucket count")
            k = int(w.args[0].value)
            if k < 1:
                raise PlanningError("ntile() bucket count must be positive")
            return call(fn, None, window_result_type(fn, None), offset=k)
        if fn == "nth_value":
            if len(w.args) != 2 or not (
                isinstance(w.args[1], ast.Literal) and w.args[1].kind == "number"
            ):
                raise PlanningError("nth_value(value, n) with literal n supported")
            nth = int(w.args[1].value)
            if nth < 1:
                raise PlanningError("nth_value() offset must be positive")
            arg = analyzer.analyze(w.args[0])
            ch = add_input(arg, "a")
            return call(fn, ch, window_result_type(fn, arg.type), offset=nth)
        if fn in ("lag", "lead"):
            if not has_order:
                raise PlanningError(f"{fn}() requires window ORDER BY")
            if not 1 <= len(w.args) <= 2:
                raise PlanningError(f"{fn}(value[, offset]) supported")
            offset = 1
            if len(w.args) == 2:
                off = w.args[1]
                if not (isinstance(off, ast.Literal) and off.kind == "number"):
                    raise PlanningError(f"{fn} offset must be a literal")
                offset = int(off.value)
            arg = analyzer.analyze(w.args[0])
            ch = add_input(arg, "a")
            return call(fn, ch, window_result_type(fn, arg.type), offset=offset)
        if fn in ("first_value", "last_value"):
            if len(w.args) != 1:
                raise PlanningError(f"{fn}(value) expects 1 argument")
            arg = analyzer.analyze(w.args[0])
            ch = add_input(arg, "a")
            return call(fn, ch, window_result_type(fn, arg.type))
        # aggregates over the window
        if w.is_star or (fn == "count" and not w.args):
            return call("count", None, T.BIGINT)
        if len(w.args) != 1:
            raise PlanningError(f"{fn} window aggregate expects 1 argument")
        if fn in ("min", "max") and frame != "partition":
            raise PlanningError(
                f"{fn}() with a window ORDER BY (running frame) is not supported; "
                "omit the ORDER BY for whole-partition min/max"
            )
        arg = analyzer.analyze(w.args[0])
        ch = add_input(arg, "a")
        return call(fn, ch, window_result_type(fn, arg.type))

    def _append_order_by_windows(self, query, spec, select_irs, names, replacements):
        """Windows appearing only in ORDER BY get hidden projection channels
        (dropped again after the sort by _drop_hidden). Returns AST->channel
        for _plan_order_by."""
        extra: Dict[ast.Expression, int] = {}
        select_asts = [
            si.expr for si in spec.select_items if not isinstance(si.expr, ast.Star)
        ]
        for s in query.order_by:
            for w in find_windows(s.expr):
                if w in replacements and w not in select_asts and w not in extra:
                    extra[w] = len(select_irs)
                    select_irs.append(replacements[w])
                    names.append(f"$ob_win{len(extra)}")
        return extra

    def _append_order_by_hidden(
        self, query, spec, select_irs, names, scope, replacements, extra
    ):
        """ORDER BY over source columns/expressions that are not in the
        SELECT list (reference: QueryPlanner's pre-projection of ordering
        symbols): analyze against the PRE-projection scope and append a
        hidden channel, pruned after the sort by _drop_hidden."""
        if spec.distinct:
            # invalid SQL to order by a non-output column under DISTINCT
            # (reference error: "ORDER BY expressions must appear in select
            # list"); leave resolution to _plan_order_by's error path
            return
        select_asts = [
            si.expr for si in spec.select_items if not isinstance(si.expr, ast.Star)
        ]
        aliases = {
            si.alias.lower()
            for si in spec.select_items
            if isinstance(si, ast.SelectItem) and si.alias
        }
        for s in query.order_by:
            e = s.expr
            if e in extra or e in select_asts:
                continue
            if isinstance(e, ast.Identifier) and len(e.parts) == 1 and e.parts[0].lower() in aliases:
                continue
            if isinstance(e, ast.Literal) and e.kind == "number":
                continue  # ordinal
            # does it already name a visible output column?
            star = any(isinstance(si.expr, ast.Star) for si in spec.select_items)
            if star and isinstance(e, ast.Identifier):
                continue  # SELECT * exposes every source column
            try:
                analyzed = ExprAnalyzer(scope, replacements).analyze(e)
            except AnalysisError:
                continue  # let _plan_order_by report the failure
            extra[e] = len(select_irs)
            select_irs.append(analyzed)
            names.append(f"$ob{len(extra)}")

    @staticmethod
    def _drop_hidden(node, names, n_visible):
        if len(names) == n_visible:
            return node
        tys = node.output_types
        return P.ProjectNode(
            node,
            [ir.ColumnRef(tys[i], i, names[i]) for i in range(n_visible)],
            list(names[:n_visible]),
        )

    @staticmethod
    def _window_frame(w: ast.WindowFunction, has_order: bool):
        """-> (frame kind, rows lo offset, rows hi offset). Offsets are
        None except for 'rows_offset' (ROWS frames with numeric bounds —
        reference: window/FrameInfo; RANGE value offsets are not yet
        lowered)."""
        if w.frame is None:
            return ("running" if has_order else "partition"), None, None
        mode, lo, hi = w.frame

        def bound(s, is_lo):
            if s == "unbounded preceding":
                return None if is_lo else PlanningError
            if s == "unbounded following":
                return PlanningError if is_lo else None
            if s == "current row":
                return 0
            n, kind = s.split()
            return -int(n) if kind == "preceding" else int(n)

        if lo == "unbounded preceding" and hi == "unbounded following":
            return "partition", None, None
        if lo == "unbounded preceding" and hi == "current row":
            return ("rows_running" if mode == "rows" else "running"), None, None
        if mode == "rows":
            blo, bhi = bound(lo, True), bound(hi, False)
            if blo is not PlanningError and bhi is not PlanningError:
                if blo is not None and bhi is not None and blo > bhi:
                    raise PlanningError(f"empty window frame {w.frame}")
                return "rows_offset", blo, bhi
        raise PlanningError(f"unsupported window frame {w.frame}")

    # ---------------------------------------------------------- aggregation
    def _plan_aggregation(self, spec, query, node, scope, outer_scope, ctes) -> RelationPlan:
        # Collect aggregate calls from SELECT, HAVING, ORDER BY
        agg_asts: List[ast.FunctionCall] = []
        for si in spec.select_items:
            if not isinstance(si.expr, ast.Star):
                agg_asts.extend(find_aggregates(si.expr))
        if spec.having is not None:
            agg_asts.extend(find_aggregates(spec.having))
        for s in query.order_by:
            agg_asts.extend(find_aggregates(s.expr))
        # dedupe by structural equality
        uniq_aggs: List[ast.FunctionCall] = []
        for a in agg_asts:
            if a not in uniq_aggs:
                uniq_aggs.append(a)

        # group keys: resolve ordinals (GROUP BY 1) to select expressions
        group_asts: List[ast.Expression] = []
        for g in spec.group_by:
            if isinstance(g, ast.Literal) and g.kind == "number":
                idx = int(g.value) - 1
                if not 0 <= idx < len(spec.select_items):
                    raise PlanningError("GROUP BY ordinal out of range")
                group_asts.append(spec.select_items[idx].expr)
            else:
                group_asts.append(g)

        analyzer = ExprAnalyzer(scope, allow_aggregates=True)
        group_irs = [analyzer.analyze(g) for g in group_asts]
        agg_arg_irs: List[Optional[ir.Expr]] = []
        agg_calls: List[P.AggregateCall] = []
        pre_exprs: List[ir.Expr] = list(group_irs)
        pre_names: List[str] = [_derive_name(g) or f"gk{i}" for i, g in enumerate(group_asts)]
        for a in uniq_aggs:
            if a.is_star:
                agg_arg_irs.append(None)
                agg_calls.append(P.AggregateCall("count", None, T.BIGINT))
                continue
            param = None
            arg2 = None
            fname = "bool_and" if a.name == "every" else a.name
            if fname == "approx_percentile":
                if len(a.args) != 2:
                    raise PlanningError("approx_percentile expects 2 arguments")
                p_ir = ExprAnalyzer(scope).analyze(a.args[1])
                param = _constant_fraction(p_ir, "approx_percentile")
            elif fname in P._TWO_ARG_AGGS:
                if len(a.args) != 2:
                    raise PlanningError(f"{fname} expects 2 arguments")
                arg2 = ExprAnalyzer(scope).analyze(a.args[1])
            elif len(a.args) != 1:
                raise PlanningError(f"{a.name} expects 1 argument")
            arg = ExprAnalyzer(scope).analyze(a.args[0])
            out_t = aggregate_result_type(
                fname, arg.type, arg2.type if arg2 is not None else None)
            ch = len(pre_exprs)
            pre_exprs.append(arg)
            pre_names.append(f"aggarg{len(agg_calls)}")
            ch2 = None
            if arg2 is not None:
                ch2 = len(pre_exprs)
                pre_exprs.append(arg2)
                pre_names.append(f"aggarg{len(agg_calls)}b")
            agg_calls.append(
                P.AggregateCall(fname, ch, out_t, distinct=a.distinct,
                                param=param, arg2_channel=ch2))
            agg_arg_irs.append(arg)

        if not pre_exprs:
            # count(*)-only aggregation: carry a constant channel so the page
            # keeps its row count through projection pruning
            pre_exprs = [ir.Constant(T.BIGINT, 0)]
            pre_names = ["$zero"]
        pre_project = P.ProjectNode(node, pre_exprs, pre_names)
        k = len(group_irs)
        agg_names = [pre_names[i] for i in range(k)] + [
            f"agg{i}" for i in range(len(agg_calls))
        ]
        agg_node = P.AggregationNode(
            pre_project, list(range(k)), agg_calls, step="single", names=agg_names
        )

        # scope over aggregation output + replacement map for outer exprs
        agg_fields = [
            Field(scope.fields[g.index].name if isinstance(g, ir.ColumnRef) else None,
                  g.type,
                  scope.fields[g.index].relation_alias if isinstance(g, ir.ColumnRef) else None)
            for g in group_irs
        ] + [Field(None, c.output_type, None) for c in agg_calls]
        agg_scope = Scope(agg_fields, outer_scope)
        replacements: Dict[ast.Expression, ir.Expr] = {}
        for i, g in enumerate(group_asts):
            replacements[g] = ir.ColumnRef(group_irs[i].type, i, pre_names[i])
        for i, a in enumerate(uniq_aggs):
            replacements[a] = ir.ColumnRef(agg_calls[i].output_type, k + i, f"agg{i}")

        node = agg_node
        if spec.having is not None:
            plain_having: List[ir.Expr] = []
            for conj in split_conjuncts(spec.having):
                node, agg_scope, handled = self._plan_predicate_subquery(
                    conj, node, agg_scope, ctes, replacements
                )
                if handled:
                    continue
                plain_having.append(ExprAnalyzer(agg_scope, replacements).analyze(conj))
            if plain_having:
                node = P.FilterNode(node, combine_conjuncts(plain_having))

        # windows over the aggregation output (rank() over (order by sum(x)))
        node = self._plan_windows(spec, query, node, agg_scope, replacements)

        select_irs: List[ir.Expr] = []
        names: List[str] = []
        for si in spec.select_items:
            if isinstance(si.expr, ast.Star):
                raise PlanningError("SELECT * with GROUP BY")
            e = ExprAnalyzer(agg_scope, replacements).analyze(si.expr)
            select_irs.append(e)
            names.append(si.alias or _derive_name(si.expr) or f"_col{len(names)}")
        n_visible = len(select_irs)
        extra_ast_to_ch = self._append_order_by_windows(
            query, spec, select_irs, names, replacements
        )
        proj = P.ProjectNode(node, select_irs, names)
        out_fields = [
            Field(n, e.type, None)
            for n, e in zip(names[:n_visible], select_irs[:n_visible])
        ]
        out_scope = Scope(out_fields, outer_scope)
        node = proj

        if spec.distinct:
            if extra_ast_to_ch:
                raise PlanningError("DISTINCT with window in ORDER BY only")
            node = P.AggregationNode(
                node, list(range(len(select_irs))), [], step="single", names=names
            )
        if query.order_by:
            node = self._plan_order_by(
                query, node, out_scope,
                replacements=replacements, select_asts=spec.select_items,
                inner_scope=agg_scope, extra_ast_to_ch=extra_ast_to_ch,
            )
        if query.limit is not None:
            if isinstance(node, P.SortNode):
                node = P.TopNNode(node.source, query.limit, node.sort_channels)
            else:
                node = P.LimitNode(node, query.limit)
        node = self._drop_hidden(node, names, n_visible)
        return RelationPlan(node, out_scope)

    def _plan_order_by(
        self, query, node, out_scope, replacements, select_asts,
        inner_scope=None, extra_ast_to_ch=None, item_channels=None,
    ):
        """ORDER BY resolves against select aliases/ordinals first, then the
        select expressions themselves (by structure). ``extra_ast_to_ch``
        maps hidden projection channels (windows only in ORDER BY);
        ``item_channels`` maps select-item index -> first output channel
        (they diverge when a Star item expands to several channels)."""
        sort_channels = []
        alias_to_ch = {}
        ast_to_ch = dict(extra_ast_to_ch or {})
        for i, si in enumerate(select_asts):
            pos = item_channels[i] if item_channels is not None else i
            if isinstance(si, ast.SelectItem):
                if si.alias:
                    alias_to_ch[si.alias.lower()] = pos
                if not isinstance(si.expr, ast.Star):
                    ast_to_ch[si.expr] = pos
        for s in query.order_by:
            ch = None
            if isinstance(s.expr, ast.Identifier) and len(s.expr.parts) == 1:
                ch = alias_to_ch.get(s.expr.parts[0].lower())
            if ch is None and isinstance(s.expr, ast.Literal) and s.expr.kind == "number":
                ch = int(s.expr.value) - 1
            if ch is None and s.expr in ast_to_ch:
                ch = ast_to_ch[s.expr]
            if ch is None:
                # resolve as a plain column of the output scope
                try:
                    analyzer = ExprAnalyzer(out_scope, replacements)
                    e = analyzer.analyze(s.expr)
                    if isinstance(e, ir.ColumnRef):
                        ch = e.index
                except AnalysisError:
                    ch = None
            if ch is None:
                raise PlanningError(f"cannot resolve ORDER BY expression {s.expr}")
            sort_channels.append((ch, s.ascending, s.nulls_first))
        return P.SortNode(node, sort_channels)

    # ------------------------------------------------------- subquery preds
    def _plan_predicate_subquery(self, conj, node, scope, ctes, replacements=None):
        """Handle IN (subquery) / EXISTS / scalar-subquery comparisons.
        Returns (node, scope, handled)."""
        replacements = replacements or {}
        if isinstance(conj, ast.InSubquery):
            value_ir = ExprAnalyzer(scope).analyze(conj.value)
            sub = self.plan_query(conj.query, None, ctes)  # uncorrelated only
            if len(sub.scope.fields) != 1:
                raise PlanningError("IN subquery must return one column")
            if not isinstance(value_ir, ir.ColumnRef):
                raise PlanningError("IN subquery over expressions: not yet supported")
            jt = "anti" if conj.negated else "semi"
            new_node = P.JoinNode(
                join_type=jt, left=node, right=sub.node,
                left_keys=[value_ir.index], right_keys=[0],
            )
            return new_node, scope, True
        if isinstance(conj, ast.Exists) or (
            isinstance(conj, ast.Not) and isinstance(conj.value, ast.Exists)
        ):
            negated = isinstance(conj, ast.Not)
            ex: ast.Exists = conj.value if negated else conj
            return self._plan_exists(ex, negated, node, scope, ctes)
        if isinstance(conj, ast.Comparison) and isinstance(conj.right, ast.ScalarSubquery):
            return self._plan_scalar_comparison(conj, node, scope, ctes, replacements)
        return node, scope, False

    def _plan_exists(self, ex: ast.Exists, negated: bool, node, scope, ctes):
        """Correlated EXISTS -> semi/anti join on the equi-correlation keys;
        non-equality correlated conjuncts (e.g. TPC-H Q21's
        ``l2.l_suppkey <> l1.l_suppkey``) become the join's residual filter,
        which the executor evaluates with the expansion kernel
        (reference: TransformExistsApplyToCorrelatedJoin + decorrelation)."""
        q = ex.query
        if q.with_queries or not isinstance(q.body, ast.QuerySpec):
            raise PlanningError("complex EXISTS subquery: not yet supported")
        spec = q.body
        inner_rp = self.plan_relation(spec.from_, scope, ctes) if spec.from_ else None
        if inner_rp is None:
            raise PlanningError("EXISTS without FROM")
        inner_node, inner_scope = inner_rp.node, inner_rp.scope
        nleft = len(scope.fields)
        corr_outer: List[int] = []
        corr_inner: List[int] = []
        inner_filters: List[ir.Expr] = []
        residual: List[ir.Expr] = []  # over joint (outer ++ inner) channels
        for c in split_conjuncts(spec.where):
            analyzer = ExprAnalyzer(inner_scope)
            e = analyzer.analyze(c)
            if not analyzer.outer_refs:
                inner_filters.append(e)
                continue
            if (
                isinstance(e, ir.Call)
                and e.name == "eq"
                and {type(e.args[0]), type(e.args[1])} == {ir.OuterRef, ir.ColumnRef}
            ):
                outer_arg = e.args[0] if isinstance(e.args[0], ir.OuterRef) else e.args[1]
                inner_arg = e.args[0] if isinstance(e.args[1], ir.OuterRef) else e.args[1]
                corr_outer.append(outer_arg.index)
                corr_inner.append(inner_arg.index)
                continue
            residual.append(decorrelate_to_joint(e, nleft))
        if not corr_outer:
            raise PlanningError("uncorrelated EXISTS: not yet supported")
        if inner_filters:
            inner_node = P.FilterNode(inner_node, combine_conjuncts(inner_filters))
        jt = "anti" if negated else "semi"
        if residual:
            # keep the full inner relation: the filter references its columns
            new_node = P.JoinNode(
                join_type=jt, left=node, right=inner_node,
                left_keys=corr_outer, right_keys=corr_inner,
                filter=combine_conjuncts(residual),
            )
            return new_node, scope, True
        # project the inner correlation keys
        proj = P.ProjectNode(
            inner_node,
            [ir.ColumnRef(inner_scope.fields[ch].type, ch) for ch in corr_inner],
            [f"ck{i}" for i in range(len(corr_inner))],
        )
        new_node = P.JoinNode(
            join_type=jt, left=node, right=proj,
            left_keys=corr_outer, right_keys=list(range(len(corr_inner))),
        )
        return new_node, scope, True

    def _plan_scalar_comparison(self, conj: ast.Comparison, node, scope, ctes, replacements=None):
        """x <op> (SELECT agg(...) [FROM ... WHERE outer = inner]) —
        uncorrelated: single-row cross join; correlated equi: group the
        subquery by its correlation keys and equi-join."""
        replacements = replacements or {}
        sub_ast = conj.right.query
        # Try planning as uncorrelated first
        try:
            sub = self.plan_query(sub_ast, None, ctes)
            correlated = False
        except Exception:
            correlated = True
        if not correlated:
            if len(sub.scope.fields) != 1:
                raise PlanningError("scalar subquery must return one column")
            nleft = len(scope.fields)
            f = sub.scope.fields[0]
            join = P.JoinNode(
                join_type="inner", left=node, right=sub.node,
                left_keys=[], right_keys=[], distribution="broadcast",
                singleton=True,
            )
            new_scope = Scope(scope.fields + [Field(None, f.type, "$scalar")], scope.parent)
            left_ir = ExprAnalyzer(new_scope, replacements).analyze(conj.left)
            from trino_tpu_torch.sql.analyzer.expr_analyzer import _COMPARISON_OPS

            pred = ir.Call(
                T.BOOLEAN,
                _COMPARISON_OPS[conj.op],
                (left_ir, ir.ColumnRef(f.type, nleft)),
            )
            filt = P.FilterNode(join, pred)
            # project away the scalar channel
            proj = P.ProjectNode(
                filt,
                [ir.ColumnRef(fl.type, i, fl.name or "") for i, fl in enumerate(scope.fields)],
                [fl.name or f"_c{i}" for i, fl in enumerate(scope.fields)],
            )
            return proj, scope, True
        return self._plan_correlated_scalar(conj, sub_ast, node, scope, ctes, replacements)

    def _plan_correlated_scalar(self, conj, sub_ast: ast.Query, node, scope, ctes, replacements=None):
        replacements = replacements or {}
        """Decorrelate agg scalar subquery: SELECT agg(e) FROM R WHERE
        outer.k = R.j AND rest  ==>  join on k with (SELECT j, agg(e) FROM R
        WHERE rest GROUP BY j)."""
        if not isinstance(sub_ast.body, ast.QuerySpec):
            raise PlanningError("complex correlated scalar subquery")
        spec = sub_ast.body
        if spec.group_by or spec.having or len(spec.select_items) != 1:
            raise PlanningError("correlated scalar subquery must be a bare aggregate")
        agg_calls = find_aggregates(spec.select_items[0].expr)
        if len(agg_calls) == 0:
            raise PlanningError("correlated scalar subquery must aggregate")
        inner_rp = self.plan_relation(spec.from_, scope, ctes)
        inner_node, inner_scope = inner_rp.node, inner_rp.scope
        corr_outer: List[int] = []
        corr_inner: List[int] = []
        inner_filters: List[ast.Expression] = []
        for c in split_conjuncts(spec.where):
            analyzer = ExprAnalyzer(inner_scope)
            e = analyzer.analyze(c)
            if not analyzer.outer_refs:
                inner_filters.append(c)
                continue
            if (
                isinstance(e, ir.Call)
                and e.name == "eq"
                and {type(e.args[0]), type(e.args[1])} == {ir.OuterRef, ir.ColumnRef}
            ):
                outer_arg = e.args[0] if isinstance(e.args[0], ir.OuterRef) else e.args[1]
                inner_arg = e.args[0] if isinstance(e.args[1], ir.OuterRef) else e.args[1]
                corr_outer.append(outer_arg.index)
                corr_inner.append(inner_arg.index)
                continue
            raise PlanningError("correlated scalar subquery predicate too complex")
        if not corr_outer:
            raise PlanningError("scalar subquery planning failed")
        # rebuild: SELECT ck..., expr-over-aggs FROM inner WHERE rest GROUP BY ck
        if inner_filters:
            fil_ir = [ExprAnalyzer(inner_scope).analyze(c) for c in inner_filters]
            inner_node = P.FilterNode(inner_node, combine_conjuncts(fil_ir))
        # pre-project: corr keys + one arg channel per aggregate
        k = len(corr_inner)
        pre_exprs = [
            ir.ColumnRef(inner_scope.fields[ch].type, ch) for ch in corr_inner
        ]
        pre_names = [f"ck{i}" for i in range(k)]
        calls: List[P.AggregateCall] = []
        for a in agg_calls:
            if a.is_star:
                calls.append(P.AggregateCall("count", None, T.BIGINT))
                continue
            if a.name in P._TWO_ARG_AGGS:
                raise PlanningError(
                    f"{a.name} in a correlated scalar subquery: not supported")
            arg_ir = ExprAnalyzer(inner_scope).analyze(a.args[0])
            param = None
            if a.name == "approx_percentile":
                if len(a.args) != 2:
                    raise PlanningError("approx_percentile expects 2 arguments")
                param = _constant_fraction(
                    ExprAnalyzer(inner_scope).analyze(a.args[1]),
                    "approx_percentile")
            calls.append(
                P.AggregateCall(
                    a.name, len(pre_exprs),
                    aggregate_result_type(a.name, arg_ir.type),
                    distinct=a.distinct, param=param,
                )
            )
            pre_exprs.append(arg_ir)
            pre_names.append(f"aggarg{len(calls) - 1}")
        pre = P.ProjectNode(inner_node, pre_exprs, pre_names)
        agg_node = P.AggregationNode(
            pre, list(range(k)), calls, step="single",
            names=pre_names[:k] + [f"aggval{i}" for i in range(len(calls))],
        )
        # the select item may be an expression over the aggregates
        # (e.g. Q17's ``0.2 * avg(l_quantity)``): substitute agg calls with
        # their output channels and project the value alongside the keys
        agg_fields = [Field(None, t, None) for t in agg_node.output_types]
        repl = {
            a: ir.ColumnRef(calls[i].output_type, k + i) for i, a in enumerate(agg_calls)
        }
        value_ir = ExprAnalyzer(Scope(agg_fields, None), repl).analyze(
            spec.select_items[0].expr
        )
        value_proj = P.ProjectNode(
            agg_node,
            [ir.ColumnRef(agg_node.output_types[i], i) for i in range(k)] + [value_ir],
            pre_names[:k] + ["value"],
        )
        nleft = len(scope.fields)
        join = P.JoinNode(
            join_type="inner", left=node, right=value_proj,
            left_keys=corr_outer, right_keys=list(range(k)),
            right_unique=True,
        )
        # predicate: left <op> value
        ext_fields = scope.fields + [Field(None, t, "$sub") for t in value_proj.output_types]
        ext_scope = Scope(ext_fields, scope.parent)
        left_ir = ExprAnalyzer(ext_scope, replacements).analyze(conj.left)
        from trino_tpu_torch.sql.analyzer.expr_analyzer import _COMPARISON_OPS

        pred = ir.Call(
            T.BOOLEAN,
            _COMPARISON_OPS[conj.op],
            (left_ir, ir.ColumnRef(value_ir.type, nleft + k)),
        )
        filt = P.FilterNode(join, pred)
        proj = P.ProjectNode(
            filt,
            [ir.ColumnRef(fl.type, i, fl.name or "") for i, fl in enumerate(scope.fields)],
            [fl.name or f"_c{i}" for i, fl in enumerate(scope.fields)],
        )
        return proj, scope, True


def _derive_name(e: ast.Expression) -> Optional[str]:
    if isinstance(e, ast.Identifier):
        return e.parts[-1]
    if isinstance(e, ast.FunctionCall):
        return e.name
    return None


def _cast_to(node: P.PlanNode, types: List[T.Type], names: List[str]) -> P.PlanNode:
    """Project ``node`` onto exactly ``types`` (identity when it matches)."""
    src_types = node.output_types
    if list(src_types) == list(types):
        return node
    exprs = [
        ir.ColumnRef(st, i) if st == t else ir.Cast(t, ir.ColumnRef(st, i))
        for i, (st, t) in enumerate(zip(src_types, types))
    ]
    return P.ProjectNode(node, exprs, list(names))


def _fold_constant(e: ir.Expr) -> Optional[ir.Constant]:
    """Constant-fold the VALUES-expression subset: literals, unary negate,
    and casts of literals (reference: IrExpressionOptimizer, minimally)."""
    if isinstance(e, ir.Constant):
        return e
    if isinstance(e, ir.Call) and e.name == "negate" and len(e.args) == 1:
        inner = _fold_constant(e.args[0])
        if inner is not None and inner.value is not None:
            return ir.Constant(e.type, -inner.value)
        return inner
    if isinstance(e, ir.Cast):
        inner = _fold_constant(e.value)
        if inner is None or inner.value is None:
            return inner
        # apply the cast NOW (rescale to the target type's repr) so the
        # constant's type tag matches its repr — relabeling without
        # rescaling shifts values by powers of ten
        return ir.Constant(e.type, _rescale(inner, e.type))
    if isinstance(e, ir.Call) and e.name in ("add", "sub", "mul") \
            and len(e.args) == 2 and e.type.is_integer_kind:
        # integer arithmetic over constants (inlined routine bodies reach
        # constant contexts like table-function arguments)
        a = _fold_constant(e.args[0])
        b = _fold_constant(e.args[1])
        if a is None or b is None or a.value is None or b.value is None:
            return None
        op = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
              "mul": lambda x, y: x * y}[e.name]
        return ir.Constant(e.type, op(int(a.value), int(b.value)))
    return None


def _constant_fraction(e: ir.Expr, fn: str) -> float:
    """A numeric constant in [0, 1] (e.g. the percentile argument)."""
    if not isinstance(e, ir.Constant) or e.value is None:
        raise PlanningError(f"{fn}: percentile must be a constant")
    v = float(e.value)
    if e.type.is_decimal:
        v /= 10 ** e.type.scale
    if not 0.0 <= v <= 1.0:
        raise PlanningError(f"{fn}: percentile must be between 0 and 1")
    return v


def _rescale(c: ir.Constant, target: T.Type):
    """Convert a constant's storage repr to the target column type's repr
    (int -> scaled decimal, decimal scale change, int -> float,
    timestamp precision change, date -> timestamp)."""
    v = c.value
    if v is None:
        return None
    if isinstance(target, T.TimestampType):
        # unit counts rescale like decimal scales; DATE promotes through
        # UTC midnight
        if c.type == T.DATE:
            return int(v) * 86_400 * 10**target.precision
        assert isinstance(c.type, T.TimestampType), c.type
        dp = target.precision - c.type.precision
        return int(v) * 10**dp if dp >= 0 else int(v) // 10**(-dp)
    if target.is_decimal:
        if c.type.is_floating or isinstance(v, float):
            # scale BEFORE integer conversion, half away from zero
            # (int(1.5) * 10**s would truncate the fraction entirely)
            scaled = float(v) * (10 ** target.scale)
            q = int(abs(scaled) + 0.5)
            return q if scaled >= 0 else -q
        src_scale = c.type.scale if c.type.is_decimal else 0
        if target.scale >= src_scale:
            return int(v) * (10 ** (target.scale - src_scale))
        # narrowing: round half away from zero, the reference's CAST
        # semantics (Int128Math.rescale / DecimalOperators)
        p = 10 ** (src_scale - target.scale)
        iv = int(v)
        q, r = divmod(abs(iv), p)
        q += 1 if 2 * r >= p else 0
        return q if iv >= 0 else -q
    if target.is_floating and not isinstance(v, float):
        scale = c.type.scale if c.type.is_decimal else 0
        return float(v) / (10 ** scale)
    if c.type.is_decimal and not target.is_decimal:
        # integer target: unscale with half-away-from-zero rounding
        # (reference: DecimalCasts round, not truncate)
        p = 10 ** c.type.scale
        iv = int(v)
        q, r = divmod(abs(iv), p)
        q += 1 if 2 * r >= p else 0
        return q if iv >= 0 else -q
    return v
