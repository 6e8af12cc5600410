"""Statement lifecycle: parse -> analyze/plan -> optimize -> execute (the port
of trino_tpu/exec/query.py for the local path).

Ported statements: ``Query``, CREATE TABLE, CREATE TABLE AS, INSERT,
DELETE, UPDATE and DROP TABLE (the DML runs its rewrite SELECT on the
session's device and writes the rows through the connector, which bumps
the table's data_version). Every other statement raises
NotImplementedError.
"""
from __future__ import annotations

from trino_tpu_torch.exec.executor import Executor, QueryResult
from trino_tpu_torch.sql.parser import ast
from trino_tpu_torch.sql.parser.parser import parse_statement
from trino_tpu_torch.sql.planner.optimizer import optimize
from trino_tpu_torch.sql.planner.planner import Planner


def plan_sql(session, sql: str):
    """The optimized plan of a ``Query`` statement."""
    stmt = parse_statement(sql)
    if not isinstance(stmt, ast.Query):
        raise NotImplementedError(f"statement not ported: {type(stmt).__name__}")
    return optimize(Planner(session).plan(stmt), session)


def run_query(session, sql: str) -> QueryResult:
    return _dispatch_statement(session, parse_statement(sql))


def _execute_rows(session, query):
    """(plan root, live rows as Python tuples) of a query AST."""
    root = optimize(Planner(session).plan(query), session)
    page = Executor(session).execute_checked(root)
    return root, page.to_pylist()


def _dispatch_statement(session, stmt) -> QueryResult:
    if isinstance(stmt, ast.CreateTable):
        return _create_table(session, stmt)
    if isinstance(stmt, ast.CreateTableAs):
        return _create_table_as(session, stmt)
    if isinstance(stmt, ast.Insert):
        return _insert(session, stmt)
    if isinstance(stmt, ast.DropTable):
        return _drop_table(session, stmt)
    if isinstance(stmt, ast.Delete):
        return _delete(session, stmt)
    if isinstance(stmt, ast.Update):
        return _update(session, stmt)
    if not isinstance(stmt, ast.Query):
        raise NotImplementedError(f"statement not ported: {type(stmt).__name__}")
    root = optimize(Planner(session).plan(stmt), session)
    page = Executor(session).execute_checked(root)
    return QueryResult(root.column_names, page.columns, page.to_pylist())


def _resolve_table_name(session, parts):
    parts = [p.lower() for p in parts]
    catalog = session.properties.get("catalog", "tpch")
    schema = session.properties.get("schema", "tiny")
    if len(parts) == 3:
        catalog, schema, table = parts
    elif len(parts) == 2:
        schema, table = parts
    else:
        (table,) = parts
    if catalog not in session.catalogs:
        raise ValueError(f"catalog not found: {catalog}")
    return session.catalogs[catalog], catalog, schema, table


def _create_table(session, stmt):
    """CREATE TABLE (reference: execution/CreateTableTask.java)."""
    from trino_tpu_torch import types as T

    conn, _catalog, schema, table = _resolve_table_name(session, stmt.name)
    if conn.get_table(schema, table) is not None:
        if stmt.not_exists:
            return QueryResult(["result"], [], [("CREATE TABLE",)])
        raise ValueError(f"table already exists: {schema}.{table}")
    schema_def = [(n.lower(), T.parse_type(t)) for n, t in stmt.columns]
    conn.create_table(schema, table, schema_def, [])
    return QueryResult(["result"], [], [("CREATE TABLE",)])


def _create_table_as(session, stmt):
    """CTAS: the source query runs on the device and its rows sink through
    the connector's write SPI."""
    conn, _catalog, schema, table = _resolve_table_name(session, stmt.name)
    if conn.get_table(schema, table) is not None:
        if stmt.not_exists:
            return QueryResult(["rows"], [], [(0,)])
        raise ValueError(f"table already exists: {schema}.{table}")
    root, rows = _execute_rows(session, stmt.query)
    schema_def = list(zip([n.lower() for n in root.column_names], root.source.output_types))
    conn.create_table(schema, table, schema_def, rows)
    return QueryResult(["rows"], [], [(len(rows),)])


def _insert(session, stmt):
    """INSERT INTO (reference: execution/InsertTask and the page sink)."""
    conn, _catalog, schema, table = _resolve_table_name(session, stmt.name)
    meta = conn.get_table(schema, table)
    if meta is None:
        raise ValueError(f"table not found: {schema}.{table}")
    root, rows = _execute_rows(session, stmt.query)
    table_cols = [c.name for c in meta.columns]
    src_width = len(root.column_names)
    if stmt.columns:
        named = [c.lower() for c in stmt.columns]
        if len(named) != src_width:
            raise ValueError("INSERT column list does not match query width")
        if len(set(named)) != len(named):
            raise ValueError("INSERT column list contains duplicates")
        for c in named:
            if c not in table_cols:
                raise ValueError(f"insert column does not exist: {c}")
        pos = {c: i for i, c in enumerate(named)}
        # unmentioned columns get NULL
        rows = [tuple(r[pos[c]] if c in pos else None for c in table_cols) for r in rows]
    elif src_width != len(table_cols):
        raise ValueError(
            f"INSERT has {src_width} expressions but table has {len(table_cols)} columns")
    _check_insert_types(meta, stmt.columns, root.source.output_types)
    n = conn.insert_rows(schema, table, rows)
    return QueryResult(["rows"], [], [(n,)])


def _check_insert_types(meta, named_columns, src_types):
    """Reject sources that cannot widen into the target column type: a
    source type is accepted when it is the target or implicitly coerces to
    it (bigint -> decimal is fine, decimal -> bigint is rejected)."""
    from trino_tpu_torch import types as T

    if named_columns:
        targets = [meta.columns[meta.column_index(c.lower())].type for c in named_columns]
    else:
        targets = [c.type for c in meta.columns]
    for i, (src, tgt) in enumerate(zip(src_types, targets)):
        if src == tgt or src == T.UNKNOWN:
            continue
        if T.common_super_type(src, tgt) == tgt:
            continue
        int_digits = {T.INTEGER: 10, T.BIGINT: 19}.get(src)
        if (int_digits is not None and tgt.is_decimal
                and tgt.precision - tgt.scale >= int_digits):
            continue
        raise ValueError(
            f"insert column {i}: mismatched types — query produces {src}, "
            f"table expects {tgt}")


def _delete(session, stmt):
    """DELETE FROM t [WHERE p]: rows where p IS TRUE go; the engine computes
    the kept set (NOT p OR p IS NULL) and the table is overwritten."""
    conn, catalog, schema, table = _resolve_table_name(session, stmt.name)
    meta = conn.get_table(schema, table)
    if meta is None:
        raise ValueError(f"table not found: {schema}.{table}")
    total = conn.table_row_count(schema, table)
    if total is None:
        total = _dml_select_rows(session, catalog, schema, table, meta, count_only=True)
    if stmt.where is None:
        kept = []
    else:
        keep_pred = ast.LogicalBinary("or", ast.Not(stmt.where), ast.IsNull(stmt.where))
        kept = _dml_select_rows(session, catalog, schema, table, meta, where=keep_pred)
    conn.overwrite_rows(schema, table, kept)
    return QueryResult(["rows"], [], [(total - len(kept),)])


def _update(session, stmt):
    """UPDATE t SET c = e [WHERE p]: every row is rewritten as
    CASE WHEN p THEN e ELSE c END per assigned column; assignment types
    must coerce to the column type."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.sql.analyzer.expr_analyzer import ExprAnalyzer
    from trino_tpu_torch.sql.analyzer.scope import Field, Scope

    conn, catalog, schema, table = _resolve_table_name(session, stmt.name)
    meta = conn.get_table(schema, table)
    if meta is None:
        raise ValueError(f"table not found: {schema}.{table}")
    assigns = {c.lower(): e for c, e in stmt.assignments}
    col_types = {m.name: m.type for m in meta.columns}
    scope = Scope([Field(m.name, m.type, table) for m in meta.columns], None)
    analyzer = ExprAnalyzer(scope)
    for c, e in assigns.items():
        if c not in col_types:
            raise ValueError(f"update column does not exist: {c}")
        et = analyzer.analyze(e).type
        target = col_types[c]
        if et == T.UNKNOWN or T.common_super_type(et, target) == target:
            continue
        if et.is_decimal and target.is_decimal:
            # store assignment: decimal precision may narrow (the cast's
            # runtime overflow check protects values that do not fit)
            continue
        raise ValueError(f"UPDATE assignment to {c}: {et} does not coerce to {target}")
    # one scan computes the rewritten rows and the match flag
    rows = _dml_select_rows(session, catalog, schema, table, meta,
                            assigns=assigns, assign_where=stmt.where,
                            with_match_flag=stmt.where is not None)
    if stmt.where is None:
        updated = len(rows)
    else:
        updated = sum(1 for r in rows if r[-1])
        rows = [r[:-1] for r in rows]
    conn.overwrite_rows(schema, table, rows)
    return QueryResult(["rows"], [], [(updated,)])


def _dml_select_rows(session, catalog, schema, table, meta, where=None,
                     assigns=None, assign_where=None, count_only=False,
                     with_match_flag=False):
    """Evaluate a rewrite SELECT built at the AST level over the target
    table: the kept rows of a DELETE, the updated projection of an UPDATE
    (plus an optional match-flag column), or a row count."""
    table_rel = ast.Table((catalog, schema, table))
    if count_only:
        items = (ast.SelectItem(ast.FunctionCall("count", (), is_star=True), "c"),)
    else:
        items = []
        for cm in meta.columns:
            col = ast.Identifier((cm.name,))
            e = col
            if assigns and cm.name in assigns:
                e = (assigns[cm.name] if assign_where is None
                     else ast.SearchedCase(((assign_where, assigns[cm.name]),), col))
                e = ast.Cast(e, str(cm.type))  # keep the column's type
            items.append(ast.SelectItem(e, cm.name))
        if with_match_flag and assign_where is not None:
            items.append(ast.SelectItem(
                ast.SearchedCase(((assign_where, ast.Literal("boolean", True)),),
                                 ast.Literal("boolean", False)), "__match"))
        items = tuple(items)
    q = ast.Query(body=ast.QuerySpec(
        select_items=items, distinct=False, from_=table_rel, where=where,
        group_by=(), having=None))
    _root, rows = _execute_rows(session, q)
    return rows[0][0] if count_only else rows


def _drop_table(session, stmt):
    conn, _catalog, schema, table = _resolve_table_name(session, stmt.name)
    if conn.get_table(schema, table) is None:
        if stmt.if_exists:
            return QueryResult(["result"], [], [("DROP TABLE",)])
        raise ValueError(f"table not found: {schema}.{table}")
    conn.drop_table(schema, table)
    return QueryResult(["result"], [], [("DROP TABLE",)])
