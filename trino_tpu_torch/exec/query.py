"""Statement lifecycle: parse -> analyze/plan -> optimize -> execute (the port
of trino_tpu/exec/query.py for the local path).

Ported statements: ``Query``; EXPLAIN (logical) and EXPLAIN ANALYZE
[VERBOSE]; CREATE TABLE, CREATE TABLE AS, INSERT, DELETE, UPDATE and DROP
TABLE (the DML runs its rewrite SELECT on the session's device and writes
the rows through the connector, which bumps the table's data_version);
CREATE and DROP FUNCTION; PREPARE, EXECUTE and DEALLOCATE; CALL; START
TRANSACTION, COMMIT and ROLLBACK; SET, RESET and SHOW SESSION; SHOW
TABLES, SCHEMAS and COLUMNS; EXPLAIN (TYPE DISTRIBUTED) (the fragments of
sql/planner/fragmenter.py); CREATE [OR REPLACE], REFRESH and DROP
MATERIALIZED VIEW (matview/lifecycle.py, the refresh's defining query
running on the session's device). Every SELECT, EXPLAIN and EXPLAIN
ANALYZE goes through the materialized-view substitution pass
(matview/substitute.py) after ``optimize``: a fresh view whose definition
matches a plan subtree is read from its storage table instead.
"""
from __future__ import annotations

import dataclasses
import time

from trino_tpu_torch.exec.executor import Executor, QueryResult
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.sql.parser import ast
from trino_tpu_torch.sql.parser.parser import parse_statement
from trino_tpu_torch.sql.planner.optimizer import optimize
from trino_tpu_torch.sql.planner.plan import format_plan
from trino_tpu_torch.sql.planner.planner import Planner

MATVIEW_STATEMENTS = (ast.CreateMaterializedView, ast.RefreshMaterializedView,
                       ast.DropMaterializedView)


def _expand_udfs(session, stmt):
    udfs = getattr(session, "udfs", None)
    if not udfs:
        return stmt
    from trino_tpu_torch.sql.routines import expand_udfs

    return expand_udfs(stmt, udfs)


def _parse(sql: str):
    with tracing.timed("parse", M.PLAN_SECONDS):
        return parse_statement(sql)


def _plan(session, query):
    """The optimized plan of a ``Query`` AST, its routines inlined.
    Parsing (``_parse``), planning and optimizing each record a span into
    the ambient tracer, when there is one (the coordinator's per-query
    tracer), and add their seconds to ``trino_tpu_plan_seconds_total``."""
    with tracing.timed("analyze/plan", M.PLAN_SECONDS):
        root = Planner(session).plan(_expand_udfs(session, query))
    with tracing.timed("optimize", M.PLAN_SECONDS):
        return optimize(root, session)


def plan_sql(session, sql: str):
    """The optimized plan of a ``Query`` statement; any other statement
    comes back parsed (``run_query`` dispatches it)."""
    stmt = _parse(sql)
    if isinstance(stmt, ast.Explain):
        raise ValueError("use explain_query")
    if not isinstance(stmt, ast.Query):
        return stmt
    return _plan(session, stmt)


def _plan_substituted(session, query):
    """``_plan`` then the materialized-view substitution pass: (the plan to
    run, the substitution notes)."""
    from trino_tpu_torch.matview.substitute import substitute_plan

    return substitute_plan(session, _plan(session, query))


def run_query(session, sql: str) -> QueryResult:
    return _dispatch_statement(session, _parse(sql), sql=sql)


def dispatch_statement(session, stmt) -> QueryResult:
    """Run an already-parsed statement (the coordinator's EXECUTE path
    dispatches the bound prepared AST without parsing again)."""
    return _dispatch_statement(session, stmt)


def _execute_rows(session, query):
    """(plan root, live rows as Python tuples) of a query AST."""
    root = _plan(session, query)
    page = Executor(session).execute_checked(root)
    return root, page.to_pylist()


def bind_parameters(stmt, params):
    """Substitute ``?`` placeholders with the EXECUTE ... USING expressions
    (reference: planner/ParameterRewriter): a generic rewrite over the
    frozen AST. Arity must match exactly."""
    from trino_tpu_torch.server.prepared import count_parameters

    need = count_parameters(stmt)
    if len(params) != need:
        raise ValueError(
            f"prepared statement expects {need} parameters, "
            f"got {len(params)}")

    def rewrite(node):
        if isinstance(node, ast.Parameter):
            return params[node.index]
        if isinstance(node, tuple):
            return tuple(rewrite(x) for x in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            changes = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                nv = rewrite(v)
                if nv is not v:
                    changes[f.name] = nv
            return dataclasses.replace(node, **changes) if changes else node
        return node

    return rewrite(stmt)


def _result(word):
    return QueryResult(["result"], [], [(word,)])


def _dispatch_statement(session, stmt, sql=None) -> QueryResult:
    if isinstance(stmt, ast.Explain):
        if stmt.analyze:
            text = explain_analyze(session, stmt.statement, verbose=stmt.verbose)
        else:
            text = explain_query(session, None, stmt.mode, stmt=stmt.statement)
        return QueryResult(["Query Plan"], [], [(line,) for line in text.split("\n")])
    if isinstance(stmt, ast.CreateTable):
        return _create_table(session, stmt)
    if isinstance(stmt, ast.CreateTableAs):
        return _create_table_as(session, stmt)
    if isinstance(stmt, ast.Insert):
        return _insert(session, stmt)
    if isinstance(stmt, ast.DropTable):
        return _drop_table(session, stmt)
    if isinstance(stmt, MATVIEW_STATEMENTS):
        # the embedded path runs the REFRESH's defining query on the local
        # executor; the coordinator takes these statements earlier, to run
        # the refresh through its distributed path
        from trino_tpu_torch.matview import lifecycle as mv_lifecycle

        columns, rows = mv_lifecycle.dispatch_mv_statement(session, stmt, sql=sql)
        return QueryResult(columns, [], rows)
    if isinstance(stmt, ast.Delete):
        return _delete(session, stmt)
    if isinstance(stmt, ast.Update):
        return _update(session, stmt)
    if isinstance(stmt, ast.CreateFunction):
        from trino_tpu_torch.sql.routines import RoutineError, UdfDef, expand_udfs, validate

        name = stmt.name[-1].lower()
        if name in session.udfs and not stmt.or_replace:
            raise RoutineError(f"function already exists: {name}")
        # early binding: routine calls inside the body expand at creation
        body = expand_udfs(stmt.body, session.udfs)
        udf = UdfDef(name, tuple(stmt.params), stmt.returns, body)
        validate(udf)
        session.udfs[name] = udf
        return _result("CREATE FUNCTION")
    if isinstance(stmt, ast.DropFunction):
        name = stmt.name[-1].lower()
        if name not in session.udfs:
            if stmt.if_exists:
                return _result("DROP FUNCTION")
            raise ValueError(f"function not found: {name}")
        del session.udfs[name]
        return _result("DROP FUNCTION")
    if isinstance(stmt, ast.Prepare):
        # stored parsed; parameters bind at EXECUTE time
        session.prepared_statements[stmt.name] = stmt.statement
        return _result("PREPARE")
    if isinstance(stmt, ast.ExecutePrepared):
        prepared = session.prepared_statements.get(stmt.name)
        if prepared is None:
            raise ValueError(f"prepared statement not found: {stmt.name}")
        return _dispatch_statement(session, bind_parameters(prepared, stmt.params))
    if isinstance(stmt, ast.Deallocate):
        if stmt.name not in session.prepared_statements:
            raise ValueError(f"prepared statement not found: {stmt.name}")
        del session.prepared_statements[stmt.name]
        return _result("DEALLOCATE")
    if isinstance(stmt, ast.Call):
        return _call_procedure(session, stmt)
    if isinstance(stmt, ast.StartTransaction):
        from trino_tpu_torch.exec import transaction as txn_mod

        txn_mod.begin(session)
        return _result("START TRANSACTION")
    if isinstance(stmt, (ast.Commit, ast.Rollback)):
        txn = session.transaction
        if txn is None:
            raise ValueError("no transaction in progress")
        if isinstance(stmt, ast.Commit):
            txn.commit()
            return _result("COMMIT")
        txn.rollback()
        return _result("ROLLBACK")
    if isinstance(stmt, ast.SetSession):
        session.set_property(stmt.name, stmt.value)
        return _result("SET SESSION")
    if isinstance(stmt, ast.ResetSession):
        from trino_tpu_torch.client.properties import SYSTEM_SESSION_PROPERTIES

        meta = SYSTEM_SESSION_PROPERTIES.get(stmt.name)
        if meta is None:
            raise ValueError(f"session property '{stmt.name}' does not exist")
        if meta.default is None:
            session.properties.pop(stmt.name, None)
        else:
            session.properties[stmt.name] = meta.default
        return _result("RESET SESSION")
    if isinstance(stmt, ast.ShowSession):
        from trino_tpu_torch.client.properties import SYSTEM_SESSION_PROPERTIES

        rows = [
            (name, str(session.properties.get(name, meta.default)),
             str(meta.default), meta.py_type.__name__, meta.description)
            for name, meta in sorted(SYSTEM_SESSION_PROPERTIES.items())
        ]
        return QueryResult(["Name", "Value", "Default", "Type", "Description"], [], rows)
    if isinstance(stmt, ast.ShowTables):
        return _show_tables(session, stmt)
    if isinstance(stmt, ast.ShowSchemas):
        return _show_schemas(session, stmt)
    if isinstance(stmt, ast.ShowColumns):
        return _show_columns(session, stmt)
    if not isinstance(stmt, ast.Query):
        raise ValueError(f"unsupported statement {type(stmt).__name__}")
    root, _mv_notes = _plan_substituted(session, stmt)
    page = Executor(session).execute_checked(root)
    return QueryResult(root.column_names, page.columns, page.to_pylist())


def mv_notes_header(notes) -> str:
    """EXPLAIN header lines for the materialized-view substitution
    decisions: the scan annotation shows where a view substituted; these
    lines show the freshness verdict (fallbacks included, which leave no
    mark on the plan)."""
    lines = []
    for n in notes or ():
        if n["result"] == "substituted":
            extra = f" (prefix {n['prefix']} columns)" if n.get("prefix") else ""
            lines.append(f"Materialized view {n['view']}: substituted{extra}")
        else:
            lines.append(f"Materialized view {n['view']}: fallback "
                         f"({n['result']}: {n['reason']})")
    return "\n".join(lines) + "\n" if lines else ""


def explain_query(session, sql, mode: str = "logical", stmt=None) -> str:
    """EXPLAIN: the optimized plan's text (sql/planner/plan.py
    ``format_plan``), after the materialized-view substitution pass, under
    a header line for each substitution decision."""
    if stmt is None:
        stmt = _parse(sql)
        if isinstance(stmt, ast.Explain):
            mode = stmt.mode
            stmt = stmt.statement
    root, mv_notes = _plan_substituted(session, stmt)
    header = mv_notes_header(mv_notes)
    if mode == "distributed":
        from trino_tpu_torch.sql.planner.fragmenter import fragment_plan, format_fragments

        return header + format_fragments(fragment_plan(root, session))
    return header + format_plan(root)


def explain_analyze(session, stmt, verbose: bool = False) -> str:
    """EXPLAIN ANALYZE: execute with per-operator stats on, then print the
    plan annotated with them (reference: ExplainAnalyzeOperator +
    PlanPrinter stats injection). The header's wall time covers planning
    and execution. ``verbose`` adds per-node bytes, peaks and dispatch
    ledger, and a device line: rows staged, the compiled tier's
    compile-cache hits and misses over the run (process-wide: the eager
    run itself moves neither), and the host seconds of dynamic filtering.
    A fresh materialized view substitutes first, under its header line."""
    from trino_tpu_torch.exec.operator_stats import wall_time_header
    from trino_tpu_torch.obs import metrics as M

    t_plan = time.perf_counter()
    root, mv_notes = _plan_substituted(session, stmt)
    plan_s = time.perf_counter() - t_plan
    ex = Executor(session)
    hits0, misses0 = M.COMPILE_CACHE_HITS.value(), M.COMPILE_CACHE_MISSES.value()
    t0 = time.perf_counter()
    ex.execute_checked(root)
    exec_s = time.perf_counter() - t0
    header = [wall_time_header(plan_s, exec_s)]
    if ex.memory.budget is not None:
        header.append(
            f"Device memory budget: {ex.memory.budget // 1024}KiB,"
            f" peak working set: {ex.memory.peak // 1024}KiB,"
            f" spills: {len(ex.memory.spills)}")
    else:
        header.append(f"Peak working set: {ex.memory.peak // 1024}KiB (no budget)")
    if verbose:
        staged = sum(ex.scan_stats.values())
        header.append(
            f"Device detail: staged rows={staged},"
            f" compile cache hits/misses (process-wide during run)="
            f"{int(M.COMPILE_CACHE_HITS.value() - hits0)}/"
            f"{int(M.COMPILE_CACHE_MISSES.value() - misses0)},"
            f" dynamic-filter host seconds={ex.df_apply_s * 1e3:.1f}ms")
    return (mv_notes_header(mv_notes) + "\n".join(header) + "\n"
            + format_plan(root, executor=ex, verbose=verbose))


def _default_parts(session, parts):
    """(catalog, schema, name) of a one- to three-part name, the missing
    parts from the session's catalog and schema."""
    parts = [p.lower() for p in parts]
    catalog = session.properties.get("catalog", "tpch")
    schema = session.properties.get("schema", "tiny")
    if len(parts) == 3:
        catalog, schema, name = parts
    elif len(parts) == 2:
        schema, name = parts
    else:
        (name,) = parts
    return catalog, schema, name


def _resolve_table_name(session, parts, write: bool = False):
    catalog, schema, table = _default_parts(session, parts)
    if catalog not in session.catalogs:
        raise ValueError(f"catalog not found: {catalog}")
    if write:
        session.access_control.check_can_write(session.identity, catalog, schema, table)
        if session.transaction is not None:
            # writes inside an explicit transaction go to its overlay
            session.transaction.enlist(catalog)
    return session.catalogs[catalog], catalog, schema, table


def _call_procedure(session, stmt):
    """CALL catalog.schema.procedure(args...) (reference:
    execution/CallTask): the procedure resolves through the connector, its
    arguments analyze against an empty scope and must fold to constants."""
    from trino_tpu_torch.sql.analyzer.expr_analyzer import ExprAnalyzer
    from trino_tpu_torch.sql.analyzer.scope import Scope
    from trino_tpu_torch.sql.planner.planner import _fold_constant

    catalog, schema, proc = _default_parts(session, stmt.name)
    conn = session.catalogs.get(catalog)
    if conn is None:
        raise ValueError(f"catalog not found: {catalog}")
    fn = conn.procedure(schema, proc)
    if fn is None:
        raise ValueError(f"procedure not registered: {catalog}.{schema}.{proc}")
    analyzer = ExprAnalyzer(Scope([], None))
    values = []
    for e in stmt.args:
        c = _fold_constant(analyzer.analyze(e))
        if c is None:
            raise ValueError(f"CALL {catalog}.{schema}.{proc}: arguments must be constants")
        v = c.value
        if v is not None and c.type.is_decimal:
            v = float(v) / (10 ** c.type.scale)
        values.append(v)
    message = fn(session, *values)
    return QueryResult(["result"], [], [(message or "CALL",)])


def _show_tables(session, stmt):
    catalog = session.properties.get("catalog", "tpch")
    schema = session.properties.get("schema", "tiny")
    if stmt.schema:
        parts = stmt.schema
        catalog = parts[0] if len(parts) == 2 else catalog
        schema = parts[-1]
    rows = [(t,) for t in session.catalogs[catalog].list_tables(schema)]
    return QueryResult(["Table"], [], rows)


def _show_schemas(session, stmt):
    catalog = stmt.catalog or session.properties.get("catalog", "tpch")
    conn = session.catalogs[catalog]
    return QueryResult(["Schema"], [], [(s,) for s in conn.list_schemas()])


def _show_columns(session, stmt):
    catalog, schema, table = _default_parts(session, stmt.table)
    meta = session.catalogs[catalog].get_table(schema, table)
    if meta is None:
        raise ValueError(f"table not found: {table}")
    return QueryResult(["Column", "Type"], [], [(c.name, str(c.type)) for c in meta.columns])


def _create_table(session, stmt):
    """CREATE TABLE (reference: execution/CreateTableTask.java)."""
    from trino_tpu_torch import types as T

    conn, _catalog, schema, table = _resolve_table_name(session, stmt.name, write=True)
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
    conn, _catalog, schema, table = _resolve_table_name(session, stmt.name, write=True)
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
    conn, _catalog, schema, table = _resolve_table_name(session, stmt.name, write=True)
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
    conn, catalog, schema, table = _resolve_table_name(session, stmt.name, write=True)
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

    conn, catalog, schema, table = _resolve_table_name(session, stmt.name, write=True)
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
    conn, _catalog, schema, table = _resolve_table_name(session, stmt.name, write=True)
    if conn.get_table(schema, table) is None:
        if stmt.if_exists:
            return QueryResult(["result"], [], [("DROP TABLE",)])
        raise ValueError(f"table not found: {schema}.{table}")
    conn.drop_table(schema, table)
    return QueryResult(["result"], [], [("DROP TABLE",)])
