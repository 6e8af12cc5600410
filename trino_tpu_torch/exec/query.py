"""Query lifecycle: parse -> analyze/plan -> optimize -> execute (the port of
trino_tpu/exec/query.py for ``Query`` statements on the local path)."""
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
    root = plan_sql(session, sql)
    page = Executor(session).execute_checked(root)
    return QueryResult(root.column_names, page.columns, page.to_pylist())
