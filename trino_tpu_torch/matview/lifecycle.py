"""Materialized-view lifecycle: CREATE / REFRESH / DROP execution (the
port of trino_tpu/matview/lifecycle.py).

Reference: ``execution/CreateMaterializedViewTask`` +
``RefreshMaterializedViewTask`` — there REFRESH plans an INSERT-overwrite
of the storage table through the connector's ``beginRefreshMaterializedView``
handshake; here the defining query executes through the engine's normal
path (the coordinator passes its distributed ``_execute_query`` as
``execute_fn``; embedded sessions run the local executor) and the result
swaps into the storage table via the plain connector write SPI
(``create_table``/``overwrite_rows``/``drop_table`` — any writable
catalog can host MV storage).

Freshness bookkeeping is the whole point of the swap protocol:

1. plan the definition (plan-time access control re-fires for the
   refreshing principal) and capture every base table's ``data_version``
   BEFORE executing — a base mutation DURING the refresh then leaves the
   recorded versions behind the connector's current token, so the view
   lands stale, never wrong;
2. execute, overwrite the storage table (recreating it when the
   definition's column shape drifted), and read the storage version the
   write produced;
3. publish versions + the recomputed canonical match keys in ONE locked
   registry write (``MaterializedViewRegistry.publish_refresh``) — a
   concurrent substitution sees pre- or post-refresh state, never a mix;
4. optionally pre-stage the new storage into the device cache on the
   session's device (``device_cache_enabled`` sessions) so the first
   post-refresh substituted query stages 0 rows. The warm is best-effort
   but counted: ``MV_WARM_ROWS`` and ``MV_WARM_FAILURES`` in
   obs/metrics.py.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import time
from typing import List, Optional, Tuple

from trino_tpu_torch.matview.registry import (
    MaterializedView, MaterializedViewRegistry)
from trino_tpu_torch.sql.parser import ast

# select-item prefixes beyond this width are not precomputed as match
# keys (the stretch projection-subsumption match); the full-width exact
# match always works
MAX_PREFIX_WIDTH = 12

_DEFINITION_RE = re.compile(
    r"(?is)^\s*create\s+(?:or\s+replace\s+)?materialized\s+view\s+"
    r"(?:if\s+not\s+exists\s+)?\S+\s+as\s+(.*?);?\s*$")


def definition_sql_of(sql: Optional[str]) -> Optional[str]:
    """The defining query's text, stripped from the rigid CREATE prefix
    when the statement matches it; statements the regex cannot take
    apart (leading comments, exotic quoting) keep their FULL text —
    ``from_payload`` unwraps the CREATE statement's query at parse time,
    so replication never silently skips a legal statement."""
    if not sql:
        return None
    m = _DEFINITION_RE.match(sql)
    return m.group(1).strip() if m else sql.strip()


def registry_of(session) -> MaterializedViewRegistry:
    reg = getattr(session, "matviews", None)
    if reg is None:
        raise ValueError(
            "materialized views are not available in this session")
    return reg


def resolve_mv_name(session, parts) -> Tuple[str, str, str]:
    """Qualified (catalog, schema, name) with session defaults applied —
    same resolution as table names (exec/query._resolve_table_name)."""
    parts = [p.lower() for p in parts]
    catalog = str(session.properties.get("catalog", "tpch"))
    schema = str(session.properties.get("schema", "tiny"))
    if len(parts) == 3:
        catalog, schema, name = parts
    elif len(parts) == 2:
        schema, name = parts
    else:
        (name,) = parts
    return catalog, schema, name


def _writable(conn) -> bool:
    """Does this connector implement the write SPI (CREATE TABLE)?"""
    from trino_tpu_torch.connector import spi

    return type(conn).create_table is not spi.Connector.create_table


def _storage_location(session, catalog: str, schema: str) -> Tuple[str, str]:
    """Where the MV's storage table lives: the view's own catalog when
    writable, else the ``materialized_view_storage_catalog`` session
    property (default: the in-memory connector)."""
    conn = session.catalogs.get(catalog)
    if conn is not None and _writable(conn):
        return catalog, schema
    fallback = str(session.properties.get(
        "materialized_view_storage_catalog", "memory"))
    fconn = session.catalogs.get(fallback)
    if fconn is None or not _writable(fconn):
        raise ValueError(
            f"no writable catalog for materialized-view storage: "
            f"{catalog} does not support CREATE TABLE and the "
            f"materialized_view_storage_catalog fallback "
            f"'{fallback}' is "
            + ("not registered" if fconn is None else "not writable"))
    return fallback, schema


@contextlib.contextmanager
def _definition_defaults(session, mv: MaterializedView):
    """Plan the definition under the CREATOR's name-resolution defaults:
    an unqualified table in the definition must keep meaning what it
    meant at CREATE time, whichever session later refreshes/expands."""
    saved = (session.properties.get("catalog"),
             session.properties.get("schema"))
    session.properties["catalog"] = mv.default_catalog
    session.properties["schema"] = mv.default_schema
    try:
        yield
    finally:
        session.properties["catalog"], session.properties["schema"] = saved


def plan_definition(session, mv: MaterializedView):
    """Optimized plan of the defining query as the CURRENT principal
    (plan-time access control on every base table re-fires here)."""
    from trino_tpu_torch.sql.planner.optimizer import optimize
    from trino_tpu_torch.sql.planner.planner import Planner

    stmt = mv.definition
    udfs = getattr(session, "udfs", None)
    if udfs:
        from trino_tpu_torch.sql.routines import expand_udfs

        stmt = expand_udfs(stmt, udfs)
    with _definition_defaults(session, mv):
        root = Planner(session).plan(stmt)
        return optimize(root, session)


def _match_keys(session, mv: MaterializedView, root):
    """The canonical match key of the optimized definition plus the
    prefix-projection variants: for each leading select-item prefix of a
    plain QuerySpec definition, plan+optimize the prefix query through
    the very pipeline a user query takes, so its canonical equals what a
    ``SELECT <first k items> ...`` query optimizes to. Prefixes that
    fail to plan (or collapse to the full canonical) are skipped — the
    stretch match is purely additive."""
    from trino_tpu_torch.cache.plan_key import canonicalize_plan
    from trino_tpu_torch.sql.planner import plan as P

    src = root.source if isinstance(root, P.OutputNode) else root
    canonical = canonicalize_plan(src)
    prefixes = {}
    q = mv.definition
    body = q.body if isinstance(q, ast.Query) else None
    width = len(mv.column_names)
    eligible = (
        isinstance(body, ast.QuerySpec)
        and not q.order_by and q.limit is None
        and 1 < width <= MAX_PREFIX_WIDTH
        and not any(isinstance(it.expr, ast.Star)
                    for it in body.select_items)
    )
    if eligible:
        from trino_tpu_torch.sql.planner.optimizer import optimize
        from trino_tpu_torch.sql.planner.planner import Planner

        for k in range(1, width):
            pq = ast.Query(
                body=dataclasses.replace(
                    body, select_items=body.select_items[:k]),
                with_queries=q.with_queries)
            try:
                with _definition_defaults(session, mv):
                    proot = optimize(Planner(session).plan(pq), session)
            except Exception:  # noqa: BLE001 — prefix match is optional
                continue
            psrc = proot.source
            if list(psrc.output_types) != list(mv.column_types[:k]):
                continue
            c = canonicalize_plan(psrc)
            if c != canonical:
                prefixes[c] = k
    return canonical, prefixes


def _check_definition(session, stmt_query, root) -> None:
    """CREATE-time validation: the definition must be deterministic (a
    cached result would freeze random()/now()), must scan only versioned
    tables (an unversioned base can never prove freshness), and must
    produce uniquely named columns (they become storage columns)."""
    from trino_tpu_torch.cache.determinism import uncachable_reason
    from trino_tpu_torch.cache.plan_key import capture_versions

    reason = uncachable_reason(stmt_query, root)
    if reason is not None:
        raise ValueError(
            f"materialized view definition is not materializable: "
            f"{reason}")
    if capture_versions(session, root) is None:
        raise ValueError(
            "materialized view definition scans an unversioned table — "
            "freshness could never be decided")
    names = [n.lower() for n in root.column_names]
    if len(set(names)) != len(names) or any(not n for n in names):
        raise ValueError(
            "materialized view definition must produce uniquely named "
            f"columns, got {names} — alias the select items")


def create_materialized_view(session, stmt, sql: Optional[str] = None,
                             execute_fn=None,
                             warm: bool = True) -> Tuple[List[str], list]:
    """CREATE [OR REPLACE] MATERIALIZED VIEW: validate + register the
    definition, then (by default) run the initial REFRESH so the view is
    born fresh. Returns ``(columns, rows)`` for the statement result."""
    registry = registry_of(session)
    if stmt.or_replace and stmt.not_exists:
        raise ValueError(
            "CREATE MATERIALIZED VIEW cannot combine OR REPLACE and "
            "IF NOT EXISTS")
    catalog, schema, name = resolve_mv_name(session, stmt.name)
    existing = registry.get(catalog, schema, name)
    if existing is not None:
        if stmt.not_exists:
            return ["result"], [("CREATE MATERIALIZED VIEW",)]
        if not stmt.or_replace:
            raise ValueError(
                f"materialized view already exists: "
                f"{catalog}.{schema}.{name}")
    mv = MaterializedView(
        catalog=catalog, schema=schema, name=name,
        definition_sql=definition_sql_of(sql),
        definition=stmt.query,
        owner=getattr(getattr(session, "identity", None), "user",
                      "anonymous"),
        default_catalog=str(session.properties.get("catalog", "tpch")),
        default_schema=str(session.properties.get("schema", "tiny")),
    )
    root = plan_definition(session, mv)
    _check_definition(session, stmt.query, root)
    mv.column_names = tuple(n.lower() for n in root.column_names)
    mv.column_types = tuple(root.source.output_types)
    scat, sschema = _storage_location(session, catalog, schema)
    mv.storage_catalog, mv.storage_schema = scat, sschema
    # fallback-catalog storage qualifies the VIEW's catalog into the
    # table name: same-named views of two unwritable catalogs must never
    # fight over one storage table
    mv.storage_table = (f"{name}$storage" if scat == catalog
                        else f"{name}${catalog}$storage")
    ac = getattr(session, "access_control", None)
    if ac is not None:
        ac.check_can_write(session.identity, scat, sschema,
                           mv.storage_table)
    refresh = str(session.properties.get(
        "materialized_view_refresh_on_create", True)).lower() not in (
        "false", "0", "no")
    same_storage = existing is not None and (
        existing.storage_catalog, existing.storage_schema,
        existing.storage_table) == (
        mv.storage_catalog, mv.storage_schema, mv.storage_table)
    if refresh:
        # the initial refresh runs BEFORE the registry swap: a failed
        # CREATE [OR REPLACE] leaves the previous view registered (its
        # version check marks it stale if the shared storage was partly
        # overwritten — stale, never wrong) instead of destroying it
        try:
            refresh_materialized_view(session, mv, execute_fn=execute_fn,
                                      planned_root=root, warm=warm)
        except BaseException:
            if not same_storage:  # never drop a replaced view's storage
                _drop_storage(session, mv)
            raise
    if existing is not None:
        if not same_storage:  # OR REPLACE into a new location: retire
            _drop_storage(session, existing)
        registry.remove(catalog, schema, name)
    registry.put(mv)
    return ["result"], [("CREATE MATERIALIZED VIEW",)]


def refresh_materialized_view(session, mv_or_parts, execute_fn=None,
                              planned_root=None,
                              warm: bool = True) -> Tuple[List[str], list]:
    """REFRESH MATERIALIZED VIEW: execute the definition through
    ``execute_fn`` (default: the local executor) and atomically swap the
    storage table + freshness record. Returns the statement result with
    the refreshed row count."""
    from trino_tpu_torch.cache.plan_key import capture_versions
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.obs import trace as tracing

    registry = registry_of(session)
    if isinstance(mv_or_parts, MaterializedView):
        mv = mv_or_parts
    else:
        catalog, schema, name = resolve_mv_name(session, mv_or_parts)
        mv = registry.get(catalog, schema, name)
        if mv is None:
            raise ValueError(
                f"materialized view not found: {catalog}.{schema}.{name}")
    t0 = time.perf_counter()
    with tracing.span("mv/refresh") as sp:
        sp.set("view", mv.qualified)
        root = (planned_root if planned_root is not None
                else plan_definition(session, mv))
        # versions captured BEFORE execution: a base mutation during the
        # refresh leaves these behind the current token => stale, not
        # wrong
        versions = capture_versions(session, root)
        if versions is None:
            raise ValueError(
                f"materialized view {mv.qualified} scans an unversioned "
                "table — cannot refresh")
        if execute_fn is not None:
            rows = execute_fn(root)
        else:
            from trino_tpu_torch.exec.executor import Executor

            rows = Executor(session).execute_checked(root).to_pylist()
        mv.column_names = tuple(n.lower() for n in root.column_names)
        mv.column_types = tuple(root.source.output_types)
        storage_version = _swap_storage(session, mv, rows)
        canonical, prefixes = _match_keys(session, mv, root)
        registry.publish_refresh(mv, versions, storage_version,
                                 canonical, prefixes)
        elapsed = time.perf_counter() - t0
        M.MV_REFRESH_SECONDS.observe(elapsed)
        sp.set("rows", len(rows))
        sp.set("storage", mv.storage_qualified)
        # the caller opts out of the warm scan when substituted SELECTs do
        # not run in this process (the coordinator under the executor-
        # process plane): warming its device cache would stage a table no
        # query here scans
        warmed = _warm_storage(session, mv) if warm else 0
        if warmed:
            sp.set("warmed_rows", warmed)
    return ["rows"], [(len(rows),)]


def _swap_storage(session, mv: MaterializedView, rows) -> str:
    """Overwrite (or [re]create, when the column shape drifted) the
    storage table and return its post-write data version."""
    sconn = session.catalogs.get(mv.storage_catalog)
    if sconn is None:
        raise ValueError(
            f"storage catalog not found: {mv.storage_catalog}")
    ac = getattr(session, "access_control", None)
    if ac is not None:
        ac.check_can_write(session.identity, mv.storage_catalog,
                           mv.storage_schema, mv.storage_table)
    schema_def = list(zip(mv.column_names, mv.column_types))
    meta = sconn.get_table(mv.storage_schema, mv.storage_table)
    if meta is not None and [
            (c.name, c.type) for c in meta.columns] != schema_def:
        sconn.drop_table(mv.storage_schema, mv.storage_table)
        meta = None
    if meta is None:
        sconn.create_table(mv.storage_schema, mv.storage_table,
                           schema_def, rows)
    else:
        sconn.overwrite_rows(mv.storage_schema, mv.storage_table, rows)
    version = sconn.data_version(mv.storage_schema, mv.storage_table)
    if version is None:
        raise ValueError(
            f"storage catalog {mv.storage_catalog} is unversioned — "
            "cannot host materialized-view storage")
    return str(version)


def _warm_storage(session, mv: MaterializedView) -> int:
    """Device-cache warm-on-refresh: stage the new storage table into the
    device cache on the session's device through the normal executor scan
    path (the same ``TableScanNode``, ``mv_name`` included, so the same
    cache key the first substituted query computes), so that query stages
    0 rows. Gated on the session's ``device_cache_enabled``. Best-effort —
    a refresh never fails because a prefetch did — but never silent: the
    rows staged go to ``MV_WARM_ROWS`` and each swallowed failure to
    ``MV_WARM_FAILURES``."""
    from trino_tpu_torch import devcache
    from trino_tpu_torch.obs import metrics as M

    try:
        if not devcache.cache_enabled(session):
            return 0
        from trino_tpu_torch.exec.executor import Executor
        from trino_tpu_torch.sql.planner import plan as P

        scan = P.TableScanNode(
            catalog=mv.storage_catalog, schema=mv.storage_schema,
            table=mv.storage_table,
            column_names=list(mv.column_names),
            column_types=list(mv.column_types),
            mv_name=mv.qualified,
        )
        page = Executor(session).execute(scan)
        device = getattr(session, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        rows = int(page.num_rows)
    except Exception:  # noqa: BLE001 — prefetch is best-effort, but counted
        M.MV_WARM_FAILURES.inc()
        return 0
    M.MV_WARM_ROWS.inc(rows)
    return rows


def _drop_storage(session, mv: MaterializedView) -> None:
    sconn = session.catalogs.get(mv.storage_catalog)
    if sconn is None:
        return
    try:
        if sconn.get_table(mv.storage_schema, mv.storage_table) is not None:
            sconn.drop_table(mv.storage_schema, mv.storage_table)
    except Exception:  # noqa: BLE001 — registry removal is authoritative
        pass


def drop_materialized_view(session, stmt) -> Tuple[List[str], list]:
    registry = registry_of(session)
    catalog, schema, name = resolve_mv_name(session, stmt.name)
    mv = registry.get(catalog, schema, name)
    if mv is None:
        if stmt.if_exists:
            return ["result"], [("DROP MATERIALIZED VIEW",)]
        raise ValueError(
            f"materialized view not found: {catalog}.{schema}.{name}")
    ac = getattr(session, "access_control", None)
    if ac is not None:
        ac.check_can_write(session.identity, mv.storage_catalog,
                           mv.storage_schema, mv.storage_table)
    _drop_storage(session, mv)
    registry.remove(catalog, schema, name)
    return ["result"], [("DROP MATERIALIZED VIEW",)]


def dispatch_mv_statement(session, stmt, sql: Optional[str] = None,
                          execute_fn=None,
                          warm: bool = True) -> Tuple[List[str], list]:
    """The one entry point statement dispatchers call (exec/query.py
    embedded path; the coordinator passes its distributed execute_fn)."""
    if isinstance(stmt, ast.CreateMaterializedView):
        return create_materialized_view(session, stmt, sql=sql,
                                        execute_fn=execute_fn, warm=warm)
    if isinstance(stmt, ast.RefreshMaterializedView):
        return refresh_materialized_view(session, stmt.name,
                                         execute_fn=execute_fn, warm=warm)
    if isinstance(stmt, ast.DropMaterializedView):
        return drop_materialized_view(session, stmt)
    raise ValueError(f"not a materialized-view statement: {stmt}")


def sync_from_payload(registry: MaterializedViewRegistry,
                      payload: dict) -> str:
    """Apply one replication payload (the executor-process plane's
    ``system.runtime.sync_materialized_view`` procedure body)."""
    from trino_tpu_torch.matview.registry import from_payload

    op = payload.get("op")
    if op == "drop":
        registry.remove(payload["catalog"], payload["schema"],
                        payload["name"])
        return f"dropped {payload['catalog']}.{payload['schema']}.{payload['name']}"
    mv = from_payload(payload)
    registry.put(mv)
    return f"synced {mv.qualified}"
