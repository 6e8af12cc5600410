"""Coordinator: discovery, scheduling and the client statement protocol.

The port of trino_tpu/server/coordinator.py, slimmed to the pipelined path
(reference: ``dispatcher/QueuedStatementResource.java:103``,
``execution/SqlQueryExecution.java:393``, ``DiscoveryNodeManager`` +
``HeartbeatFailureDetector``, ``HttpRemoteTask``,
``ExecutingStatementResource``). A client POSTs SQL to ``/v1/statement``
and follows ``nextUri``. A SELECT is planned, cut into fragments
(sql/planner/fragmenter.py) and scheduled: one task per alive worker for
each source fragment (splits round-robin) and each hash fragment (one key
partition a task), all at once, except that a fragment whose join build is
a leaf fragment waits until that build's tasks finished executing (phased
execution). The root single fragment runs on the coordinator's own device,
pulling its inputs through the exchange client, and the rows page back in
the protocol's JSON. Statements other than SELECT, scans of process-local
catalogs (memory) and, with ``short_query_fast_path``, single-stage plans
run on the coordinator alone.

A SELECT goes through the server's logical-plan cache (on by default,
``logical_plan_cache_enabled``), then the materialized-view substitution
pass (matview/substitute.py, on a copy: the cached plan is never written),
then the result cache (``result_cache_enabled``), whose disposition
(HIT, MISS or BYPASS) rides the ``X-Trino-Tpu-Cache`` response header. An
EXECUTE of a prepared SELECT plans once per parameter-type signature and
binds its values into the cached parameterized plan
(server/prepared.py). CREATE, REFRESH and DROP MATERIALIZED VIEW run
against the server's view registry, the refresh's defining query through
the distributed path.

The coordinator runs on one torch device: CUDA unless it is given another
(``device="cpu"`` in the tests); asked for CUDA without a usable GPU it
raises.

Not ported (each refused, never ignored): ``retry_policy=TASK`` (the
fault-tolerant tier), spooled result segments, adaptive re-planning,
distributed EXPLAIN ANALYZE, resource groups and the dispatch plane,
cluster memory, the ledgers, the system catalog, and the
``/v1/query/{id}/trace|profile|flows``, ``/ui`` and ``/v1/segment`` routes
(501).

    python -m trino_tpu_torch.server.coordinator [--port N] [--device cuda|cpu]

prints ``{"url": ...}`` once it serves.
"""
from __future__ import annotations

import itertools
import json
import re
import threading
import time
import traceback
import uuid
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from trino_tpu_torch.exec.query import MATVIEW_STATEMENTS
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.server import wire
from trino_tpu_torch.server.exchange_client import ExchangeClient, TaskLocation
from trino_tpu_torch.server.statemachine import StateMachine, query_state_machine
from trino_tpu_torch.server.task import TaskRequest
from trino_tpu_torch.server.worker import resolve_device
from trino_tpu_torch.sql.parser import ast
from trino_tpu_torch.sql.planner import plan as P
from trino_tpu_torch.sql.planner.fragmenter import RemoteSourceNode, fragment_plan

_ANNOUNCE_RE = re.compile(r"^/v1/announce/([^/]+)$")
_RESULT_RE = re.compile(r"^/v1/statement/executing/([^/]+)/(\d+)$")
_QUERY_RE = re.compile(r"^/v1/query/([^/]+)$")
_NOT_PORTED_RE = re.compile(r"^(/v1/query/[^/]+/(trace|profile|flows)|/ui/?|/v1/segment/[^/]+)$")

RESULT_PAGE_ROWS = 10_000
# the result-cache disposition header (HIT | MISS | BYPASS)
CACHE_HEADER = "X-Trino-Tpu-Cache"
# _consult_result_cache's answer when the rows came from the cache
_SERVED_FROM_CACHE = "__served_from_cache__"


def _truthy(v) -> bool:
    return str(v).lower() not in ("false", "0", "no", "none", "")


# session properties that ask for a tier the port does not have: (name,
# asks-for-it test, what is missing)
_REFUSED_PROPERTIES = (
    ("retry_policy", lambda v: str(v).upper() == "TASK",
     "retry_policy=TASK (the fault-tolerant tier: spooled exchange, retries, "
     "speculative execution)"),
    ("spooled_results_enabled", _truthy, "spooled result segments"),
    ("adaptive_execution_enabled", _truthy, "adaptive re-planning and skew salting"),
)


def refuse_unported(properties: dict) -> None:
    """Raise NotImplementedError when a request's session properties ask
    for a tier the port's coordinator does not have."""
    for name, asks, what in _REFUSED_PROPERTIES:
        if name in properties and asks(properties[name]):
            raise NotImplementedError(f"{what} is not ported to the PyTorch coordinator")


class NodeRegistry:
    """Worker membership with announce-age liveness: an entry not
    re-announced within ``max_age`` seconds is dead."""

    def __init__(self, max_age: float = 10.0):
        self._nodes: Dict[str, dict] = {}
        self._lock = threading.Lock()
        self.max_age = max_age

    def announce(self, node_id: str, url: str, info: Optional[dict] = None) -> None:
        with self._lock:
            self._nodes[node_id] = {"url": url, "last_seen": time.monotonic(),
                                    "info": dict(info or {})}

    def alive(self) -> List[dict]:
        now = time.monotonic()
        with self._lock:
            return [{"nodeId": nid, **info} for nid, info in sorted(self._nodes.items())
                    if now - info["last_seen"] <= self.max_age]

    def wait_for_workers(self, count: int, timeout: float = 30.0) -> bool:
        """Block until ``count`` workers are alive (False at the timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.alive()) >= count:
                return True
            time.sleep(0.1)
        return False


class QueryExecution:
    """One query's lifecycle on the coordinator."""

    def __init__(self, query_id: str, sql: str, session_properties: dict,
                 registry: NodeRegistry, session_factory, user: str = "anonymous",
                 query_cache=None, prepared_registry=None, prepared_meta=None):
        self.query_id = query_id
        self.sql = sql
        self.user = user
        self.session_properties = dict(session_properties)
        self.state: StateMachine[str] = query_state_machine()
        self.registry = registry
        self.session_factory = session_factory
        # the server's QueryCache (cache/) or None (caching off), its
        # PreparedStatementRegistry (server/prepared.py), and its store of
        # per-plan consult metadata for prepared EXECUTEs
        self.query_cache = query_cache
        self.prepared_registry = prepared_registry
        self.prepared_meta = prepared_meta
        # which path ran the SELECT: "distributed", "fast-path",
        # "local-catalog", or None (another statement, or a cache hit)
        self.fast_path: Optional[str] = None
        # the result-cache disposition, sent as X-Trino-Tpu-Cache: HIT
        # (served from the cache or a concurrent leader), MISS (executed,
        # filled the cache), BYPASS (not eligible, or the cache is off)
        self.cache_status: Optional[str] = None
        self.result_cache_key: Optional[str] = None
        # the materialized views substituted into this query's plan, and
        # every substitution decision (queryStats.mvHits / mvNames)
        self.mv_substitutions: List[str] = []
        self.mv_notes: List[dict] = []
        self.tracer = tracing.Tracer()
        self.failure: Optional[str] = None
        self.columns: List[str] = []
        self.rows: List[tuple] = []
        # SET/RESET SESSION and PREPARE/DEALLOCATE round trips: the payload
        # carries them back and the client applies them to its later
        # requests (the coordinator keeps no session)
        self.set_session: Dict[str, object] = {}
        self.reset_session: List[str] = []
        self.add_prepared: Dict[str, str] = {}
        self.deallocated_prepared: List[str] = []
        self.fragments = None
        self.fragment_tasks: Dict[int, List[TaskLocation]] = {}
        # the latest status payload of each task, by task id
        self.task_info: Dict[str, dict] = {}
        self._tinfo_lock = threading.Lock()
        self.phase_waits: List[tuple] = []
        self.created_at = time.time()
        self.ended_at: Optional[float] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def cancel(self) -> None:
        self.ended_at = self.ended_at or time.time()
        if self.state.set("CANCELED"):
            self._cancel_tasks()

    # ------------------------------------------------------------ lifecycle
    def run(self) -> None:
        root_span = self.tracer.start_span("query", query_id=self.query_id, user=self.user)
        try:
            with tracing.activate(self.tracer, root_span.span_id):
                self._run_lifecycle()
            self.tracer.end_span(root_span)
            self.ended_at = time.time()
            self.state.set("FINISHED")
        except Exception as e:  # noqa: BLE001 — reported through query info
            self.ended_at = self.ended_at or time.time()
            if self.failure is None:
                self.failure = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            root_span.set("error", str(e).split("\n")[0][:300])
            self.tracer.end_span(root_span)
            self._cancel_tasks()
            self.state.set("FAILED")

    def _run_lifecycle(self) -> None:
        from trino_tpu_torch.exec.query import run_query
        from trino_tpu_torch.server.security import Identity
        from trino_tpu_torch.sql.parser.parser import parse_statement

        self.state.set("PLANNING")
        refuse_unported(self.session_properties)
        session = self.session_factory(self.session_properties)
        session.identity = Identity(self.user)
        # statement-kind probe, unspanned: plan_sql parses again under its
        # own "parse" span
        stmt = parse_statement(self.sql)
        if (isinstance(stmt, ast.Explain) and stmt.analyze
                and isinstance(stmt.statement, ast.Query)):
            self.cache_status = "BYPASS"
            raise NotImplementedError(
                "distributed EXPLAIN ANALYZE is not ported to the PyTorch coordinator")
        if isinstance(stmt, (ast.Prepare, ast.ExecutePrepared, ast.Deallocate)):
            self._run_prepared_statement(session, stmt)
            return
        if isinstance(stmt, MATVIEW_STATEMENTS):
            self._run_mv_statement(session, stmt, self.sql)
            return
        if not isinstance(stmt, ast.Query):
            # metadata statements, EXPLAIN, CALL, DML and DDL run on the
            # coordinator alone and bypass the result cache: the mutation
            # itself moves the data versions that invalidate cached SELECTs
            self.cache_status = "BYPASS"
            self.state.set("RUNNING")
            with self.tracer.span("execute/coordinator-local"):
                result = run_query(session, self.sql)
            self.columns, self.rows = result.column_names, result.rows
            if isinstance(stmt, ast.SetSession):
                self.set_session[stmt.name] = session.properties[stmt.name]
            elif isinstance(stmt, ast.ResetSession):
                self.reset_session.append(stmt.name)
            return
        root, versions = self._plan_query(session, stmt)
        root, versions = self._substitute_matviews(session, root, versions)
        key = self._consult_result_cache(session, stmt, root, versions)
        self._finish_with_result_cache(session, root, key)

    # ------------------------------------------------- materialized views
    def _run_mv_statement(self, session, stmt, sql) -> None:
        """CREATE / REFRESH / DROP MATERIALIZED VIEW against the server's
        registry. The refresh's defining query runs through
        ``_execute_query``, so a large definition fragments and schedules
        across the workers like a user SELECT; the rows then swap into the
        storage table (matview/lifecycle.py keeps the versions). ``sql`` is
        the CREATE statement's own text (the prepared path passes the
        registered inner text, or None when bound parameters made that text
        no longer describe the bound statement)."""
        from trino_tpu_torch.matview import lifecycle as mv_lifecycle

        self.cache_status = "BYPASS"

        def execute_fn(root):
            self._execute_query(session, root)
            rows, self.rows = self.rows, []
            return rows

        columns, rows = mv_lifecycle.dispatch_mv_statement(
            session, stmt, sql=sql, execute_fn=execute_fn)
        if self.state.get() in ("QUEUED", "PLANNING", "STARTING"):
            self.state.set("RUNNING")
        self.columns, self.rows = columns, rows

    def _substitute_matviews(self, session, root, versions):
        """The view substitution pass, after the plan cache (a cached plan
        stays substitution-free: freshness varies per execution, and the
        pass copies on write). A substituted plan's versions for the
        result-cache key are its own scans' (storage and any base scans
        left) and the views' recorded base versions, so a REFRESH and a
        base-table DML both invalidate cached results."""
        from trino_tpu_torch.matview.substitute import substitute_plan, substitution_versions

        new_root, notes = substitute_plan(session, root)
        self.mv_notes = notes
        self.mv_substitutions = [n["view"] for n in notes if n["result"] == "substituted"]
        if not self.mv_substitutions:
            return root, versions
        return new_root, substitution_versions(session, new_root, notes)

    # --------------------------------------------------------- the caches
    def _through_plan_cache(self, session, stmt, key_sql, plan_fn):
        """Serve a still-valid plan-cache entry, else plan through
        ``plan_fn`` and admit it. Statements with a table function never
        cache (their rows freeze into the plan). Returns ``(root,
        versions)``, versions None when the cache is off."""
        from trino_tpu_torch.cache.determinism import contains_table_function
        from trino_tpu_torch.cache.plan_key import capture_versions
        from trino_tpu_torch.obs import metrics as M

        cache = self.query_cache
        use_plan_cache = (cache is not None and bool(
            session.properties.get("logical_plan_cache_enabled", True))
            and not contains_table_function(stmt))
        if use_plan_cache:
            hit = cache.plans.get(session, key_sql)
            if hit is not None:
                M.PLAN_CACHE_HITS.inc()
                with self.tracer.span("plan-cache/hit"):
                    pass
                return hit
            M.PLAN_CACHE_MISSES.inc()
        root = plan_fn()
        versions = None
        if use_plan_cache:
            versions = capture_versions(session, root)
            cache.plans.put(session, key_sql, root, versions)
        return root, versions

    def _plan_query(self, session, stmt):
        """The optimized plan of this SELECT through the plan cache (keyed
        by the SQL text, the user, the session properties and the routine
        store; revalidated against the data versions)."""
        from trino_tpu_torch.exec.query import plan_sql

        return self._through_plan_cache(session, stmt, self.sql,
                                        lambda: plan_sql(session, self.sql))

    def _consult_result_cache(self, session, stmt, root, versions=None,
                              prepared_meta=None, binding=None):
        """One admission pass against the result cache. Returns
        ``_SERVED_FROM_CACHE`` (columns and rows filled), a key (this query
        leads the flight and must complete or abandon it), or None (bypass,
        or a follower whose leader failed: execute, do not store).
        ``prepared_meta`` is (reason, canonical of the parameterized plan)
        from the EXECUTE path, ``binding`` the bound values in the key."""
        from trino_tpu_torch.cache.determinism import uncachable_reason
        from trino_tpu_torch.cache.plan_key import (
            capture_versions, fingerprint_from_canonical, plan_fingerprint)
        from trino_tpu_torch.cache.result_cache import session_user
        from trino_tpu_torch.obs import metrics as M

        cache = self.query_cache
        if cache is None or not bool(session.properties.get("result_cache_enabled", False)):
            self.cache_status = "BYPASS"
            return None
        canonical = None
        if prepared_meta is not None:
            reason, canonical = prepared_meta
        else:
            reason = uncachable_reason(stmt, root)
        if reason is None:
            if versions is None:
                versions = capture_versions(session, root)
            if versions is None:
                reason = "unversioned table"
        with self.tracer.span("cache/lookup") as sp:
            if reason is not None:
                self.cache_status = "BYPASS"
                M.RESULT_CACHE_BYPASSES.inc()
                sp.set("disposition", "BYPASS")
                sp.set("reason", reason)
                return None
            # the user partitions the key: plan-time access control must
            # fire again for each principal, never be skipped through a hit
            extra = (f"user={session_user(session)}",) + ((binding,) if binding else ())
            key = (fingerprint_from_canonical(canonical, versions, extra)
                   if canonical is not None
                   else plan_fingerprint(root, versions, extra=extra))
            sp.set("key", key[:16])
            self.result_cache_key = key
            kind, payload = cache.results.begin(key)
            if kind == "wait":
                # single flight: an identical query is already executing
                sp.set("single_flight", True)
                M.RESULT_CACHE_SINGLE_FLIGHT_WAITS.inc()
                done = payload.wait(timeout=600.0)
                if done and payload.ok:
                    kind, payload = "hit", payload.value
                else:
                    # the leader failed or timed out: execute, uncached
                    self.cache_status = "MISS"
                    M.RESULT_CACHE_MISSES.inc()
                    sp.set("disposition", "MISS")
                    return None
            if kind == "hit":
                columns, rows = payload
                self.cache_status = "HIT"
                M.RESULT_CACHE_HITS.inc()
                sp.set("disposition", "HIT")
                sp.set("rows", len(rows))
                self.columns, self.rows = list(columns), list(rows)
                return _SERVED_FROM_CACHE
            self.cache_status = "MISS"
            M.RESULT_CACHE_MISSES.inc()
            sp.set("disposition", "MISS")
            return key

    def _finish_with_result_cache(self, session, root, key) -> None:
        """Serve, lead or bypass against the result cache, executing
        through ``_execute_query`` otherwise. A leader that fails abandons
        its flight (the waiters execute themselves)."""
        if key == _SERVED_FROM_CACHE:
            self.state.set("FINISHING")
            return
        if key is None:
            self._execute_query(session, root)
            return
        try:
            self._execute_query(session, root)
        except BaseException:
            self.query_cache.results.abandon(key)
            raise
        self.query_cache.results.complete(
            key, self.columns, self.rows,
            ttl_ms=session.properties.get("result_cache_ttl_ms", 60_000),
            max_bytes=session.properties.get("result_cache_max_bytes"))

    # ------------------------------------------------- prepared statements
    def _run_prepared_statement(self, session, stmt) -> None:
        """PREPARE / EXECUTE / DEALLOCATE against the server's registry."""
        reg = self.prepared_registry
        if isinstance(stmt, ast.Prepare):
            self.cache_status = "BYPASS"
            self.state.set("RUNNING")
            inner = stmt.statement
            if isinstance(inner, (ast.Prepare, ast.ExecutePrepared, ast.Deallocate)):
                raise ValueError(
                    "cannot PREPARE another prepared-statement control statement")
            # the inner statement's text: the PREPARE grammar is rigid, so
            # stripping its one fixed prefix is exact
            m = re.match(r"(?is)^\s*prepare\s+\S+\s+from\s+(.*)$", self.sql.strip())
            sql_text = (m.group(1) if m else self.sql).strip()
            reg.put(self.user, stmt.name, inner, sql_text)
            self.add_prepared[stmt.name] = sql_text
            self.columns, self.rows = ["result"], [("PREPARE",)]
            return
        if isinstance(stmt, ast.Deallocate):
            self.cache_status = "BYPASS"
            self.state.set("RUNNING")
            if not reg.remove(self.user, stmt.name):
                raise ValueError(f"prepared statement not found: {stmt.name}")
            self.deallocated_prepared.append(stmt.name)
            self.columns, self.rows = ["result"], [("DEALLOCATE",)]
            return
        self._run_execute_prepared(session, stmt)

    def _run_execute_prepared(self, session, stmt) -> None:
        """EXECUTE name [USING ...]: fold the bindings to constants, reuse
        (or plan) the one cached parameterized plan of this statement and
        type signature, bind the constants into a copy, and run it through
        the result cache and the executor. A warm EXECUTE does no parse,
        analyze, plan or optimize work: only the bind pass."""
        from trino_tpu_torch.obs import metrics as M
        from trino_tpu_torch.server import prepared as prep

        ps = self.prepared_registry.get(self.user, stmt.name)
        if ps is None:
            raise ValueError(f"prepared statement not found: {stmt.name}")
        inner = ps.statement
        t0 = time.perf_counter()
        with self.tracer.span("prepare/bind") as sp:
            sp.set("statement", stmt.name)
            sp.set("step", "fold")
            values = prep.fold_execute_args(stmt.params)
            prep.check_arity(ps, values)
            sp.set("parameters", len(values))
        fold_s = time.perf_counter() - t0
        self.prepared_registry.touch(self.user, stmt.name)
        if not isinstance(inner, ast.Query):
            # prepared DML, DDL and metadata statements bind at the AST
            # level and run on the coordinator, like their plain spelling
            from trino_tpu_torch.exec.query import bind_parameters, dispatch_statement

            self.cache_status = "BYPASS"
            bound = bind_parameters(inner, stmt.params)
            M.EXECUTE_BIND_SECONDS.observe(fold_s)
            if isinstance(bound, MATVIEW_STATEMENTS):
                # the registered inner text is the definition SQL, unless
                # bound parameters changed what it describes
                self._run_mv_statement(session, bound, ps.sql if not stmt.params else None)
                return
            self.state.set("RUNNING")
            with self.tracer.span("execute/coordinator-local"):
                result = dispatch_statement(session, bound)
            self.columns, self.rows = result.column_names, result.rows
            return
        ptypes = tuple(c.type for c in values)
        root, versions = self._plan_prepared(session, ps, ptypes)
        t1 = time.perf_counter()
        with self.tracer.span("prepare/bind") as sp:
            sp.set("step", "substitute")
            bound_root = prep.bind_plan_parameters(root, values)
        M.EXECUTE_BIND_SECONDS.observe(fold_s + (time.perf_counter() - t1))
        # the determinism verdict and the canonical text do not depend on
        # the binding: computed once per parameterized plan object and kept
        # beside it (never written into the cached tree)
        meta = self.prepared_meta.get(root) if self.prepared_meta is not None else None
        if meta is None:
            from trino_tpu_torch.cache.determinism import uncachable_reason
            from trino_tpu_torch.cache.plan_key import canonicalize_plan

            reason = uncachable_reason(inner, root)
            meta = (reason, canonicalize_plan(root) if reason is None else None)
            if self.prepared_meta is not None:
                self.prepared_meta.put(root, meta)
        binding = "params=" + repr([(str(c.type), repr(c.value)) for c in values])
        bound_root, versions = self._substitute_matviews(session, bound_root, versions)
        key = self._consult_result_cache(session, inner, bound_root, versions,
                                         prepared_meta=meta, binding=binding)
        self._finish_with_result_cache(session, bound_root, key)

    def _plan_prepared(self, session, ps, ptypes):
        """The parameterized plan of one prepared statement and binding
        type signature through the plan cache: one entry serves every
        binding of that signature (the plan keeps symbolic
        ``ir.Parameter`` placeholders)."""
        from trino_tpu_torch.sql.analyzer.expr_analyzer import parameter_types

        def plan_fn():
            from trino_tpu_torch.exec.query import _expand_udfs
            from trino_tpu_torch.sql.planner.optimizer import optimize
            from trino_tpu_torch.sql.planner.planner import Planner

            inner = _expand_udfs(session, ps.statement)
            with parameter_types(ptypes):
                with tracing.span("analyze/plan"):
                    root = Planner(session).plan(inner)
                with tracing.span("optimize"):
                    return optimize(root, session)

        return self._through_plan_cache(session, ps.statement, ps.plan_cache_sql(ptypes),
                                        plan_fn)

    def _execute_query(self, session, root) -> None:
        """Run an optimized SELECT plan: on the coordinator for
        process-local catalogs and fast-path plans, else fragment, schedule
        and run the root fragment."""
        if any(isinstance(n, P.TableScanNode) and session.catalogs[n.catalog].coordinator_only
               for n in P.walk_plan(root)):
            self._run_local(session, root, "local-catalog")
            return
        from trino_tpu_torch.server import fastpath

        take, _reason = fastpath.fast_path_decision(session, root)
        if take:
            self._run_local(session, root, "fast-path")
            return
        self.fast_path = "distributed"
        with self.tracer.span("fragment") as sp:
            fragments = self.fragments = fragment_plan(root, session)
            sp.set("fragments", len(fragments))
        with self.tracer.span("schedule") as sp:
            self.state.set("STARTING")
            workers = self.registry.alive()
            if not workers:
                raise RuntimeError("no alive workers")
            sp.set("workers", len(workers))
            self._schedule(session, fragments, workers)
            self.state.set("RUNNING")
        with self.tracer.span("execute/root-fragment"):
            result_page = self._run_root_fragment(session, fragments)
        self._sweep_task_status()
        self.state.set("FINISHING")
        self.columns = fragments[-1].root.column_names
        self._materialize_result(session, result_page)

    def _run_local(self, session, root, path: str) -> None:
        from trino_tpu_torch.exec.executor import Executor

        self.fast_path = path
        self.state.set("RUNNING")
        with self.tracer.span("execute/coordinator-local"):
            ex = Executor(session)
            page = ex.execute_checked(root)
        self.columns = list(root.column_names)
        self._materialize_result(session, page)
        # the coordinator-local run as one task of the query's stats
        cache = ex.scan_cache.values()
        self._note_task_status(f"{self.query_id}.0.local.a0", {"state": "FINISHED", "stats": {
            "completedSplits": 1, "totalSplits": 1,
            "inputRows": int(sum(ex.scan_stats.values())),
            "deviceCacheHits": sum(1 for d in cache if d == "hit"),
            "deviceCacheMisses": sum(1 for d in cache if d == "miss")}})

    def _materialize_result(self, session, page) -> None:
        """The result page as Python rows, refusing one over
        ``inline_result_max_bytes`` (the rows would all sit in this
        process)."""
        rows = page.to_pylist()
        cap = int(session.properties.get("inline_result_max_bytes", 256 << 20))
        est = len(rows) * int(page.row_byte_estimate())
        if est > cap:
            raise RuntimeError(
                f"result is ~{est} serialized bytes, over inline_result_max_bytes={cap} "
                "(INLINE_RESULT_TOO_LARGE): narrow the query")
        self.rows = rows

    # ----------------------------------------------------------- scheduling
    def _schedule(self, session, fragments, workers) -> None:
        """Create every fragment's tasks. A fragment consumed by a source
        or hash fragment has one consumer a worker (broadcast buffers, or
        one partition a hash task); the root fragment is one consumer. A
        fragment whose join build is fed by a leaf fragment waits until the
        build's tasks finished executing (phased execution)."""
        consumer_counts: Dict[int, int] = {}
        for frag in fragments:
            for node in P.walk_plan(frag.root):
                if isinstance(node, RemoteSourceNode):
                    consumer_counts[node.fragment_id] = (
                        len(workers) if frag.partitioning in ("source", "hash") else 1)
        phased = _truthy(self.session_properties.get("phased_execution", True))
        by_id = {f.id: f for f in fragments}
        build_deps: Dict[int, List[int]] = {}
        for frag in fragments:
            deps = []
            for node in P.walk_plan(frag.root):
                if isinstance(node, P.JoinNode) and isinstance(node.right, RemoteSourceNode):
                    dep = by_id.get(node.right.fragment_id)
                    if dep is not None and not any(
                            isinstance(n, RemoteSourceNode) for n in P.walk_plan(dep.root)):
                        deps.append(dep.id)
            if deps:
                build_deps[frag.id] = deps
        for frag in fragments:
            if phased and frag.id in build_deps:
                self._await_build_fragments(build_deps[frag.id])
                self.phase_waits.append((frag.id, build_deps[frag.id]))
            self._schedule_fragment(session, frag, workers, consumer_counts)

    def _schedule_fragment(self, session, frag, workers, consumer_counts) -> None:
        """Create the tasks of one source or hash fragment (the root single
        fragment runs on the coordinator)."""
        if frag.partitioning == "hash":
            self.fragment_tasks[frag.id] = [
                self._create_task(frag, wi, {}, workers[wi], consumer_counts)
                for wi in range(len(workers))]
            return
        if frag.partitioning != "source":
            return
        from trino_tpu_torch.exec import staging as _staging

        per_worker_splits: List[Dict[int, list]] = [dict() for _ in workers]
        scan_nodes = [n for n in P.walk_plan(frag.root) if isinstance(n, P.TableScanNode)]
        for node in scan_nodes:
            conn = session.catalogs[node.catalog]
            floor = max(len(workers), 1)
            # a single-scan fragment fans out finer for big tables; a
            # multi-scan fragment (a co-located join) keeps split i of
            # every table over the same key range
            target = floor
            if len(scan_nodes) == 1:
                target = _staging.target_split_count(
                    session, conn, node.schema, node.table, floor=floor,
                    handle=node.table_handle)
            splits = conn.get_splits(node.schema, node.table, target,
                                     constraint=node.constraint, handle=node.table_handle)
            for i, split in enumerate(splits):
                per_worker_splits[i % len(workers)].setdefault(node.id, []).append(split)
        self.fragment_tasks[frag.id] = [
            self._create_task(frag, wi, per_worker_splits[wi], workers[wi], consumer_counts)
            for wi in range(len(workers))]

    def _create_task(self, frag, wi: int, splits, worker, consumer_counts) -> TaskLocation:
        task_id = f"{self.query_id}.{frag.id}.{wi}.a0"
        req = TaskRequest(
            task_id=task_id, query_id=self.query_id, fragment_root=frag.root,
            splits=splits, upstream=self._upstream_for(frag.root, consumer_index=wi),
            session_properties=self.session_properties,
            consumer_count=consumer_counts.get(frag.id, 1),
            output_partition_channels=frag.output_partition_channels)
        status, resp, _ = wire.http_request(
            "POST", f"{worker['url']}/v1/task/{task_id}", req.to_bytes())
        if status >= 400:
            raise RuntimeError(f"task create failed on {worker['nodeId']}: "
                               f"{resp[:300].decode(errors='replace')}")
        self._note_task_status(task_id, json.loads(resp))
        return TaskLocation(worker["url"], task_id)

    def _note_task_status(self, task_id: str, info: dict) -> None:
        with self._tinfo_lock:
            self.task_info[task_id] = info

    def _poll_task(self, loc: TaskLocation) -> Optional[dict]:
        """One status read of a task (None when it fails)."""
        try:
            status, body, _ = wire.http_request(
                "GET", f"{loc.base_url}/v1/task/{loc.task_id}/status", timeout=10.0)
        except Exception:  # noqa: BLE001 — a worker gone reads as no status
            return None
        if status >= 400:
            return None
        info = json.loads(body)
        self._note_task_status(loc.task_id, info)
        return info

    def _sweep_task_status(self) -> None:
        """Read every task's status once (the tasks are at least FLUSHING
        once the root fragment drained them)."""
        for locations in list(self.fragment_tasks.values()):
            for loc in locations:
                self._poll_task(loc)

    def _upstream_for(self, root, consumer_index: int = 0) -> Dict[int, list]:
        up: Dict[int, list] = {}
        for node in P.walk_plan(root):
            if isinstance(node, RemoteSourceNode):
                up[node.fragment_id] = [(loc.base_url, loc.task_id, consumer_index)
                                        for loc in self.fragment_tasks.get(node.fragment_id, [])]
        return up

    def _run_root_fragment(self, session, fragments):
        from trino_tpu_torch.server.task import FragmentExecutor

        root_frag = fragments[-1]
        assert root_frag.partitioning == "single"
        remote_pages: Dict[int, list] = {}
        for node in P.walk_plan(root_frag.root):
            if isinstance(node, RemoteSourceNode):
                client = ExchangeClient(self.fragment_tasks[node.fragment_id],
                                        device=session.device)
                client.start()
                remote_pages[node.fragment_id] = client.pages()
        return FragmentExecutor(session, {}, remote_pages).execute_checked(root_frag.root)

    PHASE_WAIT_TIMEOUT = 300.0

    def _await_build_fragments(self, dep_ids) -> None:
        """Block until every task of the given build fragments is FLUSHING
        or later (its body is done, its output buffered)."""
        deadline = time.monotonic() + self.PHASE_WAIT_TIMEOUT
        for fid in dep_ids:
            for loc in self.fragment_tasks.get(fid, ()):
                while time.monotonic() < deadline:
                    info = self._poll_task(loc)
                    if info is not None and info.get("state") in (
                            "FLUSHING", "FINISHED", "FAILED", "CANCELED"):
                        break
                    if self.state.is_terminal():
                        return
                    time.sleep(0.02)

    def _cancel_tasks(self) -> None:
        for locations in list(self.fragment_tasks.values()):
            for loc in locations:
                try:
                    wire.http_request("DELETE", f"{loc.base_url}/v1/task/{loc.task_id}",
                                      timeout=5.0)
                except Exception:  # noqa: BLE001
                    pass

    def stats(self) -> dict:
        """The statement protocol's stats block: state, wall, splits and
        rows over the tasks' latest status."""
        with self._tinfo_lock:
            infos = list(self.task_info.values())
        st = [i.get("stats") or {} for i in infos]
        end = self.ended_at or time.time()
        return {
            "state": self.state.get(),
            "elapsedMs": round((end - self.created_at) * 1e3, 3),
            "fragments": len(self.fragments or ()),
            "tasks": len(infos),
            "completedSplits": sum(int(s.get("completedSplits", 0)) for s in st),
            "totalSplits": sum(int(s.get("totalSplits", 0)) for s in st),
            "processedRows": sum(int(s.get("inputRows", 0)) for s in st),
            "deviceCacheHits": sum(int(s.get("deviceCacheHits", 0)) for s in st),
            "deviceCacheMisses": sum(int(s.get("deviceCacheMisses", 0)) for s in st),
            # the materialized views substituted into this query's plan
            "mvHits": len(self.mv_substitutions),
            **({"mvNames": list(self.mv_substitutions)} if self.mv_substitutions else {}),
        }

    def info(self) -> dict:
        with self._tinfo_lock:
            tasks = {tid: {"state": i.get("state"), "stats": i.get("stats")}
                     for tid, i in self.task_info.items()}
        return {
            "queryId": self.query_id,
            "state": self.state.get(),
            "user": self.user,
            "query": self.sql,
            "failure": (self.failure or "").split("\n")[0] or None,
            "cacheStatus": self.cache_status,
            "fastPath": self.fast_path,
            "fragments": {str(fid): [loc.task_id for loc in locs]
                          for fid, locs in self.fragment_tasks.items()},
            "tasks": tasks,
            "queryStats": self.stats(),
        }


class PlanMetaStore:
    """Per-plan-object metadata kept beside cached plans, never written
    into them: the prepared EXECUTE path's (determinism verdict, canonical
    text) of a parameterized plan. An entry lives as long as its plan
    object; a replanned or evicted plan is a new object, so an entry can
    never serve another plan's canonical."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[int, tuple] = {}

    def get(self, root):
        with self._lock:
            ent = self._entries.get(id(root))
        return ent[1] if ent is not None and ent[0]() is root else None

    def put(self, root, meta) -> None:
        with self._lock:
            self._entries[id(root)] = (weakref.ref(root), meta)
            if len(self._entries) > 1024:
                self._entries = {k: v for k, v in self._entries.items()
                                 if v[0]() is not None}


class CoordinatorServer:
    """The coordinator process: discovery registry + statement protocol."""

    MAX_QUERY_HISTORY = 100  # terminal queries kept (oldest evicted)

    def __init__(self, port: int = 0, session_factory=None, device=None):
        from trino_tpu_torch.connector.registry import default_catalogs

        self.device = resolve_device(device)
        self.registry = NodeRegistry()
        # one catalog map and routine store for every query the server
        # runs: memory-catalog DDL and CREATE FUNCTION persist
        self.catalogs = default_catalogs()
        self.udfs: Dict[str, object] = {}
        # the materialized-view registry every session of this server shares
        from trino_tpu_torch.matview.registry import MaterializedViewRegistry

        self.matviews = MaterializedViewRegistry()

        def _shared_catalog_session(properties):
            from trino_tpu_torch.client.session import Session

            return Session(properties, device=self.device, catalogs=self.catalogs,
                           udfs=self.udfs, matviews=self.matviews)

        self.session_factory = session_factory or _shared_catalog_session
        # the logical-plan cache and the result cache every query of this
        # server goes through (the result cache per query, by
        # ``result_cache_enabled``), and the prepared statements keyed
        # (user, name): the per-query sessions are thrown away
        from trino_tpu_torch.cache import QueryCache
        from trino_tpu_torch.server.prepared import PreparedStatementRegistry

        self.query_cache = QueryCache()
        self.prepared = PreparedStatementRegistry()
        self.prepared_meta = PlanMetaStore()
        self.queries: Dict[str, QueryExecution] = {}
        self._qlock = threading.Lock()
        self._qid = itertools.count(1)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(self))
        self.port = self.httpd.server_address[1]
        self.base_url = f"http://127.0.0.1:{self.port}"
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self) -> None:
        self._serve_thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    def submit(self, sql: str, properties: Optional[dict] = None,
               user: str = "anonymous") -> QueryExecution:
        query_id = f"q{time.strftime('%Y%m%d')}_{next(self._qid):05d}_{uuid.uuid4().hex[:5]}"
        execution = QueryExecution(query_id, sql, properties or {}, self.registry,
                                   self.session_factory, user=user,
                                   query_cache=self.query_cache,
                                   prepared_registry=self.prepared,
                                   prepared_meta=self.prepared_meta)
        with self._qlock:
            if len(self.queries) > self.MAX_QUERY_HISTORY:
                terminal = [qid for qid, q in self.queries.items() if q.state.is_terminal()]
                for qid in terminal[: max(0, len(terminal) - self.MAX_QUERY_HISTORY)]:
                    del self.queries[qid]
            self.queries[query_id] = execution
        execution.start()
        return execution

    def get_query(self, query_id: str) -> Optional[QueryExecution]:
        with self._qlock:
            return self.queries.get(query_id)

    def query_state_counts(self):
        """(queries by state, result rows held by FINISHED queries)."""
        by_state: Dict[str, int] = {}
        total_rows = 0
        with self._qlock:
            queries = list(self.queries.values())
        for q in queries:
            st = q.state.get()
            by_state[st] = by_state.get(st, 0) + 1
            if st == "FINISHED":
                total_rows += len(q.rows)
        return by_state, total_rows


def _jsonable(v):
    """A result value in the protocol's JSON vocabulary: dates and
    timestamps as ISO strings and decimals as ``str(Decimal)``, inside
    arrays, maps and rows too (the strings a flat column of the same type
    gets)."""
    import datetime
    import decimal

    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {_jsonable(k): _jsonable(x) for k, x in v.items()}
    return v


def _cache_header(q: QueryExecution) -> Optional[dict]:
    """The result-cache disposition header, once the query decided it."""
    return {CACHE_HEADER: q.cache_status} if q.cache_status else None


def _result_payload(server: CoordinatorServer, q: QueryExecution, token: int) -> dict:
    state = q.state.get()
    payload: dict = {"id": q.query_id, "stats": q.stats()}
    if state == "FAILED":
        payload["error"] = {"message": q.failure or "query failed"}
        return payload
    if state == "CANCELED":
        payload["error"] = {"message": "query was canceled"}
        return payload
    if state != "FINISHED":
        payload["nextUri"] = f"{server.base_url}/v1/statement/executing/{q.query_id}/{token}"
        return payload
    if q.set_session:
        payload["setSessionProperties"] = dict(q.set_session)
    if q.reset_session:
        payload["resetSessionProperties"] = list(q.reset_session)
    if q.add_prepared:
        payload["addedPreparedStatements"] = dict(q.add_prepared)
    if q.deallocated_prepared:
        payload["deallocatedPreparedStatements"] = list(q.deallocated_prepared)
    start = token * RESULT_PAGE_ROWS
    chunk = q.rows[start:start + RESULT_PAGE_ROWS]
    payload["columns"] = [{"name": c} for c in q.columns]
    payload["data"] = [[_jsonable(v) for v in row] for row in chunk]
    if start + RESULT_PAGE_ROWS < len(q.rows):
        payload["nextUri"] = (f"{server.base_url}/v1/statement/executing/"
                              f"{q.query_id}/{token + 1}")
    return payload


def _make_handler(server: CoordinatorServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 30
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            pass

        def _send(self, status: int, body: bytes = b"",
                  content_type: str = "application/json", headers: Optional[dict] = None):
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length", "0")))

        def _not_ported(self) -> bool:
            if _NOT_PORTED_RE.match(self.path.split("?", 1)[0]):
                self._send(501, json.dumps(
                    {"error": {"message": f"{self.path} is not ported"}}).encode())
                return True
            return False

        def do_PUT(self):
            m = _ANNOUNCE_RE.match(self.path)
            if m:
                body = self._read_body()
                if not wire.verify(body, self.headers.get(wire.H_INTERNAL_AUTH)):
                    self._send(401, b'{"error": "bad internal signature"}')
                    return
                info = json.loads(body)
                server.registry.announce(m.group(1), info["url"], info)
                self._send(200, b"{}")
                return
            self._send(404)

        def do_POST(self):
            if self.path == "/v1/statement":
                sql = self._read_body().decode()
                props = {}
                for header, value in self.headers.items():
                    if header.lower().startswith("x-trino-session-"):
                        props[header[len("x-trino-session-"):].lower()] = value
                user = self.headers.get("X-Trino-User", "anonymous")
                q = server.submit(sql, props, user=user)
                # a short query finishes inside this wait: one round trip
                if not q.state.is_terminal():
                    q.state.wait_for_terminal(0.5)
                self._send(200, json.dumps(_result_payload(server, q, 0)).encode(),
                           headers=_cache_header(q))
                return
            self._send(404)

        def do_GET(self):
            if self._not_ported():
                return
            m = _RESULT_RE.match(self.path)
            if m:
                q = server.get_query(m.group(1))
                if q is None:
                    self._send(404, b'{"error": "no such query"}')
                    return
                if not q.state.is_terminal():
                    q.state.wait_for_terminal(0.5)
                self._send(200, json.dumps(
                    _result_payload(server, q, int(m.group(2)))).encode(),
                    headers=_cache_header(q))
                return
            m = _QUERY_RE.match(self.path)
            if m:
                q = server.get_query(m.group(1))
                if q is None:
                    self._send(404, b'{"error": "no such query"}')
                    return
                self._send(200, json.dumps(q.info()).encode())
                return
            if self.path == "/v1/node":
                self._send(200, json.dumps(server.registry.alive()).encode())
                return
            if self.path == "/v1/info":
                self._send(200, json.dumps({"coordinator": True, "state": "ACTIVE",
                                            "device": str(server.device)}).encode())
                return
            self._send(404)

        def do_DELETE(self):
            if self._not_ported():
                return
            m = _RESULT_RE.match(self.path)
            if m:
                q = server.get_query(m.group(1))
                if q is not None:
                    q.cancel()
                self._send(204)
                return
            self._send(404)

    return Handler


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    c = CoordinatorServer(args.port, device=args.device)
    c.start()
    print(json.dumps({"url": c.base_url}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        c.stop()


if __name__ == "__main__":
    main()
