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

Adaptive execution is on by default (``adaptive_execution_enabled``): at
every stage boundary, after the phased build waits and before a fragment's
tasks exist, the re-planner (adaptive/replanner.py) may flip a join's
distribution on the build's actual rows, stamp exchange sources with
actual rows or salt hot partitions; each change is a versioned plan change
(``planVersions``, ``[adapted: ...]`` in EXPLAIN ANALYZE, a ``plan/adapt``
span). The stats it reads come from the tasks' status payloads, kept a
task slot (``task_stats``) by a jittered background poller and a sweep at
each boundary, and rolled up task -> stage -> query
(exec/operator_stats.py). Distributed EXPLAIN ANALYZE [VERBOSE] runs the
query through the same path with per-operator stats on and prints the
fragments annotated with the rolled-up stats.

The serving plane (server/dispatch.py) makes one coordinator safe to
share. ``submit`` classifies the statement into its resource group
(server/resource_groups.py; the config from ``resource_groups_config`` or
the file named by ``TRINO_TPU_RESOURCE_GROUPS_CONFIG``), turns overload
around before any per-query state exists (``DispatchRejected``: HTTP 429
with ``Retry-After``), registers the query, fires its created event
(server/events.py), and hands it to the dispatcher: a repeat whose result
is still valid is answered from the serving index on the HTTP thread,
anything else waits in its group's bounded queue for one of a fixed pool
of executor lanes, which runs admission (the group's weighted-fair drain,
then the cluster-memory gate) and the query. No thread is created a query.
Workers announce their per-query reservations and pools; the cluster
memory manager (server/cluster_memory.py) kills the largest query of a
worker over its pool (``QueryExecution.kill``, EXCEEDED_CLUSTER_MEMORY),
and a FAILED query keeps a postmortem of the coordinator's and its
workers' flight-recorder rings and memory-ledger snapshots. With an
``authenticator`` (server/auth.py) every public route asks for Basic or
Bearer credentials (401) and a query's routes answer only its owner (403).
``GET /v1/metrics`` serves the Prometheus page.

The coordinator runs on one torch device: CUDA unless it is given another
(``device="cpu"`` in the tests); asked for CUDA without a usable GPU it
raises.

Not ported (each refused, never ignored): ``retry_policy=TASK`` (the
fault-tolerant tier), spooled result segments, the executor-process plane
(``executor_plane="process"``), the flow ledger and the phase timeline,
the system catalog, and the ``/v1/query/{id}/trace|profile|flows``,
``/ui`` and ``/v1/segment`` routes (501).

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
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional

from trino_tpu_torch.exec.query import MATVIEW_STATEMENTS
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.server import events as ev
from trino_tpu_torch.server import wire
from trino_tpu_torch.server.auth import AuthenticationError
from trino_tpu_torch.server.dispatch import Dispatcher, DispatchRejected
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

# the WWW-Authenticate challenge of a 401
AUTH_CHALLENGE = 'Basic realm="trino-tpu", Bearer'

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
        # the latest status record of each task slot ("<query>.<fragment>.
        # <index>"): {"fragment", "taskId", "state", "stats"}; the
        # stage and query rollups and the adaptive rules read it
        self.task_stats: Dict[str, dict] = {}
        self._tstats_lock = threading.Lock()
        # task-status GETs this query made (poller, sweeps, build waits)
        self.status_polls = 0
        # versioned plan changes of the adaptive re-planner (dicts)
        self.plan_versions: List[dict] = []
        # EXPLAIN ANALYZE: every executor of the query collects
        # per-operator stats; the coordinator's own executor is kept
        self._collect_stats = False
        self._root_executor = None
        self._local_executor = None
        self.fast_path_reason: Optional[str] = None
        self._kernels_folded = False
        self.phase_waits: List[tuple] = []
        self.created_at = time.time()
        self.ended_at: Optional[float] = None
        # the serving plane: the group the selectors chose (None under an
        # injected flat gate), the client's X-Trino-Source, the queries
        # queued ahead at enqueue, and the queue-residency span the lane
        # closes at dequeue
        self.resource_group: Optional[str] = None
        self.source: str = ""
        self.queued_ahead: Optional[int] = None
        self._dispatch_queue_span = None
        # serving-index learning: whether the statement was a plain SELECT,
        # and the result-cache key and data versions of a led flight
        self.is_plain_select = False
        self.result_cache_versions = None
        # the coordinator's flight recorder (set at submit) and the
        # postmortem a FAILED query keeps
        self.recorder = None
        self.postmortem: Optional[dict] = None

    def cancel(self) -> None:
        self.ended_at = self.ended_at or time.time()
        if self.state.set("CANCELED"):
            self._cancel_tasks()

    def kill(self, reason: str) -> None:
        """Administrative kill (the low-memory killer): FAILED with
        ``reason``, the running tasks canceled."""
        self.failure = reason
        self.ended_at = self.ended_at or time.time()
        if self.state.set("FAILED"):
            self._cancel_tasks()

    # ------------------------------------------------------------ lifecycle
    def run(self) -> None:
        root_span = self.tracer.start_span("query", query_id=self.query_id, user=self.user)
        # the queue span opened before this root existed: adopt it, so the
        # trace keeps one root
        if self._dispatch_queue_span is not None:
            self._dispatch_queue_span.parent_id = root_span.span_id
        try:
            with tracing.activate(self.tracer, root_span.span_id):
                self._run_lifecycle()
            self.tracer.end_span(root_span)
            self.ended_at = time.time()
            self.fold_kernel_profile()
            self.state.set("FINISHED")
        except Exception as e:  # noqa: BLE001 — reported through query info
            self.ended_at = self.ended_at or time.time()
            if self.failure is None:
                self.failure = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            root_span.set("error", str(e).split("\n")[0][:300])
            self.tracer.end_span(root_span)
            self._cancel_tasks()
            self.fold_kernel_profile()
            # the postmortem before FAILED is visible: the workers' rings
            # still hold the context around the failure
            try:
                self.capture_postmortem()
            except Exception:  # noqa: BLE001 — best-effort forensics
                pass
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
            # distributed EXPLAIN ANALYZE: the statement runs through the
            # fragment/schedule/execute path, and the deliverable is the
            # fragments annotated with the stats it ran under
            self.cache_status = "BYPASS"
            text = self._explain_analyze(session, stmt)
            self.columns = ["Query Plan"]
            self.rows = [(line,) for line in text.split("\n")]
            return
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
        self.is_plain_select = True
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
            # the serving index learns (SQL -> key, versions) of a MISS
            self.result_cache_key = key
            self.result_cache_versions = versions
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
        self.is_plain_select = True
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

        take, reason = fastpath.fast_path_decision(session, root)
        if take:
            self.fast_path_reason = reason
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
            self._start_stats_poller()
        with self.tracer.span("execute/root-fragment"):
            result_page = self._run_root_fragment(session, fragments)
        # freeze the rollup on the tasks' final numbers before the query
        # leaves RUNNING (every task is FLUSHING or later once the root
        # fragment drained its buffers)
        with self.tracer.span("stats/sweep") as sp:
            sp.set("polled", self._sweep_task_stats())
        self.state.set("FINISHING")
        self.columns = fragments[-1].root.column_names
        self._materialize_result(session, result_page)

    def _run_local(self, session, root, path: str) -> None:
        from trino_tpu_torch.exec.executor import Executor

        self.fast_path = path
        self.state.set("RUNNING")
        t0 = time.perf_counter()
        with self.tracer.span("execute/coordinator-local"):
            ex = Executor(session, collect_stats=self._collect_stats or None)
            page = ex.execute_checked(root)
        self._local_executor = ex  # EXPLAIN ANALYZE's annotation source
        self.columns = list(root.column_names)
        self._materialize_result(session, page)
        self._note_local_stats(ex, time.perf_counter() - t0)

    def _note_local_stats(self, ex, elapsed_s: float) -> None:
        """A coordinator-local execution as one synthetic task slot of
        fragment 0, so the rollups and the protocol's stats block cover it
        as they cover a distributed query."""
        cache = ex.scan_cache.values()
        stats = {
            "elapsedS": round(elapsed_s, 6),
            "deviceS": round(sum(st.device_s for st in ex.node_stats.values()), 6),
            "completedSplits": max(1, len(ex.scan_stats)),
            "totalSplits": max(1, len(ex.scan_stats)),
            "inputRows": int(sum(ex.scan_stats.values())),
            "outputRows": len(self.rows),
            "outputBytes": sum(st.output_bytes for st in ex.node_stats.values()),
            "peakBytes": int(ex.memory.peak),
            "spills": len(ex.memory.spills),
            "deviceCacheHits": sum(1 for d in cache if d == "hit"),
            "deviceCacheMisses": sum(1 for d in cache if d == "miss"),
            "operatorStats": [st.to_dict() for st in ex.node_stats.values()],
        }
        self._note_task_status(f"{self.query_id}.0.local.a0",
                               {"state": "FINISHED", "stats": stats})

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
        # the stage-boundary hook of adaptive execution: after the phased
        # build waits, a fragment whose tasks do not exist yet may be
        # rewritten from the completed stages' actual numbers
        adaptive = self._make_adaptive_planner(session, fragments, workers)
        for frag in list(fragments):
            if phased and frag.id in build_deps:
                self._await_build_fragments(build_deps[frag.id])
                self.phase_waits.append((frag.id, build_deps[frag.id]))
            if adaptive is not None and frag.partitioning != "single":
                for nf in self._adapt_fragment(adaptive, frag, by_id, fragments,
                                               consumer_counts, workers):
                    self._schedule_fragment(session, nf, workers, consumer_counts)
            self._schedule_fragment(session, frag, workers, consumer_counts)

    # --------------------------------------------------- adaptive execution
    def _make_adaptive_planner(self, session, fragments, workers):
        """The query's AdaptivePlanner, or None when
        ``adaptive_execution_enabled`` is off."""
        if not _truthy(session.properties.get("adaptive_execution_enabled", True)):
            return None
        from trino_tpu_torch.adaptive import AdaptivePlanner, RuntimeStatsProvider
        from trino_tpu_torch.sql.planner.fragmenter import fresh_fragment_ids

        def entries():
            with self._tstats_lock:
                return [dict(e) for e in self.task_stats.values()]

        provider = RuntimeStatsProvider(
            entries, sweep_fn=self._sweep_task_stats,
            expected_tasks_fn=lambda fid: len(self.fragment_tasks.get(fid, ())))
        return AdaptivePlanner(session, provider, len(workers), fresh_fragment_ids(fragments))

    def _adapt_fragment(self, planner, frag, by_id, fragments, consumer_counts, workers):
        """Run the adaptive rules on one not-yet-scheduled fragment: record
        each applied change (planVersions, a ``plan/adapt`` span, the
        adaptive metrics), cancel the producers it superseded, and return
        the new producer fragments to schedule first. A rule's failure is
        recorded on an errored ``plan/adapt`` span and swallowed: a
        stats-driven rewrite never fails a query that runs unadapted."""
        from trino_tpu_torch.obs import metrics as M

        try:
            new_frags, changes, errors = planner.adapt_fragment(frag, by_id)
        except Exception as e:  # noqa: BLE001 — adaptivity is best-effort
            new_frags, changes, errors = [], [], [str(e)]
        for err in errors:
            with self.tracer.span("plan/adapt", fragment=frag.id) as sp:
                sp.set("error", str(err)[:300])
        for ch in changes:
            self.plan_versions.append(ch.to_dict())
            with self.tracer.span("plan/adapt", fragment=ch.fragment) as sp:
                sp.set("rule", ch.rule)
                sp.set("version", ch.version)
                sp.set("description", ch.description)
            M.ADAPTIVE_ADAPTATIONS.inc(1, ch.rule)
            if ch.rule == "join-distribution":
                M.ADAPTIVE_JOIN_FLIPS.inc(1, "to_partitioned" if ch.description.endswith(
                    "partitioned") else "to_broadcast")
            elif ch.rule == "capacity-reseed":
                M.ADAPTIVE_RESEEDED_SOURCES.inc(len(ch.detail.get("runtimeRows", {})))
            elif ch.rule == "skew-mitigation":
                M.ADAPTIVE_SKEW_HOT_PARTITIONS.inc(len(ch.detail.get("hotPartitions", ())))
            # the superseded producers' buffers will never be pulled
            for fid in ch.supersedes:
                for loc in self.fragment_tasks.get(fid, ()):
                    self._cancel_superseded(loc)
        for nf in new_frags:
            consumer_counts[nf.id] = len(workers)
            fragments.insert(fragments.index(frag), nf)
        return new_frags

    def _cancel_superseded(self, loc: TaskLocation) -> None:
        """Cancel a superseded producer task, and mark its slot CANCELED
        (its last numbers kept): the worker drops a canceled task, so a
        later status read could only fail."""
        self._cancel_attempt(loc)
        with self._tstats_lock:
            have = self.task_stats.get(loc.task_id.rsplit(".a", 1)[0])
            if have is not None and have["taskId"] == loc.task_id and \
                    have["state"] not in ("FINISHED", "FAILED"):
                have["state"] = "CANCELED"

    @staticmethod
    def _cancel_attempt(loc: Optional[TaskLocation]) -> None:
        """Best-effort cancel of one task."""
        if loc is None:
            return
        try:
            wire.http_request("DELETE", f"{loc.base_url}/v1/task/{loc.task_id}", timeout=5.0)
        except Exception:  # noqa: BLE001
            pass

    def _adapted_notes(self) -> Dict[int, str]:
        """fragment id -> change description, for EXPLAIN ANALYZE's
        ``[adapted: ...]`` annotations."""
        notes: Dict[int, str] = {}
        for ch in self.plan_versions:
            notes[ch["fragment"]] = ch["description"]
            for fid in ch.get("newFragments", ()):
                notes.setdefault(fid, ch["description"])
            for fid in ch.get("supersedes", ()):
                notes[fid] = "superseded"
        return notes

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
            output_partition_channels=frag.output_partition_channels,
            skew_spread_partitions=frag.skew_spread_partitions,
            skew_replicate_partitions=frag.skew_replicate_partitions,
            collect_stats=self._collect_stats)
        status, resp, _ = wire.http_request(
            "POST", f"{worker['url']}/v1/task/{task_id}", req.to_bytes())
        if status >= 400:
            raise RuntimeError(f"task create failed on {worker['nodeId']}: "
                               f"{resp[:300].decode(errors='replace')}")
        # the create response is a status payload: it seeds the slot, so
        # totalSplits is known while the task runs
        self._note_task_status(task_id, json.loads(resp))
        return TaskLocation(worker["url"], task_id)

    # ------------------------------------------------------ stats pipeline
    def _note_task_status(self, task_id: str, info: dict) -> None:
        """Record one task-status payload into the slot map the stage and
        query rollups read."""
        parts = task_id.split(".")
        try:
            frag = int(parts[-3])
        except (ValueError, IndexError):
            return
        slot = task_id.rsplit(".a", 1)[0]
        entry = {"fragment": frag, "taskId": task_id,
                 "state": info.get("state") or "RUNNING", "stats": info.get("stats") or {}}

        def progress(e):
            st = e.get("stats") or {}
            return (int(st.get("completedSplits", 0)), int(st.get("inputRows", 0)),
                    int(st.get("outputRows", 0)))

        with self._tstats_lock:
            have = self.task_stats.get(slot)
            # a FINISHED attempt's record is final for its slot
            if have is not None and have["state"] == "FINISHED" and entry["state"] != "FINISHED":
                return
            # another attempt of the slot: a dead record never displaces a
            # live one, and while neither finished the one further along
            # stays, so live numbers never regress
            dead = ("FAILED", "CANCELED")
            if (have is not None and have["taskId"] != task_id and entry["state"] in dead
                    and have["state"] not in dead):
                return
            if (have is not None and entry["state"] != "FINISHED"
                    and have["state"] not in dead and have["taskId"] != task_id
                    and progress(entry) < progress(have)):
                return
            self.task_stats[slot] = entry

    def _poll_task(self, loc: TaskLocation, timeout: float = 10.0) -> Optional[dict]:
        """One status read of a task, recorded (None when it fails)."""
        with self._tstats_lock:
            self.status_polls += 1
        try:
            status, body, _ = wire.http_request(
                "GET", f"{loc.base_url}/v1/task/{loc.task_id}/status", timeout=timeout)
        except Exception:  # noqa: BLE001 — a worker gone reads as no status
            return None
        if status >= 400:
            return None
        info = json.loads(body)
        self._note_task_status(loc.task_id, info)
        return info

    def _sweep_task_stats(self) -> int:
        """One status read of every scheduled task whose record is not yet
        terminal (the poller's body, a stage boundary's snapshot and the
        final freeze); a sub-second timeout keeps one unreachable worker
        from stalling it. Returns the tasks polled: 0 is the poller's
        backoff signal."""
        with self._tstats_lock:
            done = {e["taskId"] for e in self.task_stats.values()
                    if e["state"] in ("FINISHED", "FAILED", "CANCELED")}
        locations = [loc for locs in list(self.fragment_tasks.values()) for loc in list(locs)
                     if loc.task_id not in done]
        for loc in locations:
            self._poll_task(loc, timeout=0.8)
        return len(locations)

    STATS_POLL_INTERVAL = 0.25
    STATS_POLL_MAX_BACKOFF = 16.0  # x the base interval

    def _start_stats_poller(self) -> None:
        """Poll the tasks' status in the background while the query runs,
        so ``GET /v1/query/{id}`` serves live stage and query stats. Each
        sleep is jittered, so concurrent queries de-phase, and a sweep that
        found nothing to poll backs off exponentially."""

        def poll():
            import random

            backoff = 1.0
            while not self.state.is_terminal():
                polled = self._sweep_task_stats()
                backoff = (min(backoff * 2.0, self.STATS_POLL_MAX_BACKOFF)
                           if polled == 0 else 1.0)
                # wakes at once when the query ends, so no poller outlives it
                self.state.wait_for_terminal(
                    self.STATS_POLL_INTERVAL * backoff * random.uniform(0.75, 1.25))

        self._stats_poller = threading.Thread(target=poll, daemon=True,
                                              name=f"stats:{self.query_id}")
        self._stats_poller.start()

    def stage_stats(self, include_operators: bool = True) -> List[dict]:
        """Per-stage rollups of the latest task records;
        ``include_operators=False`` skips the per-node merges (the
        protocol's polls read only the scalar summary)."""
        from trino_tpu_torch.exec.operator_stats import rollup_tasks_to_stage

        with self._tstats_lock:
            entries = [dict(e) for e in self.task_stats.values()]
        by_frag: Dict[int, List[dict]] = {}
        for e in entries:
            by_frag.setdefault(e["fragment"], []).append(e)
        return [rollup_tasks_to_stage(fid, es, include_operators=include_operators)
                for fid, es in sorted(by_frag.items())]

    def task_records(self) -> List[dict]:
        """The slot records, each with its task's worker URL."""
        url_by_task = {loc.task_id: loc.base_url for locs in list(self.fragment_tasks.values())
                       for loc in list(locs)}
        with self._tstats_lock:
            entries = [dict(e) for e in self.task_stats.values()]
        for e in entries:
            e["workerUri"] = url_by_task.get(e["taskId"])
        return entries

    def query_stats(self, stages: Optional[List[dict]] = None) -> dict:
        """The query-level rollup: live while the query runs, frozen once
        it is terminal (polling stops and a FINISHED slot never changes)."""
        from trino_tpu_torch.exec.operator_stats import rollup_stages_to_query

        qs = rollup_stages_to_query(self.stage_stats() if stages is None else stages)
        end = self.ended_at if self.state.is_terminal() and self.ended_at else time.time()
        qs["elapsedMs"] = int((end - self.created_at) * 1000)
        qs["state"] = self.state.get()
        qs["cacheStatus"] = self.cache_status
        # the resource group that admitted the query
        qs["resourceGroup"] = self.resource_group
        # which path served the SELECT (fast-path | distributed | local-catalog)
        qs["fastPath"] = self.fast_path
        qs["resultRows"] = len(self.rows)
        # adaptive plan changes applied so far
        qs["adaptations"] = len(self.plan_versions)
        # the materialized views substituted into this query's plan
        qs["mvHits"] = len(self.mv_substitutions)
        if self.mv_substitutions:
            qs["mvNames"] = list(self.mv_substitutions)
        qs["memory"] = {"peakBytes": int(qs.get("peakBytes") or 0),
                        "shedBytes": int(qs.get("shedBytes") or 0),
                        "yieldEvents": int(qs.get("yieldEvents") or 0),
                        "spills": int(qs.get("spills") or 0)}
        return qs

    # ---------------------------------------------------- flight recorder
    def capture_postmortem(self, store: bool = True, timeout: float = 3.0) -> dict:
        """This process's flight-recorder ring and memory-ledger snapshot
        merged with every involved worker's (``GET /v1/task/{id}/recorder``):
        taken when the query FAILED, kept on the execution and shipped on
        its completed event."""
        from trino_tpu_torch.obs.flightrecorder import pull_worker_rings
        from trino_tpu_torch.obs.memledger import MEMORY_LEDGER

        locations = [loc for locs in list(self.fragment_tasks.values()) for loc in list(locs)]
        # taken before FAILED is published: a set failure means FAILED
        state = self.state.get()
        if self.failure is not None and not self.state.is_terminal():
            state = "FAILED"
        pm = {
            "queryId": self.query_id,
            "state": state,
            "failure": (self.failure or "").split("\n")[0] or None,
            "capturedAt": time.time(),
            "coordinator": {
                "nodeId": getattr(self.recorder, "node_id", "coordinator"),
                "records": self.recorder.snapshot() if self.recorder is not None else [],
                "memory": MEMORY_LEDGER.memory_snapshot(),
            },
            "workers": pull_worker_rings(locations, timeout=timeout),
        }
        if store:
            self.postmortem = pm
        return pm

    # ---------------------------------------------------- device profiler
    def kernel_rows_live(self) -> List[dict]:
        """This query's merged kernel-ledger rows: the workers' from the
        task records (stamped with the worker's URL), the coordinator's
        from its own executor. Superseded fragments re-ran as copies with
        the same plan-node ids and stay out."""
        from trino_tpu_torch.obs.devprofiler import merge_kernel_rows

        merged: Dict[tuple, dict] = {}
        superseded = {fid for ch in self.plan_versions for fid in ch.get("supersedes", ())}
        for rec in self.task_records():
            if rec.get("fragment") in superseded:
                continue
            node = rec.get("workerUri") or "coordinator"
            rows = (rec.get("stats") or {}).get("kernelStats") or []
            merge_kernel_rows(merged, [dict(r, nodeId=r.get("nodeId") or node) for r in rows])
        for ex in (self._local_executor, self._root_executor):
            if ex is not None:
                merge_kernel_rows(merged, [dict(r, nodeId="coordinator")
                                           for r in ex.kernel_stats.values()])
        rows = []
        for k in sorted(merged):
            row = dict(merged[k], queryId=self.query_id)
            row["dispatchOverheadS"] = round(max(0.0, row["wallS"] - row["deviceS"]), 6)
            rows.append(row)
        return rows

    def fold_kernel_profile(self) -> None:
        """Fold the merged kernel rows into the process's device profiler
        once, at the end (per-operator launch and overhead metrics bump
        here, never per dispatch). Observability: it never fails a query."""
        if self._kernels_folded:
            return
        self._kernels_folded = True
        from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER

        try:
            rows = self.kernel_rows_live()
            if rows:
                DEVICE_PROFILER.record_query_kernels(self.query_id, rows)
        except Exception:  # noqa: BLE001 — observability only
            pass

    # ------------------------------------------------- EXPLAIN ANALYZE
    def _explain_analyze(self, session, stmt) -> str:
        """Distributed EXPLAIN ANALYZE: plan, execute through the real
        fragment/schedule path with per-operator stats on, then render the
        fragments with the rolled-up worker stats (reference:
        PlanPrinter.textDistributedPlan with stats)."""
        from trino_tpu_torch.exec.operator_stats import merge_operator_dicts, wall_time_header
        from trino_tpu_torch.exec.query import _expand_udfs, mv_notes_header
        from trino_tpu_torch.sql.planner.fragmenter import format_fragments
        from trino_tpu_torch.sql.planner.optimizer import optimize
        from trino_tpu_torch.sql.planner.planner import Planner

        self._collect_stats = True
        inner = _expand_udfs(session, stmt.statement)
        t_plan = time.perf_counter()
        with tracing.span("analyze/plan"):
            root = Planner(session).plan(inner)
        with tracing.span("optimize"):
            root = optimize(root, session)
        root, _versions = self._substitute_matviews(session, root, None)
        plan_s = time.perf_counter() - t_plan
        t_exec = time.perf_counter()
        self._execute_query(session, root)
        exec_s = time.perf_counter() - t_exec
        header = [wall_time_header(plan_s, exec_s)]
        mv_lines = mv_notes_header(self.mv_notes)
        if mv_lines:
            header.extend(mv_lines.rstrip("\n").split("\n"))
        if self.fragments is None:
            # a process-local catalog or a fast-path plan ran on the
            # coordinator's own executor: annotate from it
            ex = self._local_executor
            if self.fast_path == "fast-path":
                header.append("Fast path: coordinator-local ("
                              + (self.fast_path_reason or "short query") + ")")
            header.append(f"Peak working set: {(ex.memory.peak if ex else 0) // 1024}KiB"
                          " (coordinator)")
            return "\n".join(header) + "\n" + P.format_plan(root, executor=ex,
                                                           verbose=stmt.verbose)
        stages = self.stage_stats()
        # superseded fragments re-ran as copies with the same plan-node ids:
        # their operators stay out of the merge (their fragment header
        # keeps its stage totals)
        superseded = {fid for ch in self.plan_versions for fid in ch.get("supersedes", ())}
        with self._tstats_lock:
            op_lists = [e["stats"].get("operatorStats") for e in self.task_stats.values()
                        if e["fragment"] not in superseded]
        # the root fragment ran on the coordinator: its executor completes
        # the tree
        if self._root_executor is not None:
            op_lists.append([st.to_dict() for st in self._root_executor.node_stats.values()])
        node_stats = merge_operator_dicts(op_lists)
        qs = self.query_stats(stages)
        header.append(
            f"Stages: {len(stages)} scheduled + 1 coordinator,"
            f" splits: {qs['completedSplits']}/{qs['totalSplits']},"
            f" input rows: {qs['totalRows']},"
            f" peak task memory: {qs['peakBytes'] // 1024}KiB,"
            f" spills: {qs['spills']}")
        # the largest task peak each worker reached: the skewed node a
        # cluster-wide rollup hides
        node_peaks: Dict[str, int] = {}
        for rec in self.task_records():
            node = rec.get("workerUri") or "coordinator"
            pb = int((rec.get("stats") or {}).get("peakBytes") or 0)
            if pb > node_peaks.get(node, 0):
                node_peaks[node] = pb
        if node_peaks:
            header.append("Peak task memory by node: " + ", ".join(
                f"{node} {pb // 1024}KiB" for node, pb in sorted(node_peaks.items())))
        kern = None
        if stmt.verbose:
            kern = P.kernel_annotations(self.kernel_rows_live())
        return "\n".join(header) + "\n" + format_fragments(
            self.fragments, stats=node_stats, stage_stats={s["stageId"]: s for s in stages},
            verbose=stmt.verbose, adapted=self._adapted_notes(), kernels=kern)

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
        ex = FragmentExecutor(session, {}, remote_pages, collect_stats=self._collect_stats or None)
        self._root_executor = ex  # EXPLAIN ANALYZE: the root stage's stats
        return ex.execute_checked(root_frag.root)

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
        """The statement protocol's stats block: the query rollup over the
        stages' scalar summaries (no per-node merge on a poll)."""
        return {**self.query_stats(self.stage_stats(include_operators=False)),
                "state": self.state.get()}

    def info(self) -> dict:
        stages = self.stage_stats()
        return {
            "queryId": self.query_id,
            "state": self.state.get(),
            "user": self.user,
            "query": self.sql,
            "failure": (self.failure or "").split("\n")[0] or None,
            "cacheStatus": self.cache_status,
            "fastPath": self.fast_path,
            "resourceGroup": self.resource_group,
            "fragments": {str(fid): [loc.task_id for loc in locs]
                          for fid, locs in self.fragment_tasks.items()},
            # the slot records by task id
            "tasks": {e["taskId"]: {"state": e["state"], "stats": e["stats"]}
                      for e in self.task_records()},
            # versioned plan changes of the adaptive re-planner
            "planVersions": list(self.plan_versions),
            "queryStats": self.query_stats(stages),
            "stageStats": stages,
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


class QueryHistory:
    """Bounded ring of completed-query records (the reference's
    ``QueryTracker`` expiry): the oldest go past ``MAX_HISTORY``."""

    MAX_HISTORY = 100

    def __init__(self):
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def record(self, entry: dict) -> None:
        evicted = 0
        with self._lock:
            self._entries[entry["queryId"]] = entry
            self._entries.move_to_end(entry["queryId"])
            while len(self._entries) > self.MAX_HISTORY:
                self._entries.popitem(last=False)
                evicted += 1
        if evicted:
            M.QUERY_HISTORY_EVICTIONS.inc(evicted)

    def snapshot(self) -> List[dict]:
        """Newest first."""
        with self._lock:
            return list(reversed(self._entries.values()))


def query_record(execution: QueryExecution, state: str, ended_at: float) -> dict:
    """One terminal query's history record."""
    qs = execution.query_stats(execution.stage_stats(include_operators=False))
    return {
        "queryId": execution.query_id,
        "state": state,
        "user": execution.user,
        "source": execution.source,
        "query": execution.sql,
        "resourceGroup": execution.resource_group,
        "createdAt": float(execution.created_at),
        "endedAt": float(ended_at),
        "elapsedMs": int(qs.get("elapsedMs", 0)),
        "peakBytes": int(qs.get("peakBytes") or 0),
        "resultRows": len(execution.rows),
        "cacheStatus": execution.cache_status,
        "failure": (execution.failure or "").split("\n")[0] or None,
    }


class CoordinatorServer:
    """The coordinator process: discovery registry, dispatch, statement
    protocol.

    ``resource_group`` injects a flat blocking gate (the reference's
    ``ResourceGroup`` or ``ResourceGroupManager``) in place of the
    resource-group tree; ``resource_groups_config`` is the tree's config
    (a dict or a JSON file's path; else ``TRINO_TPU_RESOURCE_GROUPS_CONFIG``,
    else one root group ``global``), validated here so a bad one fails the
    server's start. ``cluster_memory_limit_bytes`` is the cluster's
    admission ceiling (None: the workers' announced device capacity) and
    ``low_memory_killer`` the kill policy (default: the largest
    reservation). ``authenticator`` guards the public routes (None: an
    open cluster). ``executor_lanes`` and ``dispatch_queue_capacity`` size
    the dispatch plane (defaults: ``max(8, min(32, 4 x cpus))`` lanes and
    256 queued, or ``TRINO_TPU_EXECUTOR_LANES`` and
    ``TRINO_TPU_DISPATCH_QUEUE_CAPACITY``). ``executor_plane="process"``
    (and ``executor_processes``) asks for executor processes, which the
    port does not have: it raises NotImplementedError."""

    MAX_QUERY_HISTORY = 100  # terminal queries kept in the registry (oldest evicted)

    def __init__(self, port: int = 0, session_factory=None, resource_group=None,
                 cluster_memory_limit_bytes=None, low_memory_killer=None,
                 authenticator=None, executor_lanes=None, dispatch_queue_capacity=None,
                 executor_plane=None, executor_processes=None,
                 resource_groups_config=None, device=None):
        from trino_tpu_torch.connector.registry import default_catalogs
        from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER
        from trino_tpu_torch.obs.flightrecorder import FlightRecorder
        from trino_tpu_torch.obs.memledger import MEMORY_LEDGER
        from trino_tpu_torch.server.cluster_memory import (ClusterMemoryManager,
                                                           total_reservation_killer)
        from trino_tpu_torch.server.resource_groups import (ResourceGroupTree, config_from_env,
                                                            load_config_file, parse_config)

        self.device = resolve_device(device)
        self.registry = NodeRegistry()
        self.cluster_memory = ClusterMemoryManager(
            kill=self._kill_query, cluster_limit_bytes=cluster_memory_limit_bytes,
            policy=low_memory_killer or total_reservation_killer)
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
        self.history = QueryHistory()
        # admission: the resource-group tree (selector-routed, weighted-fair,
        # per-group concurrency, queue and memory limits), or an injected
        # flat gate
        if resource_group is not None:
            self.resource_groups = None
            self.resource_group = resource_group
        else:
            if resource_groups_config is None:
                roots, selectors = config_from_env()
            elif isinstance(resource_groups_config, str):
                roots, selectors = load_config_file(resource_groups_config)
            else:
                roots, selectors = parse_config(resource_groups_config)
            self.resource_groups = ResourceGroupTree(roots, selectors)
            # group memory limits read the cluster's live per-query bytes
            self.resource_groups.set_memory_probe(self.cluster_memory.query_reservations)
            self.resource_group = self.resource_groups
        self.authenticator = authenticator
        self.events = ev.EventListenerManager()
        self.queries_submitted = 0
        self.start_time = time.time()
        # this process's flight recorder; the process memory ledger and
        # device profiler take the first server's identity and mirror their
        # events into it
        self.recorder = FlightRecorder(node_id="coordinator")
        for ledger in (MEMORY_LEDGER, DEVICE_PROFILER):
            if not ledger.node_id:
                ledger.node_id = "coordinator"
            ledger.attach_recorder(self.recorder)
        # executor_processes sizes the process plane, which resolve_plane refuses
        self.dispatcher = Dispatcher(
            self, lanes=executor_lanes, queue_capacity=dispatch_queue_capacity,
            plane=executor_plane, groups=self.resource_groups)
        self.httpd = wire.ServerHTTP(("127.0.0.1", port), _make_handler(self))
        self.port = self.httpd.server_address[1]
        self.base_url = f"http://127.0.0.1:{self.port}"
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self) -> None:
        self._serve_thread.start()
        self.dispatcher.ensure_lanes()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.dispatcher.shutdown()

    def submit(self, sql: str, properties: Optional[dict] = None,
               user: str = "anonymous", source: str = "") -> QueryExecution:
        """Register one statement and dispatch it. Raises DispatchRejected
        (HTTP 429) when its queue is full, before any per-query state."""
        group = None
        if self.resource_groups is not None:
            group = self.resource_groups.select(user, source, properties or {})
        self.dispatcher.precheck(group)
        query_id = f"q{time.strftime('%Y%m%d')}_{next(self._qid):05d}_{uuid.uuid4().hex[:5]}"
        execution = QueryExecution(query_id, sql, properties or {}, self.registry,
                                   self.session_factory, user=user,
                                   query_cache=self.query_cache,
                                   prepared_registry=self.prepared,
                                   prepared_meta=self.prepared_meta)
        execution.resource_group = group
        execution.source = source
        execution.recorder = self.recorder
        execution.tracer.recorder = self.recorder
        self.recorder.record("admission", "submitted", queryId=query_id, user=user)
        with self._qlock:
            if len(self.queries) > self.MAX_QUERY_HISTORY:
                terminal = [qid for qid, q in self.queries.items() if q.state.is_terminal()]
                for qid in terminal[: max(0, len(terminal) - self.MAX_QUERY_HISTORY)]:
                    del self.queries[qid]
            self.queries[query_id] = execution
            self.queries_submitted += 1
        created_at = time.time()
        self.events.fire_created(ev.QueryCreatedEvent(query_id, user, sql, created_at))
        execution.state.add_listener(
            lambda state: self._on_terminal(execution, state, created_at))
        try:
            self.dispatcher.dispatch(execution)
        except DispatchRejected as e:
            # lost the capacity race after registration: unregister, and
            # keep the serving index (the statement ran nothing)
            execution.is_plain_select = True
            with self._qlock:
                self.queries.pop(query_id, None)
            execution.failure = str(e)
            execution.ended_at = time.time()
            execution.state.set("FAILED")
            self.recorder.record("admission", "dispatch-rejected", queryId=query_id, user=user)
            raise
        return execution

    def _on_terminal(self, execution: QueryExecution, state: str, created_at: float) -> None:
        """The terminal listener: serving-index upkeep, the wall and peak
        histograms, the history record, the postmortem of a FAILED query
        killed from another thread, and the completed event."""
        if state not in ("FINISHED", "FAILED", "CANCELED"):
            return
        try:
            self.dispatcher.note_completion(execution, execution.is_plain_select)
        except Exception:  # noqa: BLE001 — index upkeep never disturbs the transition
            pass
        now = time.time()
        wall = now - created_at
        M.QUERY_SECONDS.observe(wall, state)
        self.recorder.record("event", "query-completed", queryId=execution.query_id,
                             state=state, wallS=round(wall, 6))
        try:
            peak = int(execution.query_stats().get("peakBytes") or 0)
            if peak:
                M.QUERY_PEAK_MEMORY_BYTES.observe(peak, state)
            self.history.record(query_record(execution, state, now))
        except Exception:  # noqa: BLE001 — observability never disturbs the transition
            pass
        if state == "FAILED" and execution.postmortem is None:
            try:
                execution.capture_postmortem()
            except Exception:  # noqa: BLE001 — best-effort forensics
                pass
        self.events.fire_completed(ev.QueryCompletedEvent(
            execution.query_id, execution.user, execution.sql, state, created_at, now, wall,
            len(execution.rows), execution.failure,
            spans=tuple(execution.tracer.to_dicts()),
            session_properties=dict(execution.session_properties),
            postmortem=execution.postmortem))

    ADMISSION_DEADLINE_S = 600.0

    def _admit(self, execution: QueryExecution) -> bool:
        """Admission on an executor lane after dequeue: the resource group,
        then the cluster-memory gate. False when the query failed admission
        or went terminal while queued: the lane moves on."""
        user = execution.user
        qid = execution.query_id
        if self.resource_groups is not None:
            # the tree admitted the query at dequeue: release its slot at
            # terminal, or now if it went terminal in between
            groups = self.resource_groups
            if execution.state.is_terminal():
                groups.finish(qid)
                return False
            execution.state.add_listener(
                lambda s: groups.finish(qid) if s in ("FINISHED", "FAILED", "CANCELED") else None)
            self.recorder.record("admission", "admitted", queryId=qid, user=user,
                                 group=execution.resource_group)
        else:
            if execution.state.is_terminal():
                return False
            if not self.resource_group.submit(timeout=self.ADMISSION_DEADLINE_S, user=user):
                execution.failure = "Query queue is full (resource group limit)"
                self.recorder.record("admission", "queue-full", queryId=qid, user=user)
                execution.state.set("FAILED")
                return False
            self.recorder.record("admission", "admitted", queryId=qid, user=user)
        # the cluster-memory gate: wait while the cluster is over its limit
        # (the killer frees it); a cluster still full at the deadline fails
        # the query, never dispatches it over the limit
        deadline = time.monotonic() + self.ADMISSION_DEADLINE_S
        while (not self.cluster_memory.has_headroom() and not execution.state.is_terminal()
               and time.monotonic() < deadline):
            time.sleep(0.2)
        if not execution.state.is_terminal() and not self.cluster_memory.has_headroom():
            execution.failure = ("Cluster is out of memory and did not recover within the "
                                 "admission deadline (EXCEEDED_CLUSTER_MEMORY)")
            execution.state.set("FAILED")
        if execution.state.is_terminal():
            if self.resource_groups is None:
                self.resource_group.finish(user=user)
            return False
        if self.resource_groups is None:
            execution.state.add_listener(
                lambda s: self.resource_group.finish(user=user)
                if s in ("FINISHED", "FAILED", "CANCELED") else None)
        return True

    def _kill_query(self, query_id: str, reason: str) -> None:
        q = self.get_query(query_id)
        if q is not None and not q.state.is_terminal():
            self.recorder.record("event", "query-killed", queryId=query_id)
            q.kill(reason)

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
                server.cluster_memory.update(m.group(1), info)
                self._send(200, b"{}")
                return
            self._send(404)

        def _identity(self):
            """The authenticated principal, None on an open cluster, or
            False after answering 401."""
            auth = server.authenticator
            if auth is None or not auth.required:
                return None
            try:
                return auth.authenticate_header(self.headers.get("Authorization"))
            except AuthenticationError as e:
                self._send(401, json.dumps(
                    {"error": {"message": f"Authentication failed: {e}"}}).encode(),
                    headers={"WWW-Authenticate": AUTH_CHALLENGE})
                return False

        def _authenticated(self, query=None) -> bool:
            """The gate of a query's routes under an authenticator: valid
            credentials (401), and with ``query`` its owner's (403)."""
            identity = self._identity()
            if identity is False:
                return False
            if identity is not None and query is not None and query.user != identity.user:
                self._send(403, json.dumps({"error": {
                    "message": "Access Denied: query belongs to another user"}}).encode())
                return False
            return True

        def do_POST(self):
            if self.path == "/v1/statement":
                sql = self._read_body().decode()
                props = {}
                for header, value in self.headers.items():
                    if header.lower().startswith("x-trino-session-"):
                        props[header[len("x-trino-session-"):].lower()] = value
                user = self.headers.get("X-Trino-User", "anonymous")
                identity = self._identity()
                if identity is False:
                    return
                if identity is not None:
                    # the authenticated principal wins over the claimed user
                    user = identity.user
                source = self.headers.get("X-Trino-Source", "")
                try:
                    q = server.submit(sql, props, user=user, source=source)
                except DispatchRejected as e:
                    # typed overload: the client backs off and resubmits
                    self._send(429, json.dumps(e.payload()).encode(),
                               headers={"Retry-After": f"{e.retry_after_s:g}"})
                    return
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
                if not self._authenticated(query=q):
                    return
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
                if not self._authenticated(query=q):
                    return
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
            if self.path == "/v1/metrics":
                self._send(200, ev.render_metrics(server).encode(), "text/plain; version=0.0.4")
                return
            self._send(404)

        def do_DELETE(self):
            if self._not_ported():
                return
            m = _RESULT_RE.match(self.path)
            if m:
                q = server.get_query(m.group(1))
                if not self._authenticated(query=q):
                    return
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
