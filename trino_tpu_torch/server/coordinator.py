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
workers' flight-recorder rings, memory-ledger, device-profiler and
flow-ledger snapshots. With an ``authenticator`` (server/auth.py) every
public route asks for Basic or Bearer credentials (401) and a query's
routes answer only its owner (403). ``GET /v1/metrics`` serves the
Prometheus page.

The observability plane: each query's trace merges the coordinator's spans
with its tasks' (``GET /v1/task/{id}/spans`` on the workers, parented
under the schedule span through the traceparent header), and at its end
the phase ledger (obs/timeline.py) attributes every instant of its wall to
one phase; the flow ledger (obs/flowledger.py) types every byte that moved
(exchange pulls, staging copies, client drains, control calls) and flags
straggler tasks. ``GET /v1/query/{id}/trace[?recorder=1]``, ``/profile``
and ``/flows`` serve them, ``/ui`` a status page, distributed EXPLAIN
ANALYZE prints them as its "Phase ledger", "Data flow" and "Straggler"
lines, and the ``system`` catalog (connector/system/, fed by
server/system_tables.py) serves queries, tasks, nodes, kernels, compiles,
transfers, stragglers and the rest as SQL tables, with the procedures
``kill_query`` and ``sync_materialized_view``. Completed queries go to the
event listeners (the slow-query log, the JSONL query log named by
``TRINO_TPU_QUERY_LOG``) and, with ``TRINO_TPU_OTLP_ENDPOINT`` set, to an
OTLP collector.

The fault-tolerant tier (``retry_policy=TASK``, which needs the spool
directory ``TRINO_TPU_SPOOL_DIR``) schedules stage by stage: all tasks of a
stage run at once, and the next stage is scheduled only once every one of
them FINISHED with its output spooled (server/task.py), so its consumers
read durable files and the adaptive rules see both join producers done (the
skew salting's input). A failed, unreachable or timed-out attempt is
canceled and retried on the next worker, ``MAX_TASK_ATTEMPTS`` in all; a
first attempt past ``SPECULATION_FACTOR`` times its siblings' median
(``SPECULATION_MIN_S`` at least) gets a speculative twin, and the first to
finish wins. A query's spool files go at its end, ``.tmp`` ones included.

The spooled result protocol (``spooled_results_enabled``): a result at or
over ``spooled_results_threshold_bytes`` (or over
``inline_result_max_bytes``) leaves as a manifest of size-bounded segments
(server/segments.py) that the client fetches in parallel. An export-shaped
plan (the root fragment a pass-through gather) has its producing tasks
write the segments on the workers, so the coordinator never touches the
data (not under the fault-tolerant tier, whose losing attempts would leave
segments behind); any other result spools into the coordinator's own
store. ``/v1/segment/{id}`` serves the coordinator's segments and forwards
a client's ack of a worker's. A spooled result never enters the result
cache, and a view refresh never spools.

The coordinator runs on one torch device: CUDA unless it is given another
(``device="cpu"`` in the tests); asked for CUDA without a usable GPU it
raises. Under the executor-process plane (``executor_plane="process"``,
server/dispatch.py) plain SELECTs and EXECUTEs run in executor children on
the same device; PREPARE, DEALLOCATE and view changes replicate to them.

    python -m trino_tpu_torch.server.coordinator [--port N] [--device cuda|cpu]

prints ``{"url": ...}`` once it serves.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import threading
import time
import traceback
import uuid
import weakref
from collections import deque
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional

from trino_tpu_torch.data.serde import serialize_page
from trino_tpu_torch.exec.query import MATVIEW_STATEMENTS
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.server import events as ev
from trino_tpu_torch.server import wire
from trino_tpu_torch.server.auth import AuthenticationError
from trino_tpu_torch.server.dispatch import Dispatcher, DispatchRejected
from trino_tpu_torch.server.exchange_client import ExchangeClient, TaskLocation
from trino_tpu_torch.server.statemachine import StateMachine, query_state_machine
from trino_tpu_torch.server.task import TaskRequest, spool_directory
from trino_tpu_torch.server.worker import resolve_device
from trino_tpu_torch.sql.parser import ast
from trino_tpu_torch.sql.planner import plan as P
from trino_tpu_torch.sql.planner.fragmenter import RemoteSourceNode, fragment_plan

_ANNOUNCE_RE = re.compile(r"^/v1/announce/([^/]+)$")
_RESULT_RE = re.compile(r"^/v1/statement/executing/([^/]+)/(\d+)$")
_QUERY_RE = re.compile(r"^/v1/query/([^/]+)$")
_TRACE_RE = re.compile(r"^/v1/query/([^/]+)/trace$")
_PROFILE_RE = re.compile(r"^/v1/query/([^/]+)/profile$")
_FLOWS_RE = re.compile(r"^/v1/query/([^/]+)/flows$")
_SEGMENT_RE = re.compile(r"^/v1/segment/([^/]+)$")

# the WWW-Authenticate challenge of a 401
AUTH_CHALLENGE = 'Basic realm="trino-tpu", Bearer'

RESULT_PAGE_ROWS = 10_000
# the result-cache disposition header (HIT | MISS | BYPASS)
CACHE_HEADER = "X-Trino-Tpu-Cache"
# _consult_result_cache's answer when the rows came from the cache
_SERVED_FROM_CACHE = "__served_from_cache__"


def _truthy(v) -> bool:
    return str(v).lower() not in ("false", "0", "no", "none", "")


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

    def snapshot(self) -> List[dict]:
        """Every known node with its last announce payload and heartbeat
        age, dead entries included (``system.runtime.nodes`` shows them)."""
        now = time.monotonic()
        with self._lock:
            return [{"nodeId": nid, "url": info["url"], "info": dict(info.get("info") or {}),
                     "ageS": now - info["last_seen"],
                     "alive": now - info["last_seen"] <= self.max_age}
                    for nid, info in sorted(self._nodes.items())]

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
        self.tracer = tracing.Tracer(detail=False)
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
        # the fault-tolerant tier: the winning attempt number a task id,
        # the failed attempts' ids, the speculative attempts still in
        # flight (pruned as their slots resolve) and every one launched
        self.task_attempts: Dict[str, int] = {}
        self.retried_tasks: List[str] = []
        self.speculative_tasks: List[str] = []
        self.speculation_history: deque = deque(maxlen=64)
        # the spooled result protocol: the manifest (``{id, rows, bytes,
        # codec, uri, ackUri}`` a segment) when the result left as segments,
        # which producer wrote them ("worker-direct" or "coordinator"), the
        # worker owning each segment id (ack forwarding), the coordinator's
        # store and public URL (set at submit; None: this execution never
        # spools), and when a client last fetched or acked a segment here
        # (the phase ledger's segment-fetch, outside the wall)
        self.result_segments: Optional[List[dict]] = None
        self.spooled: Optional[str] = None
        self._segment_workers: Dict[str, str] = {}
        self.segment_store = None
        self.segment_base_url: Optional[str] = None
        self.last_segment_fetch_at: Optional[float] = None
        # the latest status record of each task slot ("<query>.<fragment>.
        # <index>"): {"fragment", "taskId", "state", "stats"}; the
        # stage and query rollups and the adaptive rules read it
        self.task_stats: Dict[str, dict] = {}
        self._tstats_lock = threading.Lock()
        # task-status GETs this query made (poller, sweeps, build waits)
        self.status_polls = 0
        # versioned plan changes of the adaptive re-planner (dicts)
        self.plan_versions: List[dict] = []
        # EXPLAIN ANALYZE's annotation sources: the coordinator's own
        # executors are kept
        self._root_executor = None
        self._local_executor = None
        self.fast_path_reason: Optional[str] = None
        self._kernels_folded = False
        self.phase_waits: List[tuple] = []
        self.created_at = time.time()
        self.ended_at: Optional[float] = None
        # the serving plane: the group the selectors chose (None under an
        # injected flat gate), the client's X-Trino-Source, the queries
        # queued ahead at enqueue, the queue-residency span the lane
        # closes at dequeue, which plane ran the query ("dispatch-lane"
        # inline, "executor-process:N" when forwarded) and the spans pulled
        # from an executor process's trace (merged into the phase ledger
        # and the trace endpoint)
        self.resource_group: Optional[str] = None
        self.source: str = ""
        self.queued_ahead: Optional[int] = None
        self._dispatch_queue_span = None
        self.plane: str = "dispatch-lane"
        self.extra_spans: List[dict] = []
        # serving-index learning: whether the statement was a plain SELECT,
        # and the result-cache key and data versions of a led flight
        self.is_plain_select = False
        self.result_cache_versions = None
        # the coordinator's flight recorder (set at submit) and the
        # postmortem a FAILED query keeps
        self.recorder = None
        self.postmortem: Optional[dict] = None
        # the phase ledger (obs/timeline.py QueryTimeline), computed once
        # from the merged span tree at the end; when the client last
        # fetched a result page (the ledger's client-drain, outside the
        # wall); the straggler verdicts frozen at the end; the server's
        # pool for parallel pulls of the workers' span dumps and rings
        self._timeline = None
        self.last_drain_at: Optional[float] = None
        self._stragglers: Optional[List[dict]] = None
        self._flows_folded = False
        # set by the server at submit: the shared pool of parallel pulls
        # from the workers, and the dispatcher (its executor-process plane
        # takes the registry replications)
        self.io_pool = None
        self.dispatcher = None

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
            # the trace closes, the clock stops and the phase ledger is
            # computed (it pulls the workers' span dumps) before the
            # terminal transition, whose listeners read the cached ledger
            self.tracer.end_span(root_span)
            self.ended_at = time.time()
            self._warm_timeline()
            self.fold_kernel_profile()
            # the spool goes before FINISHED is visible: a client that
            # reads the result finds no file of this query left
            self._cleanup_spool()
            self.state.set("FINISHED")
        except Exception as e:  # noqa: BLE001 — reported through query info
            self.ended_at = self.ended_at or time.time()
            if self.failure is None:
                self.failure = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            root_span.set("error", str(e).split("\n")[0][:300])
            self._cancel_tasks()
            self.tracer.end_span(root_span)
            self._warm_timeline()
            self.fold_kernel_profile()
            # the postmortem before FAILED is visible: the workers' rings
            # still hold the context around the failure
            try:
                self.capture_postmortem(timeout=self.COMPLETION_PULL_TIMEOUT)
            except Exception:  # noqa: BLE001 — best-effort forensics
                pass
            self._cleanup_spool()
            self.state.set("FAILED")
        finally:
            # a kill or cancel from another thread may have won the latch:
            # the root span records the state that stuck
            root_span.set("state", self.state.get())
            self._cleanup_spool()  # a cancel's or kill's end too

    def _run_lifecycle(self) -> None:
        from trino_tpu_torch.exec.query import run_query
        from trino_tpu_torch.server.security import Identity
        from trino_tpu_torch.sql.parser.parser import parse_statement

        self.state.set("PLANNING")
        session = self.session_factory(self.session_properties)
        session.identity = Identity(self.user)
        # procedures resolve the calling query through the session:
        # system.runtime.kill_query refuses to kill its own query
        session.query_id = self.query_id
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
            # the deliverable is the annotated plan, not the inner query's
            # rows: release any segments its execution spooled
            self._discard_spooled_result()
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
            # the refresh consumes rows: a spooled manifest would leave them
            # in segments nothing here decodes
            session.properties["spooled_results_enabled"] = False
            self._execute_query(session, root)
            rows, self.rows = self.rows, []
            return rows

        # under the executor-process plane substituted SELECTs run in the
        # children: warming this process's device cache on refresh would
        # stage a table no query here scans
        warm = getattr(self.dispatcher, "process_plane", None) is None
        columns, rows = mv_lifecycle.dispatch_mv_statement(
            session, stmt, sql=sql, execute_fn=execute_fn, warm=warm)
        if self.state.get() in ("QUEUED", "PLANNING", "STARTING"):
            self.state.set("RUNNING")
        self.columns, self.rows = columns, rows
        self._replicate_mv_change(session, stmt)

    def _replicate_mv_change(self, session, stmt) -> None:
        """Process plane only: ship the registry change to every booted
        executor process (``CALL system.runtime.sync_materialized_view``
        with a base64 payload and its signature), so sticky-routed SELECTs
        substitute, or stop substituting, there too. Best-effort, like the
        prepared-registry broadcast."""
        pp = getattr(self.dispatcher, "process_plane", None)
        if pp is None:
            return
        import base64
        import json as _json

        from trino_tpu_torch.matview import registry as mv_registry
        from trino_tpu_torch.matview.lifecycle import resolve_mv_name

        catalog, schema, name = resolve_mv_name(session, stmt.name)
        if isinstance(stmt, ast.DropMaterializedView):
            payload = mv_registry.drop_payload(catalog, schema, name)
        else:
            mv = session.matviews.get(catalog, schema, name)
            if mv is None or mv.definition_sql is None:
                return
            payload = mv_registry.to_payload(mv)
        blob = base64.b64encode(_json.dumps(payload).encode()).decode()
        # signed with the cluster-internal secret (the children inherit it
        # through their environment): the procedure refuses anything an
        # ordinary client could forge
        sig = wire.sign(blob.encode())
        pp.broadcast(
            f"CALL system.runtime.sync_materialized_view('{blob}', '{sig}')",
            self.user, self.session_properties)

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
        if self.result_segments is not None:
            # a spooled result is a manifest, its rows never materialized
            # here: no entry, and single-flight waiters execute themselves
            self.query_cache.results.abandon(key)
            return
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
            self._replicate_registry_change()
            return
        if isinstance(stmt, ast.Deallocate):
            self.cache_status = "BYPASS"
            self.state.set("RUNNING")
            if not reg.remove(self.user, stmt.name):
                raise ValueError(f"prepared statement not found: {stmt.name}")
            self.deallocated_prepared.append(stmt.name)
            self.columns, self.rows = ["result"], [("DEALLOCATE",)]
            self._replicate_registry_change()
            return
        self._run_execute_prepared(session, stmt)

    def _replicate_registry_change(self) -> None:
        """Process plane only: replay this PREPARE/DEALLOCATE on every
        executor process, so their replica registries track this process's
        authoritative one."""
        pp = getattr(self.dispatcher, "process_plane", None)
        if pp is not None:
            pp.broadcast(self.sql, self.user, self.session_properties)

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
            # process-local catalogs (memory, system) cannot ship to the
            # workers; RUNNING is set, so a query reading
            # system.runtime.queries sees itself as it runs
            self._run_local(session, root, "local-catalog", "execute/coordinator-local")
            return
        from trino_tpu_torch.server import fastpath

        take, reason = fastpath.fast_path_decision(session, root)
        if take:
            self.fast_path_reason = reason
            self._run_local(session, root, "fast-path", "fastpath/execute", reason=reason)
            return
        self.fast_path = "distributed"
        M.FAST_PATH_QUERIES.inc(1, "distributed")
        with self.tracer.span("fragment") as sp:
            fragments = self.fragments = fragment_plan(root, session)
            sp.set("fragments", len(fragments))
        # the worker-direct spool decision, before scheduling: the export
        # shape's producers then write the result segments themselves
        spool_fid = self._mark_worker_direct_spool(session, root, fragments)
        with self.tracer.span("schedule") as sp:
            self.state.set("STARTING")
            workers = self.registry.alive()
            if not workers:
                raise RuntimeError("no alive workers")
            sp.set("workers", len(workers))
            self._schedule(session, fragments, workers)
            self.state.set("RUNNING")
            self._start_stats_poller()
        result_page = None
        if spool_fid is not None:
            # metadata only: the manifest from the producers' status, no
            # page crosses this process
            with self.tracer.span("segments/collect") as sp:
                self._collect_result_segments(spool_fid)
                sp.set("segments", len(self.result_segments or ()))
        else:
            with self.tracer.span("execute/root-fragment"):
                result_page = self._run_root_fragment(session, fragments)
        # freeze the rollup on the tasks' final numbers before the query
        # leaves RUNNING (every task is FLUSHING or later once the root
        # fragment drained its buffers)
        with self.tracer.span("stats/sweep") as sp:
            sp.set("polled", self._sweep_task_stats())
        self.state.set("FINISHING")
        self.columns = fragments[-1].root.column_names
        if result_page is not None:
            self._materialize_result(session, result_page)

    def _run_local(self, session, root, path: str, span_name: str,
                   reason: Optional[str] = None) -> None:
        """The whole plan on the coordinator's own executor (a process-local
        catalog, or the short-query fast path), under ``span_name``."""
        from trino_tpu_torch.exec.executor import Executor

        self.fast_path = path
        M.FAST_PATH_QUERIES.inc(1, path)
        self.state.set("RUNNING")
        t0 = time.perf_counter()
        with self.tracer.span(span_name) as sp:
            if reason is not None:
                sp.set("reason", reason)
            ex = Executor(session)
            page = ex.execute_checked(root)
            ex.errors.clear()  # checked: the kept executor holds no flag on the card
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
            "outputRows": self.result_rows(),
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
        """The result tail of every SELECT path: the page as Python rows,
        or, when the spooled result protocol is on and its bytes reach the
        threshold (or the inline cap), segments in this coordinator's store
        and a manifest. Over ``inline_result_max_bytes`` without the
        protocol the query fails rather than hold the rows in this
        process."""
        live = page.num_rows if page.sel is None else int(page.sel.sum())
        est = live * int(page.row_byte_estimate())
        cfg = self._spool_config(session)
        cap = int(session.properties.get("inline_result_max_bytes", 256 << 20))
        if cfg is not None and est >= min(cfg["threshold"], cap):
            self._spool_result_page(session, page, cfg)
            return
        if est > cap:
            M.INLINE_RESULT_REJECTIONS.inc()
            raise RuntimeError(
                f"result is ~{est} serialized bytes, over inline_result_max_bytes={cap}: "
                "the coordinator refuses to materialize it in process memory "
                "(INLINE_RESULT_TOO_LARGE) — enable spooled_results_enabled to serve it "
                "as a spooled segment manifest, or narrow the query")
        with self.tracer.span("result/serialize") as sp:
            self.rows = page.to_pylist()
            sp.set("rows", len(self.rows))

    # ---------------------------------------------------- spooled results
    def result_rows(self) -> int:
        """The result's row count under either protocol: the rows inline,
        the manifest's rows summed when spooled."""
        if self.result_segments is not None:
            return sum(int(e.get("rows", 0)) for e in self.result_segments)
        return len(self.rows)

    def _spool_config(self, session) -> Optional[dict]:
        """The spooled result protocol's knobs, or None when it is off for
        this query (not enabled, or no segment store: an execution the
        server did not submit)."""
        props = session.properties
        if self.segment_store is None or not _truthy(props.get("spooled_results_enabled", False)):
            return None
        return {"threshold": int(props.get("spooled_results_threshold_bytes", 8 << 20)),
                "segment_bytes": int(props.get("spooled_results_segment_bytes", 8 << 20)),
                "ttl_s": int(props.get("result_segment_ttl_ms", 300_000)) / 1e3}

    def _spool_result_page(self, session, page, cfg) -> None:
        """The coordinator's spool: the page compacted on the card and
        copied to the host once (``host_page``: the live rows, not the
        columns' capacity), cut into chunks and serialized into segments of
        this coordinator's store, in row order."""
        from trino_tpu_torch.data.serde import host_page
        from trino_tpu_torch.server.task import _chunk_pages

        page = host_page(page)
        chunk_target = int(session.properties.get("task_output_chunk_bytes", 4 << 20))
        chunk_rows = max(1, chunk_target // page.row_byte_estimate()) if page.num_rows else 1
        writer = self.segment_store.writer(self.query_id, target_bytes=cfg["segment_bytes"],
                                           ttl_s=cfg["ttl_s"])
        with self.tracer.span("result/spool") as sp:
            for c in _chunk_pages(page, chunk_rows):
                writer.add(serialize_page(c), c.num_rows)
            metas = writer.finish()
            sp.set("segments", len(metas))
            sp.set("rows", page.num_rows)
        base = self.segment_base_url or ""
        self.result_segments = [
            {**m.manifest_entry(), "uri": f"{base}/v1/segment/{m.segment_id}",
             "ackUri": f"{base}/v1/segment/{m.segment_id}"} for m in metas]
        self.spooled = "coordinator"
        self.rows = []
        M.SPOOLED_RESULT_QUERIES.inc(1, "coordinator")

    def _mark_worker_direct_spool(self, session, root, fragments) -> Optional[int]:
        """The worker-direct decision, before scheduling: when the root
        fragment is a pass-through gather (the export shape) and the
        estimated result reaches the threshold, the producing fragment's
        tasks write the segments and the root fragment never runs here.
        Returns that fragment's id, or None (the actual bytes then decide
        in ``_materialize_result``). Off under the fault-tolerant tier,
        whose losing attempts' segments would outlive the manifest."""
        cfg = self._spool_config(session)
        if cfg is None or self._fte():
            return None
        src = self._gather_passthrough(fragments[-1])
        if src is None:
            return None
        frag = next((f for f in fragments if f.id == src.fragment_id), None)
        if frag is None or frag.output_partition_channels:
            return None
        from trino_tpu_torch.server import fastpath

        est_rows = fastpath.scan_rows_estimate(session, root)
        if est_rows * 8 * max(1, len(fragments[-1].root.column_names or ())) < cfg["threshold"]:
            return None
        frag.spool_results = True
        return frag.id

    @staticmethod
    def _gather_passthrough(root_frag):
        """The gather source of a root fragment that only passes it through
        (an OutputNode over one gather RemoteSourceNode: gathered bytes are
        the result's), else None."""
        out = root_frag.root
        src = out.source if isinstance(out, P.OutputNode) else out
        if isinstance(src, RemoteSourceNode) and src.exchange_type == "gather":
            return src
        return None

    SEGMENT_COLLECT_TIMEOUT = 600.0

    def _collect_result_segments(self, fid: int) -> None:
        """Wait for the result-producing tasks to FINISH (their segments are
        durable then) and build the manifest from their status, in task
        order. Clients fetch from the owning workers; their acks go through
        this coordinator, which forwards them."""
        deadline = time.monotonic() + self.SEGMENT_COLLECT_TIMEOUT
        entries: List[dict] = []
        base = self.segment_base_url or ""
        for loc in self.fragment_tasks.get(fid, ()):
            while True:
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"result task {loc.task_id} did not finish within "
                                       f"{self.SEGMENT_COLLECT_TIMEOUT:g}s")
                if self.state.is_terminal():
                    raise RuntimeError("query was canceled")
                info = self._poll_task(loc)
                state = (info or {}).get("state")
                if state == "FINISHED":
                    break
                if state in ("FAILED", "CANCELED"):
                    raise RuntimeError(f"result task {loc.task_id} {state}: "
                                       f"{info.get('failure')}")
                time.sleep(0.05)
            for seg in info.get("resultSegments", ()):
                self._segment_workers[seg["id"]] = loc.base_url
                entries.append({**seg, "uri": f"{loc.base_url}/v1/segment/{seg['id']}",
                                "ackUri": f"{base}/v1/segment/{seg['id']}"})
        self.result_segments = entries
        self.spooled = "worker-direct"
        self.rows = []
        M.SPOOLED_RESULT_QUERIES.inc(1, "worker-direct")

    def _discard_spooled_result(self) -> None:
        """A statement whose answer is not the inner query's rows (EXPLAIN
        ANALYZE) ran a query that spooled: its segments go now, as no
        manifest will reach a client."""
        if self.result_segments is None:
            return
        for e in self.result_segments:
            worker = self._segment_workers.get(e["id"])
            if worker is not None:
                try:
                    wire.http_request("DELETE", f"{worker}/v1/segment/{e['id']}", timeout=5.0)
                except Exception:  # noqa: BLE001 — the TTL is the backstop
                    pass
            elif self.segment_store is not None:
                self.segment_store.discard(e["id"])
        self.result_segments = None
        self.spooled = None

    def _cleanup_spool(self) -> None:
        """Delete this query's spooled task outputs, the ``.tmp`` files of
        a write in progress included (the exchange's sink files go with
        their query)."""
        import glob

        spool_dir = spool_directory()
        if not spool_dir:
            return
        for path in glob.glob(os.path.join(glob.escape(spool_dir),
                                           f"{glob.escape(self.query_id)}.*.pages*")):
            try:
                os.remove(path)
            except OSError:
                pass

    # ----------------------------------------------------------- scheduling
    def _fte(self) -> bool:
        """Whether the query runs under the fault-tolerant tier."""
        return str(self.session_properties.get("retry_policy", "NONE")).upper() == "TASK"

    def _schedule(self, session, fragments, workers) -> None:
        """Create every fragment's tasks. A fragment consumed by a source
        or hash fragment has one consumer a worker (broadcast buffers, or
        one partition a hash task); the root fragment is one consumer. A
        fragment whose join build is fed by a leaf fragment waits until the
        build's tasks finished executing (phased execution). Under the
        fault-tolerant tier every stage finishes before the next one is
        scheduled, so there is no build to wait for."""
        fte = self._fte()
        if fte and spool_directory() is None:
            # retries need durable outputs (the reference's TASK retry needs
            # a configured exchange manager)
            raise RuntimeError(
                "retry_policy=TASK requires the spooled exchange: set "
                "TRINO_TPU_SPOOL_DIR to a cluster-shared directory")
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
            if phased and not fte and frag.id in build_deps:
                self._await_build_fragments(build_deps[frag.id])
                self.phase_waits.append((frag.id, build_deps[frag.id]))
            if adaptive is not None and frag.partitioning != "single":
                for nf in self._adapt_fragment(adaptive, frag, by_id, fragments,
                                               consumer_counts, workers):
                    self._schedule_fragment(session, nf, workers, consumer_counts, fte)
            self._schedule_fragment(session, frag, workers, consumer_counts, fte)

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
                    self._cancel_attempt(loc)
        for nf in new_frags:
            consumer_counts[nf.id] = len(workers)
            fragments.insert(fragments.index(frag), nf)
        return new_frags

    def _cancel_attempt(self, loc: Optional[TaskLocation]) -> None:
        """Best-effort cancel of one task attempt (a superseded producer, a
        failed or losing attempt), and its slot marked CANCELED where the
        slot's record is this attempt's and not final (its last numbers
        kept): the worker drops a canceled task, so a later status read of
        it could only fail."""
        if loc is None:
            return
        try:
            wire.http_request("DELETE", f"{loc.base_url}/v1/task/{loc.task_id}", timeout=5.0)
        except Exception:  # noqa: BLE001
            pass
        with self._tstats_lock:
            have = self.task_stats.get(loc.task_id.rsplit(".a", 1)[0])
            if have is not None and have["taskId"] == loc.task_id and \
                    have["state"] not in ("FINISHED", "FAILED"):
                have["state"] = "CANCELED"

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

    def _schedule_fragment(self, session, frag, workers, consumer_counts, fte=False) -> None:
        """Create the tasks of one source or hash fragment (the root single
        fragment runs on the coordinator); under the fault-tolerant tier,
        run them to the stage barrier (``_run_fragment_fte``)."""
        if frag.partitioning == "hash":
            # one task a key partition: task i pulls partition i of every
            # producer (under the fault-tolerant tier, their spool files)
            if fte:
                self.fragment_tasks[frag.id] = self._run_fragment_fte(
                    frag, [dict() for _ in workers], workers, consumer_counts)
            else:
                self.fragment_tasks[frag.id] = [
                    self._create_task(frag, wi, 0, {}, workers[wi], consumer_counts)
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
        if fte:
            self.fragment_tasks[frag.id] = self._run_fragment_fte(
                frag, per_worker_splits, workers, consumer_counts)
            return
        self.fragment_tasks[frag.id] = [
            self._create_task(frag, wi, 0, per_worker_splits[wi], workers[wi], consumer_counts)
            for wi in range(len(workers))]

    def _create_task(self, frag, wi: int, attempt: int, splits, worker,
                     consumer_counts) -> TaskLocation:
        """Create attempt ``attempt`` of slot ``wi`` of ``frag`` on
        ``worker``: task id ``<query>.<fragment>.<slot>.a<attempt>``."""
        task_id = f"{self.query_id}.{frag.id}.{wi}.a{attempt}"
        req = TaskRequest(
            task_id=task_id, query_id=self.query_id, fragment_root=frag.root,
            splits=splits, upstream=self._upstream_for(frag.root, consumer_index=wi),
            session_properties=self.session_properties,
            consumer_count=consumer_counts.get(frag.id, 1),
            output_partition_channels=frag.output_partition_channels,
            skew_spread_partitions=frag.skew_spread_partitions,
            skew_replicate_partitions=frag.skew_replicate_partitions,
            spool_results=getattr(frag, "spool_results", False))
        # trace-context propagation: the worker parents its task span under
        # the coordinator's current (schedule) span
        status, resp, _ = wire.http_request(
            "POST", f"{worker['url']}/v1/task/{task_id}", req.to_bytes(),
            headers={tracing.TRACEPARENT_HEADER: self.tracer.traceparent()})
        if status >= 400:
            raise RuntimeError(f"task create failed on {worker['nodeId']}: "
                               f"{resp[:300].decode(errors='replace')}")
        # the create response is a status payload: it seeds the slot, so
        # totalSplits is known while the task runs
        self._note_task_status(task_id, json.loads(resp))
        return TaskLocation(worker["url"], task_id)

    # ------------------------------------------------ fault-tolerant tier
    MAX_TASK_ATTEMPTS = 3
    TASK_ATTEMPT_TIMEOUT = 600.0
    # speculation: a slot's first attempt gets a twin once it has run
    # SPECULATION_FACTOR x its finished siblings' median, and at least
    # SPECULATION_MIN_S
    SPECULATION_MIN_S = 2.0
    SPECULATION_FACTOR = 2.0
    FTE_POLL_INTERVAL = 0.05

    def _run_fragment_fte(self, frag, per_worker_splits, workers,
                          consumer_counts) -> List[TaskLocation]:
        """One stage under the fault-tolerant tier (reference:
        EventDrivenFaultTolerantQueryScheduler.java:201): its tasks run at
        once, and it returns when every slot has a FINISHED attempt (its
        output spooled), the winners' locations in slot order. A failed,
        unreachable or timed-out attempt is canceled and retried on the
        next worker (``MAX_TASK_ATTEMPTS`` a slot); upstreams never rerun,
        their outputs being durable. A straggling first attempt gets a
        speculative twin; the first to finish wins and the other is
        canceled. Each poll is one status GET of each live attempt, every
        ``FTE_POLL_INTERVAL`` seconds."""
        n = len(workers)
        locations: List[Optional[TaskLocation]] = [None] * n
        # a slot's live attempts: (attempt, location or None, deadline,
        # started); two while speculating
        slots: Dict[int, list] = {wi: [self._start_attempt(frag, wi, 0, per_worker_splits,
                                                           workers, consumer_counts)]
                                  for wi in range(n)}
        top_attempt = {wi: 0 for wi in range(n)}
        finished_durations: List[float] = []

        def fail_all(msg):
            for atts in slots.values():
                for _a, other, _dl, _t in atts:
                    self._cancel_attempt(other)
                    self._prune_speculative(other)
            raise RuntimeError(msg)

        while slots:
            if self.state.is_terminal():
                fail_all("query was canceled")
            for wi in list(slots):
                for att in list(slots[wi]):
                    attempt, loc, deadline, started = att
                    state, failure = self._attempt_outcome(loc, deadline)
                    if state is None:
                        continue  # still running
                    if state == "FINISHED":
                        locations[wi] = loc
                        self.task_attempts[loc.task_id] = attempt
                        finished_durations.append(time.monotonic() - started)
                        for _a, other, _dl, _t in slots[wi]:
                            if other is not loc:
                                self._cancel_attempt(other)  # the loser
                            self._prune_speculative(other)
                        del slots[wi]
                        break
                    # failed, unreachable, timed out or canceled remotely
                    self._cancel_attempt(loc)
                    self._prune_speculative(loc)
                    if loc is not None:
                        self.retried_tasks.append(loc.task_id)
                    slots[wi].remove(att)
                    if not slots[wi]:
                        if top_attempt[wi] + 1 >= self.MAX_TASK_ATTEMPTS:
                            fail_all(f"task {frag.id}.{wi} failed after "
                                     f"{self.MAX_TASK_ATTEMPTS} attempts: {failure}")
                        top_attempt[wi] += 1
                        slots[wi] = [self._start_attempt(frag, wi, top_attempt[wi],
                                                         per_worker_splits, workers,
                                                         consumer_counts)]
            if finished_durations and slots:
                med = sorted(finished_durations)[len(finished_durations) // 2]
                threshold = max(self.SPECULATION_MIN_S, self.SPECULATION_FACTOR * med)
                now = time.monotonic()
                for wi, atts in slots.items():
                    if len(atts) != 1:
                        continue  # already speculating
                    attempt, loc, _dl, started = atts[0]
                    # a retried slot keeps its attempt budget
                    if attempt != 0 or loc is None or now - started < threshold:
                        continue
                    if top_attempt[wi] + 1 >= self.MAX_TASK_ATTEMPTS:
                        continue
                    top_attempt[wi] += 1
                    spec = self._start_attempt(frag, wi, top_attempt[wi], per_worker_splits,
                                               workers, consumer_counts)
                    atts.append(spec)
                    if spec[1] is not None:
                        self.speculative_tasks.append(spec[1].task_id)
                        self.speculation_history.append(spec[1].task_id)
            if slots:
                time.sleep(self.FTE_POLL_INTERVAL)
        return list(locations)

    def _start_attempt(self, frag, wi, attempt, per_worker_splits, workers, consumer_counts):
        """Create one attempt on worker ``(wi + attempt) % n``: (attempt,
        location, deadline, started). A creation that fails (a worker dead
        at the POST) is retried like a task failure: location None."""
        worker = workers[(wi + attempt) % len(workers)]
        deadline = time.monotonic() + self.TASK_ATTEMPT_TIMEOUT
        try:
            loc = self._create_task(frag, wi, attempt, per_worker_splits[wi], worker,
                                    consumer_counts)
        except Exception:  # noqa: BLE001 — retried like a task failure
            loc = None
        return (attempt, loc, deadline, time.monotonic())

    def _attempt_outcome(self, loc: Optional[TaskLocation], deadline: float):
        """One status read of an attempt against its deadline: (None, None)
        while it runs, else (terminal state, failure)."""
        if loc is None:
            return "FAILED", "task creation failed (worker unreachable)"
        if time.monotonic() > deadline:
            return "FAILED", "task attempt timeout"
        info = self._poll_task(loc)
        if info is None:
            return "FAILED", "status poll failed (worker unreachable)"
        if info.get("state") in ("FINISHED", "FAILED", "CANCELED"):
            return info["state"], info.get("failure")
        return None, None

    def _prune_speculative(self, loc: Optional[TaskLocation]) -> None:
        """Drop a resolved attempt from the in-flight speculation list
        (``speculation_history`` keeps it)."""
        if loc is not None and loc.task_id in self.speculative_tasks:
            self.speculative_tasks.remove(loc.task_id)

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

    # ------------------------------------------------------- phase ledger
    def worker_spans(self, timeout: float = 3.0) -> List[dict]:
        """Every scheduled task's span dump, fetched in parallel on the
        server's pool with a short timeout: a worker that is gone loses its
        spans, never the whole read."""
        locations = [loc for locs in list(self.fragment_tasks.values()) for loc in list(locs)]
        if not locations:
            return []

        def fetch(loc):
            try:
                status, body, _ = wire.http_request(
                    "GET", f"{loc.base_url}/v1/task/{loc.task_id}/spans", timeout=timeout)
                if status < 400:
                    return json.loads(body).get("spans", ())
            except Exception:  # noqa: BLE001 — a worker gone reads as no spans
                pass
            return ()

        spans: List[dict] = []
        if self.io_pool is not None:
            try:
                for dump in self.io_pool.map(fetch, locations):
                    spans.extend(dump)
                return spans
            except RuntimeError:  # the pool shut down with the server
                pass
        for loc in locations:
            spans.extend(fetch(loc))
        return spans

    # the pulls made before the terminal state is published (the ledger,
    # the postmortem) wait at most this long for a worker
    COMPLETION_PULL_TIMEOUT = 1.5

    def _warm_timeline(self) -> None:
        """Compute and cache the ledger (needs ``ended_at``): on the query
        thread just before the terminal transition, so its listeners and
        every later read get the cached result. Never fails the query."""
        if self._timeline is not None or self.ended_at is None:
            return
        try:
            from trino_tpu_torch.obs.timeline import compute_timeline

            spans = (self.tracer.to_dicts() + list(self.extra_spans)
                     + self.worker_spans(timeout=self.COMPLETION_PULL_TIMEOUT))
            self._timeline = compute_timeline(spans, self.created_at, self.ended_at)
        except Exception:  # noqa: BLE001 — observability only
            pass

    def timeline_dict(self) -> Optional[dict]:
        """The phase ledger: None while the query runs; computed once at
        its end (a kill from another thread computes it on the first read).
        ``client-drain`` is refreshed on every read: pages keep draining
        after the wall ends."""
        if not self.state.is_terminal() or self.ended_at is None:
            return None
        if self._timeline is None:
            self._warm_timeline()
        tl = self._timeline
        if tl is None:
            return None
        if self.last_drain_at is not None:
            tl.client_drain_s = max(0.0, self.last_drain_at - self.ended_at)
        if self.last_segment_fetch_at is not None:
            # the segment fetches and acks seen here, outside the wall
            tl.segment_fetch_s = max(0.0, self.last_segment_fetch_at - self.ended_at)
        return tl.to_dict()

    def _timeline_now(self) -> dict:
        """A ledger over the spans recorded so far (EXPLAIN ANALYZE renders
        its header before the query's wall closes)."""
        from trino_tpu_torch.obs.timeline import compute_timeline

        spans = self.tracer.to_dicts() + list(self.extra_spans) + self.worker_spans()
        return compute_timeline(spans, self.created_at, time.time()).to_dict()

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
        qs["resultRows"] = self.result_rows()
        # the spooled result protocol: which producer wrote the segments
        # (None: inline rows) and the manifest's footprint
        qs["spooled"] = self.spooled
        if self.result_segments is not None:
            qs["resultSegments"] = len(self.result_segments)
            qs["resultSegmentBytes"] = sum(int(e.get("bytes", 0)) for e in self.result_segments)
        # adaptive plan changes applied so far
        qs["adaptations"] = len(self.plan_versions)
        # the materialized views substituted into this query's plan
        qs["mvHits"] = len(self.mv_substitutions)
        if self.mv_substitutions:
            qs["mvNames"] = list(self.mv_substitutions)
        # the phase ledger: per-phase exclusive wall, None until terminal
        qs["timeline"] = self.timeline_dict()
        qs["memory"] = {"peakBytes": int(qs.get("peakBytes") or 0),
                        "shedBytes": int(qs.get("shedBytes") or 0),
                        "yieldEvents": int(qs.get("yieldEvents") or 0),
                        "spills": int(qs.get("spills") or 0)}
        # the data-plane block: drain throughput and the straggler count
        # (left out on a ledger hiccup rather than failing a stats poll)
        try:
            qs["flows"] = self.flow_stats_block()
        except Exception:  # noqa: BLE001 — observability only
            pass
        return qs

    def flow_stats_block(self) -> dict:
        """The protocol's ``stats.flows`` block: this query's client-drain
        bytes and effective MB/s, and its straggler count."""
        from trino_tpu_torch.obs.flowledger import FLOW_LEDGER

        owner = f"drain:{self.query_id}"
        drain_bytes = 0
        drain_s = 0.0
        for r in FLOW_LEDGER.transfer_rows():
            if r["owner"] == owner:
                drain_bytes += r["bytes"]
                drain_s += r["seconds"]
        return {
            "drainBytes": drain_bytes,
            "drainMbPerS": round(drain_bytes / drain_s / 1e6, 3) if drain_s > 0 else None,
            "stragglers": len(self.straggler_rows()),
        }

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
                # the newest compile events and the utilization counters,
                # and what was moving (and who waited on whom)
                "profiler": _profiler_snapshot(),
                "flows": _flows_snapshot(),
            },
            "workers": pull_worker_rings(locations, timeout=timeout, pool=self.io_pool),
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

    def profile_dict(self) -> dict:
        """``GET /v1/query/{id}/profile``: the merged kernel rows, this
        query's compile events, recent utilization samples, the profiler's
        counters and the phase ledger."""
        from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER

        kernels = (DEVICE_PROFILER.kernel_rows(self.query_id) if self._kernels_folded
                   else self.kernel_rows_live())
        return {
            "queryId": self.query_id,
            "state": self.state.get(),
            "kernels": kernels,
            "compiles": DEVICE_PROFILER.compile_rows(query_id=self.query_id),
            "utilization": DEVICE_PROFILER.utilization_rows(limit=8),
            "counters": DEVICE_PROFILER.counters(),
            "timeline": self.timeline_dict(),
        }

    # ------------------------------------------------------- flow ledger
    def _owns_flow(self, owner: str) -> bool:
        """Whether a flow-ledger owner is this query's:
        ``task:<query>.<fragment>.<slot>.a<n>``, ``task:<query>.root``,
        ``query:<query>`` or ``drain:<query>``."""
        return (owner == f"query:{self.query_id}" or owner == f"drain:{self.query_id}"
                or owner.startswith(f"task:{self.query_id}."))

    def _straggler_multiple(self) -> float:
        """The ``straggler_multiple`` session property (a malformed value
        falls back to the ledger's default)."""
        from trino_tpu_torch.obs.flowledger import DEFAULT_STRAGGLER_MULTIPLE

        try:
            return float(self.session_properties.get("straggler_multiple",
                                                     DEFAULT_STRAGGLER_MULTIPLE))
        except (TypeError, ValueError):
            return DEFAULT_STRAGGLER_MULTIPLE

    def flow_rows_live(self) -> List[dict]:
        """This query's per-link transfer rollups across the cluster: the
        workers' from their announces (``flows``), the coordinator's from
        its own ledger, each process once (a worker sharing this process
        shares its ledger: server/system_tables.cluster_rows)."""
        from trino_tpu_torch.obs.flowledger import FLOW_LEDGER
        from trino_tpu_torch.server.system_tables import cluster_rows

        return [dict(r, nodeId=nid) for nid, r in cluster_rows(
                    self.registry, "flows", FLOW_LEDGER.transfer_rows,
                    FLOW_LEDGER.node_id or "coordinator")
                if self._owns_flow(str(r.get("owner", "")))]

    def straggler_rows(self) -> List[dict]:
        """Straggler verdicts over this query's task records: frozen at
        the end by ``fold_flow_profile``, detected live before."""
        if self._stragglers is not None:
            return self._stragglers
        from trino_tpu_torch.obs.flowledger import detect_stragglers

        return detect_stragglers(self.task_records(), multiple=self._straggler_multiple())

    def fold_flow_profile(self) -> None:
        """Freeze the straggler verdicts once, at the end, and count them
        by cause."""
        if self._flows_folded:
            return
        self._flows_folded = True
        self._stragglers = self.straggler_rows()
        for f in self._stragglers:
            M.STRAGGLER_TASKS.inc(1, f["cause"])

    def flows_dict(self) -> dict:
        """``GET /v1/query/{id}/flows``: this query's transfer rows across
        the cluster, its straggler verdicts, and the process's stall
        rollups and net totals."""
        from trino_tpu_torch.obs.flowledger import FLOW_LEDGER

        return {
            "queryId": self.query_id,
            "state": self.state.get(),
            "transfers": self.flow_rows_live(),
            "stragglers": self.straggler_rows(),
            "stalls": FLOW_LEDGER.stall_rows(),
            "net": FLOW_LEDGER.net_totals(),
        }

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
        # the phase ledger over the spans recorded so far (this statement
        # is still running while its header renders)
        from trino_tpu_torch.obs.timeline import summarize

        ledger = summarize(self._timeline_now())
        if ledger:
            header.append(f"Phase ledger: {ledger}")
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
        if qs.get("shedBytes"):
            header.append(f"Memory pressure: {qs['shedBytes'] // 1024}KiB shed from revocable "
                          f"caches across {qs.get('yieldEvents', 0)} yield event(s)")
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
        # the flow ledger: bytes and effective rate a link for this query,
        # then each straggler with its dominant cause
        try:
            by_link: Dict[str, list] = {}
            for r in self.flow_rows_live():
                agg = by_link.setdefault(r["link"], [0, 0.0])
                agg[0] += int(r["bytes"])
                agg[1] += float(r["seconds"])
            if by_link:
                header.append("Data flow: " + ", ".join(
                    f"{link} {b / 1e6:.1f}MB" + (f" @ {b / s / 1e6:.1f}MB/s" if s > 0 else "")
                    for link, (b, s) in sorted(by_link.items())))
            for f in self.straggler_rows():
                header.append(
                    f"Straggler: task {f['taskId']} {f['elapsedS']:.2f}s"
                    f" vs stage median {f['stageMedianS']:.2f}s"
                    f" ({f['ratio']:.1f}x, {f['cause']})")
        except Exception:  # noqa: BLE001 — annotations are observability
            pass
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

        from trino_tpu_torch.exec.memory import page_bytes

        root_frag = fragments[-1]
        assert root_frag.partitioning == "single"
        # the inline-result guard during the gather of a pass-through root
        # (gathered bytes are the result's) without the spooled protocol:
        # over inline_result_max_bytes the query fails before this process
        # holds the whole result. A reducing root may gather far more than
        # it outputs, and with the protocol on the result spools from here
        budget = None
        if self._spool_config(session) is None and \
                self._gather_passthrough(root_frag) is not None:
            budget = int(session.properties.get("inline_result_max_bytes", 256 << 20))
        remote_pages: Dict[int, list] = {}
        for node in P.walk_plan(root_frag.root):
            if isinstance(node, RemoteSourceNode):
                # the root gather is this query's exchange pull: its owner's
                # "task:<query>." prefix groups it with the workers' pulls
                client = ExchangeClient(self.fragment_tasks[node.fragment_id],
                                        device=session.device, tracer=self.tracer,
                                        owner=f"task:{self.query_id}.root",
                                        stall_key=(root_frag.id, None))
                client.start()
                if budget is None:
                    remote_pages[node.fragment_id] = client.pages()
                    continue
                pages, gathered = [], 0
                for p in client.iter_pages():
                    gathered += page_bytes(p)
                    if gathered > budget:
                        M.INLINE_RESULT_REJECTIONS.inc()
                        raise RuntimeError(
                            f"gathered result exceeds inline_result_max_bytes={budget} while "
                            "pulling the root fragment's input (INLINE_RESULT_TOO_LARGE) — "
                            "enable spooled_results_enabled to serve it as a spooled segment "
                            "manifest, or narrow the query")
                    pages.append(p)
                remote_pages[node.fragment_id] = pages
        ex = FragmentExecutor(session, {}, remote_pages)
        self._root_executor = ex  # EXPLAIN ANALYZE: the root stage's stats
        page = ex.execute_checked(root_frag.root)
        # the kept executor holds no gathered input and no checked error
        # flag: the query's history entry keeps nothing of it on the card
        remote_pages.clear()
        ex.errors.clear()
        return page

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
            # the fault-tolerant tier: failed attempts, the winners' attempt
            # numbers, the speculative attempts in flight and launched
            "retriedTasks": list(self.retried_tasks),
            "taskAttempts": dict(self.task_attempts),
            "speculativeTasks": list(self.speculative_tasks),
            "speculationHistory": list(self.speculation_history),
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
    (or ``TRINO_TPU_EXECUTOR_PLANE=process``) forwards plain SELECTs and
    EXECUTEs to ``executor_processes`` executor children (else
    ``TRINO_TPU_EXECUTOR_PROCESSES``, else 2) on this coordinator's device
    (server/dispatch.py ``ProcessExecutorPlane``); ``stop`` ends them."""

    MAX_QUERY_HISTORY = 100  # terminal queries kept in the registry (oldest evicted)

    def __init__(self, port: int = 0, session_factory=None, resource_group=None,
                 cluster_memory_limit_bytes=None, low_memory_killer=None,
                 authenticator=None, executor_lanes=None, dispatch_queue_capacity=None,
                 executor_plane=None, executor_processes=None,
                 resource_groups_config=None, device=None):
        from trino_tpu_torch.connector.registry import default_catalogs
        from trino_tpu_torch.obs import otlp
        from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER
        from trino_tpu_torch.obs.flightrecorder import FlightRecorder
        from trino_tpu_torch.obs.flowledger import FLOW_LEDGER
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
        # the system catalog: the completed-query history ring, and the
        # live provider that feeds system.runtime.* and system.metrics
        # from this server's state at scan time
        from trino_tpu_torch.server.system_tables import CoordinatorSystemTables, QueryHistory

        self.history = QueryHistory()
        self.catalogs["system"].attach_live_provider(CoordinatorSystemTables(self))
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
        # slow queries log with their slowest spans (threshold: the
        # slow_query_log_threshold_ms session property, else
        # TRINO_TPU_SLOW_QUERY_MS, else 30 s), and TRINO_TPU_QUERY_LOG
        # names a JSONL query log; a listener's failure never fails a query
        from trino_tpu_torch.obs.listeners import QueryLogListener, SlowQueryLogListener

        self.events.add(SlowQueryLogListener())
        query_log_path = os.environ.get("TRINO_TPU_QUERY_LOG")
        if query_log_path:
            self.events.add(QueryLogListener(query_log_path))
        self.queries_submitted = 0
        self.start_time = time.time()
        # this process's flight recorder; the process memory ledger and
        # device profiler take the first server's identity and mirror their
        # events into it
        self.recorder = FlightRecorder(node_id="coordinator")
        for ledger in (MEMORY_LEDGER, DEVICE_PROFILER, FLOW_LEDGER):
            if not ledger.node_id:
                ledger.node_id = "coordinator"
            ledger.attach_recorder(self.recorder)
        # OTLP export, on only when TRINO_TPU_OTLP_ENDPOINT is set: a
        # completed query's coordinator spans go to the collector from a
        # background exporter, never from the query path
        self.otlp = otlp.exporter_from_env("trino-tpu-coordinator")
        # the coordinator's own segment store: coordinator-local, fast-path
        # and non-pass-through distributed results spool here
        from trino_tpu_torch.server.segments import SegmentStore

        self.segments = SegmentStore(node_id="coordinator")
        # the pool of parallel pulls from the workers (span dumps, flight-
        # recorder rings), made on first use and shut down with the server
        self._io_pool = None
        self._io_pool_lock = threading.Lock()
        # the dispatch plane and its executor plane: lanes on this process,
        # or (executor_plane="process") executor children on this device
        self.dispatcher = Dispatcher(
            self, lanes=executor_lanes, queue_capacity=dispatch_queue_capacity,
            plane=executor_plane, processes=executor_processes,
            groups=self.resource_groups)
        self.httpd = wire.ServerHTTP(("127.0.0.1", port), _make_handler(self))
        self.port = self.httpd.server_address[1]
        self.base_url = f"http://127.0.0.1:{self.port}"
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def io_pool(self):
        """The server's pool of parallel pulls (made on first use)."""
        with self._io_pool_lock:
            if self._io_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._io_pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="coord-io")
            return self._io_pool

    def start(self) -> None:
        self._serve_thread.start()
        self.dispatcher.ensure_lanes()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.dispatcher.shutdown()
        self.segments.close()
        with self._io_pool_lock:
            pool, self._io_pool = self._io_pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        if self.otlp is not None:
            # flush and stop the exporter: a stopped server reports nothing
            self.otlp.shutdown()

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
        execution.io_pool = self.io_pool
        execution.dispatcher = self.dispatcher
        # the spooled result protocol's store and URL, and an opportunistic
        # TTL sweep on the submit cadence (rate-limited in the store)
        execution.segment_store = self.segments
        execution.segment_base_url = self.base_url
        self.segments.maybe_sweep()
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
        """The terminal listener: serving-index upkeep, the wall, peak and
        phase histograms, the frozen straggler verdicts, the postmortem of
        a FAILED query killed from another thread, the completed event, the
        OTLP export and the history record."""
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
        from trino_tpu_torch.obs.timeline import observe_phases
        from trino_tpu_torch.server.system_tables import (DEFAULT_MAX_HISTORY,
                                                          DEFAULT_MIN_EXPIRE_AGE_MS, query_record)

        timeline = None
        try:
            peak = int(execution.query_stats().get("peakBytes") or 0)
            if peak:
                M.QUERY_PEAK_MEMORY_BYTES.observe(peak, state)
            # the phase ledger, computed once, feeds the phase histogram
            timeline = execution.timeline_dict()
            if timeline is not None:
                observe_phases(timeline)
            execution.fold_kernel_profile()
            execution.fold_flow_profile()
        except Exception:  # noqa: BLE001 — observability never disturbs the transition
            pass
        if state != "FINISHED":
            # no client will fetch a FAILED or CANCELED query's segments:
            # the coordinator's go now (a failed producer abandoned its own)
            try:
                self.segments.drop_query(execution.query_id)
            except Exception:  # noqa: BLE001 — the lifecycle is best-effort
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
            timeline=timeline, postmortem=execution.postmortem))
        if self.otlp is not None:
            # the coordinator's half of the trace (each task exports its
            # own), with the query's bytes a link and its straggler count
            attrs = {"query_id": execution.query_id, "query.user": execution.user,
                     "query.state": state}
            try:
                by_link: Dict[str, int] = {}
                for r in execution.flow_rows_live():
                    by_link[r["link"]] = by_link.get(r["link"], 0) + int(r["bytes"])
                for link, nbytes in sorted(by_link.items()):
                    attrs[f"flow.{link}.bytes"] = nbytes
                attrs["flow.stragglers"] = len(execution.straggler_rows())
            except Exception:  # noqa: BLE001 — observability only
                pass
            self.otlp.export_spans(execution.tracer.to_dicts(), execution.tracer.trace_id, attrs)
        # the history ring is shared: a session's retention properties may
        # only grow it beyond the server's defaults, never shrink it
        try:
            props = execution.session_properties
            self.history.record(
                query_record(execution, state=state, ended_at=now),
                max_history=max(DEFAULT_MAX_HISTORY, _int_property(
                    props, "query_max_history", DEFAULT_MAX_HISTORY)),
                min_expire_age_ms=max(DEFAULT_MIN_EXPIRE_AGE_MS, _int_property(
                    props, "query_min_expire_age_ms", DEFAULT_MIN_EXPIRE_AGE_MS)))
        except Exception:  # noqa: BLE001 — observability never disturbs the transition
            pass

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

    def query_trace(self, query_id: str, include_recorder: bool = False) -> Optional[dict]:
        """The query's span tree across processes: the coordinator's spans
        and each task's dump (pulled now), with the phase ledger once the
        query ended. ``include_recorder`` attaches the flight-recorder
        postmortem: the one taken at FAILED, else a live merge of the
        rings."""
        from trino_tpu_torch.obs.trace import build_tree

        q = self.get_query(query_id)
        if q is None:
            return None
        spans = q.tracer.to_dicts() + list(q.extra_spans) + q.worker_spans()
        trace = {
            "queryId": q.query_id,
            "traceId": q.tracer.trace_id,
            "state": q.state.get(),
            "spanCount": len(spans),
            "timeline": q.timeline_dict(),
            "root": build_tree(spans),
        }
        if include_recorder:
            trace["postmortem"] = (q.postmortem if q.postmortem is not None
                                   else q.capture_postmortem(store=False))
        return trace

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
    if q.result_segments is not None:
        # the spooled protocol: the manifest instead of rows, which the
        # client fetches from the producers' segment routes in parallel
        q.last_drain_at = time.time()
        payload["columns"] = [{"name": c} for c in q.columns]
        payload["segments"] = [dict(e) for e in q.result_segments]
        payload["spooled"] = q.spooled
        return payload
    start = token * RESULT_PAGE_ROWS
    chunk = q.rows[start:start + RESULT_PAGE_ROWS]
    # the phase ledger's client-drain: the wall is over, the client still
    # fetches pages
    q.last_drain_at = time.time()
    payload["columns"] = [{"name": c} for c in q.columns]
    payload["data"] = [[_jsonable(v) for v in row] for row in chunk]
    if start + RESULT_PAGE_ROWS < len(q.rows):
        payload["nextUri"] = (f"{server.base_url}/v1/statement/executing/"
                              f"{q.query_id}/{token + 1}")
    return payload


def _drain_body(server: CoordinatorServer, q: QueryExecution, token: int) -> bytes:
    """One statement-protocol response, serialized; a response that carries
    the result (rows or a segment manifest) charges its bytes and serialize
    wall to the query's ``client-drain`` flow (the socket write is the
    client's)."""
    t0 = time.perf_counter()
    payload = _result_payload(server, q, token)
    body = json.dumps(payload).encode()
    if "data" in payload or "segments" in payload:
        try:
            from trino_tpu_torch.obs.flowledger import FLOW_LEDGER

            FLOW_LEDGER.record_transfer(
                "client-drain", f"drain:{q.query_id}", len(body), time.perf_counter() - t0,
                pages=len(payload.get("data") or payload.get("segments") or ()),
                src=FLOW_LEDGER.node_id or "coordinator", dst="client", direction="send")
            if "nextUri" not in payload:
                # the last page: its stats count this response's own bytes
                payload["stats"]["flows"] = q.flow_stats_block()
                body = json.dumps(payload).encode()
        except Exception:  # noqa: BLE001 — accounting never fails serving
            pass
    return body


def _profiler_snapshot() -> dict:
    """The postmortem's device-profiler block: the newest compile events
    and the utilization counters."""
    try:
        from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER

        return {"compiles": DEVICE_PROFILER.compile_rows(limit=16),
                "counters": DEVICE_PROFILER.counters()}
    except Exception:  # noqa: BLE001 — best-effort forensics
        return {}


def _flows_snapshot() -> dict:
    """The postmortem's flow-ledger block: per-link rollups, net totals,
    the newest transfers and the stall rollups."""
    try:
        from trino_tpu_torch.obs.flowledger import FLOW_LEDGER

        return FLOW_LEDGER.flow_snapshot()
    except Exception:  # noqa: BLE001 — best-effort forensics
        return {}


def _int_property(properties: dict, name: str, default: int) -> int:
    """An integer session property from the raw (wire-string) map; a
    malformed value falls back to the default."""
    try:
        return int(properties.get(name, default))
    except (TypeError, ValueError):
        return default


def _render_ui(server: CoordinatorServer) -> str:
    """The coordinator's status page: live queries with their progress and
    stages, the resource groups, the workers and the recent queries of the
    history ring (the reference's web UI, rendered on the server)."""
    import html

    rows = []
    with server._qlock:
        queries = sorted(server.queries.items(), reverse=True)
    for qid, q in queries[:50]:
        state = q.state.get()
        stage_list = q.stage_stats(include_operators=False)
        qs = q.query_stats(stage_list)
        stages = " ".join(f"f{s['stageId']}: {s['outputRows']} rows/{s['wallS'] * 1e3:.0f}ms"
                          for s in stage_list) or "—"
        progress = (f"{qs['completedSplits']}/{qs['totalSplits']} splits, "
                    f"{qs['elapsedMs'] / 1e3:.1f}s")
        rows.append(
            f"<tr><td>{html.escape(qid)}</td><td class='s {state}'>{state}</td>"
            f"<td>{html.escape(q.user)}</td>"
            f"<td><code>{html.escape(q.sql.strip()[:120])}</code></td>"
            f"<td>{html.escape(progress)}</td><td>{html.escape(stages)}</td></tr>")
    nodes = "".join(f"<tr><td>{html.escape(n['nodeId'])}</td><td>{html.escape(n['url'])}</td></tr>"
                    for n in server.registry.alive())
    recent = []
    for rec in server.history.snapshot()[:50]:
        recent.append(
            f"<tr><td>{html.escape(rec['queryId'])}</td>"
            f"<td class='s {rec['state']}'>{rec['state']}</td>"
            f"<td>{rec['elapsedMs'] / 1e3:.1f}s</td><td>{rec['resultRows']}</td>"
            f"<td>{html.escape(rec['cacheStatus'] or '—')}</td><td>{rec['adaptations']}</td>"
            f"<td><code>{html.escape((rec['query'] or '').strip()[:100])}</code></td></tr>")
    recent_html = "".join(recent) or "<tr><td colspan='7'>no completed queries yet</td></tr>"
    rg = server.resource_group.info()
    group_rows = "".join(
        f"<tr><td>{html.escape(gname)}</td><td>{g['state']}</td><td>{g['running']}</td>"
        f"<td>{g['queued']}</td><td>{g['served']}</td><td>{g['weight']}</td></tr>"
        for gname, g in sorted(rg.get("groups", {}).items()))
    groups_html = (
        "<h2>resource groups <small>(<code>select * from system.runtime.resource_groups"
        "</code>)</small></h2><table><tr><th>group</th><th>state</th><th>running</th>"
        f"<th>queued</th><th>served</th><th>weight</th></tr>{group_rows}</table>"
        if group_rows else "")
    return f"""<!doctype html><html><head><meta http-equiv="refresh" content="3">
<title>trino-tpu</title><style>
body{{font-family:monospace;margin:2em;background:#111;color:#ddd}}
table{{border-collapse:collapse;margin:1em 0;width:100%}}
td,th{{border:1px solid #333;padding:4px 10px;text-align:left}}
.s.FINISHED{{color:#6c6}}.s.FAILED{{color:#e66}}.s.RUNNING{{color:#6ae}}
h1,h2{{color:#fff}}</style></head><body>
<h1>trino-tpu coordinator</h1>
<p>device {html.escape(str(server.device))}; resource group "{rg['name']}": {rg['running']}
running, {rg['queued']} queued (limit {rg['hardConcurrencyLimit']})</p>
{groups_html}
<h2>workers</h2><table><tr><th>node</th><th>url</th></tr>{nodes}</table>
<h2>queries <small>(<a href="#recent" style="color:#6ae">recent queries</a> ·
<code>select * from system.runtime.queries</code>)</small></h2>
<table>
<tr><th>query id</th><th>state</th><th>user</th><th>query</th>
<th>progress</th><th>stages (rows/wall)</th></tr>
{''.join(rows)}</table>
<h2 id="recent">recent queries</h2><table>
<tr><th>query id</th><th>state</th><th>elapsed</th><th>rows</th>
<th>cache</th><th>adaptations</th><th>query</th></tr>
{recent_html}</table></body></html>"""


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

        def _segment_query(self, segment_id: str) -> Optional[QueryExecution]:
            """The query of a segment id (``<query>.s<n>-<token>``), whose
            segment-fetch clock a fetch or an ack stamps."""
            q = server.get_query(segment_id.split(".", 1)[0])
            if q is not None:
                q.last_segment_fetch_at = time.time()
            return q

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
                self._send(200, _drain_body(server, q, 0), headers=_cache_header(q))
                return
            self._send(404)

        def do_GET(self):
            m = _SEGMENT_RE.match(self.path)
            if m:
                # the coordinator's segments: the unguessable id is the
                # capability, so no further gate (pre-signed segment URIs)
                from trino_tpu_torch.server.segments import segment_response

                self._segment_query(m.group(1))
                status, body, seg_headers, ctype = segment_response(
                    server.segments, m.group(1), self.headers.get("Range"))
                self._send(status, body, ctype, seg_headers)
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
                self._send(200, _drain_body(server, q, int(m.group(2))),
                           headers=_cache_header(q))
                return
            # the trace route takes a query string (?recorder=1 attaches
            # the flight-recorder postmortem)
            from urllib.parse import parse_qs, urlsplit

            url_parts = urlsplit(self.path)
            for regex, kind in ((_TRACE_RE, "trace"), (_PROFILE_RE, "profile"),
                                (_FLOWS_RE, "flows")):
                m = regex.match(url_parts.path)
                if not m:
                    continue
                q = server.get_query(m.group(1))
                if not self._authenticated(query=q):
                    return
                body = None
                if q is not None and kind == "trace":
                    recorder = parse_qs(url_parts.query).get("recorder", ["0"])[0]
                    body = server.query_trace(
                        m.group(1), include_recorder=recorder not in ("0", "", "false"))
                elif q is not None:
                    body = q.profile_dict() if kind == "profile" else q.flows_dict()
                if body is None:
                    # an eviction between the two lookups too: never 200 null
                    self._send(404, b'{"error": "no such query"}')
                    return
                self._send(200, json.dumps(body).encode())
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
            if self.path in ("/ui", "/ui/"):
                self._send(200, _render_ui(server).encode(), "text/html")
                return
            self._send(404)

        def do_DELETE(self):
            m = _SEGMENT_RE.match(self.path)
            if m:
                # a segment's ack: data comes from the owning producer, the
                # ack through here, which forwards a worker's segment
                sid = m.group(1)
                q = self._segment_query(sid)
                worker = q._segment_workers.get(sid) if q is not None else None
                if worker is not None:
                    try:
                        wire.http_request("DELETE", f"{worker}/v1/segment/{sid}", timeout=10.0)
                    except Exception:  # noqa: BLE001 — the TTL is the backstop
                        pass
                else:
                    server.segments.ack(sid)
                self._send(204)
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
