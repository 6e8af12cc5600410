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

The coordinator runs on one torch device: CUDA unless it is given another
(``device="cpu"`` in the tests); asked for CUDA without a usable GPU it
raises.

Not ported (each refused, never ignored): ``retry_policy=TASK`` (the
fault-tolerant tier), spooled result segments, adaptive re-planning, the
result cache, materialized views, distributed EXPLAIN ANALYZE, resource
groups and the dispatch plane, cluster memory, the ledgers, and the
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
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from trino_tpu_torch.server import wire
from trino_tpu_torch.server.exchange_client import ExchangeClient, TaskLocation
from trino_tpu_torch.server.statemachine import StateMachine, query_state_machine
from trino_tpu_torch.server.task import TaskRequest
from trino_tpu_torch.server.worker import resolve_device
from trino_tpu_torch.sql.planner import plan as P
from trino_tpu_torch.sql.planner.fragmenter import RemoteSourceNode, fragment_plan

_ANNOUNCE_RE = re.compile(r"^/v1/announce/([^/]+)$")
_RESULT_RE = re.compile(r"^/v1/statement/executing/([^/]+)/(\d+)$")
_QUERY_RE = re.compile(r"^/v1/query/([^/]+)$")
_NOT_PORTED_RE = re.compile(r"^(/v1/query/[^/]+/(trace|profile|flows)|/ui/?|/v1/segment/[^/]+)$")

RESULT_PAGE_ROWS = 10_000


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
    ("result_cache_enabled", _truthy, "the result cache"),
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


class PreparedStatements:
    """PREPAREd statements of the server, keyed (user, name): the
    per-query sessions are thrown away, so the registry outlives them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[tuple, tuple] = {}

    def put(self, user: str, name: str, statement, sql: str) -> None:
        with self._lock:
            self._entries[(user, name)] = (statement, sql)

    def get(self, user: str, name: str):
        with self._lock:
            return self._entries.get((user, name))

    def remove(self, user: str, name: str) -> bool:
        with self._lock:
            return self._entries.pop((user, name), None) is not None


class QueryExecution:
    """One query's lifecycle on the coordinator."""

    def __init__(self, query_id: str, sql: str, session_properties: dict,
                 registry: NodeRegistry, session_factory, user: str = "anonymous",
                 prepared: Optional[PreparedStatements] = None):
        self.query_id = query_id
        self.sql = sql
        self.user = user
        self.session_properties = dict(session_properties)
        self.state: StateMachine[str] = query_state_machine()
        self.registry = registry
        self.session_factory = session_factory
        self.prepared = prepared
        # which path ran the SELECT: "distributed", "fast-path",
        # "local-catalog", or None (another statement)
        self.fast_path: Optional[str] = None
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
        try:
            self._run_lifecycle()
            self.ended_at = time.time()
            self.state.set("FINISHED")
        except Exception as e:  # noqa: BLE001 — reported through query info
            self.ended_at = self.ended_at or time.time()
            if self.failure is None:
                self.failure = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
            self._cancel_tasks()
            self.state.set("FAILED")

    def _run_lifecycle(self) -> None:
        from trino_tpu_torch.exec.query import _plan, run_query
        from trino_tpu_torch.server.security import Identity
        from trino_tpu_torch.sql.parser import ast
        from trino_tpu_torch.sql.parser.parser import parse_statement

        self.state.set("PLANNING")
        refuse_unported(self.session_properties)
        session = self.session_factory(self.session_properties)
        session.identity = Identity(self.user)
        stmt = parse_statement(self.sql)
        if (isinstance(stmt, ast.Explain) and stmt.analyze
                and isinstance(stmt.statement, ast.Query)):
            raise NotImplementedError(
                "distributed EXPLAIN ANALYZE is not ported to the PyTorch coordinator")
        if isinstance(stmt, (ast.CreateMaterializedView, ast.RefreshMaterializedView,
                             ast.DropMaterializedView)):
            raise NotImplementedError("materialized views are not ported")
        if isinstance(stmt, (ast.Prepare, ast.ExecutePrepared, ast.Deallocate)):
            self._run_prepared_statement(session, stmt)
            return
        if not isinstance(stmt, ast.Query):
            # metadata statements, EXPLAIN, CALL, DML and DDL run on the
            # coordinator alone
            self.state.set("RUNNING")
            result = run_query(session, self.sql)
            self.columns, self.rows = result.column_names, result.rows
            if isinstance(stmt, ast.SetSession):
                self.set_session[stmt.name] = session.properties[stmt.name]
            elif isinstance(stmt, ast.ResetSession):
                self.reset_session.append(stmt.name)
            return
        self._execute_query(session, _plan(session, stmt))

    def _run_prepared_statement(self, session, stmt) -> None:
        """PREPARE / EXECUTE / DEALLOCATE against the server's registry; an
        EXECUTE of a query runs the bound query through the distributed
        path."""
        from trino_tpu_torch.exec.query import _dispatch_statement, _plan, bind_parameters
        from trino_tpu_torch.sql.parser import ast

        reg = self.prepared
        if isinstance(stmt, ast.Prepare):
            self.state.set("RUNNING")
            m = re.match(r"(?is)^\s*prepare\s+\S+\s+from\s+(.*)$", self.sql.strip())
            sql_text = (m.group(1) if m else self.sql).strip()
            reg.put(self.user, stmt.name, stmt.statement, sql_text)
            self.add_prepared[stmt.name] = sql_text
            self.columns, self.rows = ["result"], [("PREPARE",)]
            return
        if isinstance(stmt, ast.Deallocate):
            self.state.set("RUNNING")
            if not reg.remove(self.user, stmt.name):
                raise ValueError(f"prepared statement not found: {stmt.name}")
            self.deallocated_prepared.append(stmt.name)
            self.columns, self.rows = ["result"], [("DEALLOCATE",)]
            return
        entry = reg.get(self.user, stmt.name)
        if entry is None:
            raise ValueError(f"prepared statement not found: {stmt.name}")
        bound = bind_parameters(entry[0], stmt.params)
        if not isinstance(bound, ast.Query):
            self.state.set("RUNNING")
            result = _dispatch_statement(session, bound)
            self.columns, self.rows = result.column_names, result.rows
            return
        self._execute_query(session, _plan(session, bound))

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
        fragments = self.fragments = fragment_plan(root, session)
        self.state.set("STARTING")
        workers = self.registry.alive()
        if not workers:
            raise RuntimeError("no alive workers")
        self._schedule(session, fragments, workers)
        self.state.set("RUNNING")
        result_page = self._run_root_fragment(session, fragments)
        self._sweep_task_status()
        self.state.set("FINISHING")
        self.columns = fragments[-1].root.column_names
        self._materialize_result(session, result_page)

    def _run_local(self, session, root, path: str) -> None:
        from trino_tpu_torch.exec.executor import Executor

        self.fast_path = path
        self.state.set("RUNNING")
        page = Executor(session).execute_checked(root)
        self.columns = list(root.column_names)
        self._materialize_result(session, page)

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
            "fastPath": self.fast_path,
            "fragments": {str(fid): [loc.task_id for loc in locs]
                          for fid, locs in self.fragment_tasks.items()},
            "tasks": tasks,
            "queryStats": self.stats(),
        }


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

        def _shared_catalog_session(properties):
            from trino_tpu_torch.client.session import Session

            return Session(properties, device=self.device, catalogs=self.catalogs,
                           udfs=self.udfs)

        self.session_factory = session_factory or _shared_catalog_session
        self.prepared = PreparedStatements()
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
                                   self.session_factory, user=user, prepared=self.prepared)
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
    import datetime
    import decimal

    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if isinstance(v, decimal.Decimal):
        return str(v)
    return v


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
                self._send(200, json.dumps(_result_payload(server, q, 0)).encode())
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
                    _result_payload(server, q, int(m.group(2)))).encode())
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
