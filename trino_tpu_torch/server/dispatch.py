"""Dispatch plane / executor plane split: the concurrent serving spine
(the port of trino_tpu/server/dispatch.py).

Reference: the dispatcher/executor split of the reference engine —
``dispatcher/QueuedStatementResource.java`` (dispatch: cheap, high
fan-in, owns admission + queueing and never does query work) vs
``server/protocol/ExecutingStatementResource.java`` +
``execution/SqlQueryExecution.java`` (execution). Without it a
coordinator starts a thread a query however overloaded it is, and the
pile-up of threads is its QPS ceiling.

Four pieces:

- ``DispatchQueue`` — the bounded admission buffer between the HTTP
  front and the executor plane (``GroupDispatchQueue`` over a
  ``ResourceGroupTree`` when the coordinator runs resource groups).
  Overload is TYPED: a full queue raises ``DispatchRejected`` (the
  QUERY_QUEUE_FULL analog) which the protocol surface turns into a 429 +
  ``Retry-After`` response with structured retry guidance — never a
  hang, never an unbounded thread pile-up.

- ``ServingIndex`` — the dispatch-plane result-cache index: repeat
  queries whose cached entry is still version-valid are answered on the
  HTTP thread without ever touching an executor lane.

- ``Dispatcher`` — the dispatch front. Its threads (the HTTP handler
  calling ``dispatch()``) do NO query work: they consult the serving
  index, then enqueue. A fixed pool of long-lived EXECUTOR LANES drains
  the queue: admission (resource group + cluster memory) and the query
  lifecycle run on a lane, so per-query thread creation is zero and
  concurrency is bounded by design instead of by accident.

- ``ProcessExecutorPlane`` (opt-in: ``executor_plane="process"`` /
  ``TRINO_TPU_EXECUTOR_PLANE=process``) — executor workers as separate
  OS processes. Each child is a full execution coordinator
  (``python -m trino_tpu_torch.server.dispatch``, a ``CoordinatorServer``
  reached over loopback HTTP with the statement protocol). The dispatch
  process owns the query registry and history, the authoritative
  prepared-statement and materialized-view registries (PREPARE,
  DEALLOCATE and view changes replicate to the children), the queue,
  admission, the serving index, the process-local catalogs (memory,
  system) and the device cache: device-cache, distributed, fault-tolerant
  and spooled queries run on its lanes. The children hold their own plan-
  and result-cache shards. Routing is sticky by (user, statement) hash,
  so a second EXECUTE lands on the child that holds its parameterized
  plan; cache keys embed connector data versions, so a DML on the
  dispatch process invalidates the children's entries too. Work a child
  cannot own (it has no workers) BOUNCES back to a dispatch-side lane.
  The children run on the dispatch coordinator's own device, CUDA on a
  GPU (a card holds a context for each process), unless
  ``TRINO_TPU_EXECPLANE_PLATFORMS`` names ``cpu`` or ``cuda``; the
  reference pins its children to the CPU because one process owns a TPU.
"""
from __future__ import annotations

import os
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

DEFAULT_QUEUE_CAPACITY = 256
DEFAULT_RETRY_AFTER_S = 1.0

PLANES = ("thread", "process")

# catalogs whose state lives in the dispatch process (process-local
# connectors + the system catalog): statements touching them never route
# to an executor process
OWNER_CATALOGS = ("memory", "system")

_OWNER_CATALOG_RE = re.compile(
    r"(?i)\b(?:%s)\s*\." % "|".join(OWNER_CATALOGS))
_EXECUTE_RE = re.compile(r"(?is)^\s*execute\s+(\S+)")
_SELECT_RE = re.compile(r"(?is)^\s*(?:select|with|values)\b")

# the executor children's devices TRINO_TPU_EXECPLANE_PLATFORMS may name
CHILD_DEVICES = ("cpu", "cuda")


def default_lane_count() -> int:
    env = os.environ.get("TRINO_TPU_EXECUTOR_LANES")
    if env:
        return max(1, int(env))
    return max(8, min(32, (os.cpu_count() or 2) * 4))


def default_queue_capacity() -> int:
    env = os.environ.get("TRINO_TPU_DISPATCH_QUEUE_CAPACITY")
    if env:
        return max(1, int(env))
    return DEFAULT_QUEUE_CAPACITY


class DispatchRejected(RuntimeError):
    """Typed overload: the dispatch queue is full. Carries the retry
    guidance the 429 response ships (the QUERY_QUEUE_FULL analog).
    Group-aware admission adds WHICH queue said no (``resource_group``)
    and how many queries sit ahead (``queued_ahead``) so a client can
    tell its own group's saturation from global overload. The message
    keeps the reference's stable "Dispatch queue is full" prefix."""

    code = "DISPATCH_QUEUE_FULL"

    def __init__(self, queued: int, capacity: int,
                 retry_after_s: float = DEFAULT_RETRY_AFTER_S,
                 resource_group: Optional[str] = None,
                 queued_ahead: Optional[int] = None):
        self.queued = queued
        self.capacity = capacity
        self.retry_after_s = retry_after_s
        self.resource_group = resource_group
        self.queued_ahead = queued_ahead
        where = (f" for resource group {resource_group}"
                 if resource_group else "")
        super().__init__(
            f"Dispatch queue is full{where} ({queued}/{capacity} queued); "
            f"retry in {retry_after_s:g}s")

    def payload(self) -> dict:
        err = {
            "message": str(self),
            "code": self.code,
            "retryAfterSeconds": self.retry_after_s,
            "queued": self.queued,
            "capacity": self.capacity,
        }
        if self.resource_group is not None:
            err["resourceGroup"] = self.resource_group
        if self.queued_ahead is not None:
            err["queuedAhead"] = self.queued_ahead
        return {"error": err}


class DispatchQueue:
    """Bounded FIFO between the dispatch front and the executor lanes.
    ``offer`` never blocks: a full queue is a typed rejection, which is
    the overload contract (bounded memory, bounded threads, a clear
    client signal instead of an invisible pile-up)."""

    # recent take() timestamps kept for the drain-rate estimator — the
    # Retry-After a 429 ships is how long the observed rate needs to
    # clear the queue ahead, not a constant
    DRAIN_WINDOW = 64

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._dq: deque = deque()
        self._drains: deque = deque(maxlen=self.DRAIN_WINDOW)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False

    def depth(self) -> int:
        with self._lock:
            return len(self._dq)

    def drain_rate(self) -> float:
        """Observed dequeue rate in items/second over the recent take
        window (0.0 until two takes have happened)."""
        with self._lock:
            drains = list(self._drains)
        if len(drains) < 2:
            return 0.0
        window = drains[-1] - drains[0]
        if window <= 0:
            return 0.0
        return (len(drains) - 1) / window

    def retry_after_s(self, queued_ahead: int) -> float:
        """Honest Retry-After: time for the observed drain rate to clear
        ``queued_ahead`` items, clamped to [0.1, 30]; the constant
        fallback covers a queue that has never drained."""
        rate = self.drain_rate()
        if rate <= 0.0:
            return DEFAULT_RETRY_AFTER_S
        return min(30.0, max(0.1, (queued_ahead + 1) / rate))

    def check_capacity(self) -> None:
        """Cheap pre-admission probe for the HTTP thread: raises
        ``DispatchRejected`` while the queue is at capacity so overload
        turns around before any per-query state is built."""
        from trino_tpu_torch.obs import metrics as M

        with self._lock:
            full = len(self._dq) >= self.capacity
            depth = len(self._dq)
        if full:
            M.DISPATCH_REJECTED.inc(1, "queue-full")
            raise DispatchRejected(depth, self.capacity,
                                   retry_after_s=self.retry_after_s(depth),
                                   queued_ahead=depth)

    def offer(self, item) -> None:
        from trino_tpu_torch.obs import metrics as M

        with self._lock:
            rejected = len(self._dq) >= self.capacity
            if not rejected:
                self._dq.append(item)
                self._cond.notify()
            depth = len(self._dq)
        M.DISPATCH_QUEUE_DEPTH.set(depth)
        if rejected:
            M.DISPATCH_REJECTED.inc(1, "queue-full")
            raise DispatchRejected(depth, self.capacity,
                                   retry_after_s=self.retry_after_s(depth),
                                   queued_ahead=depth)

    def take(self, timeout: float = 0.5):
        """Next queued item, or None on timeout/close (lanes poll so
        shutdown never strands a thread)."""
        from trino_tpu_torch.obs import metrics as M

        with self._lock:
            # lint: allow(blocking-under-lock) Condition.wait_for RELEASES the lock while parked
            self._cond.wait_for(
                lambda: self._dq or self._closed, timeout)
            if not self._dq:
                return None
            item = self._dq.popleft()
            self._drains.append(time.time())
            depth = len(self._dq)
        M.DISPATCH_QUEUE_DEPTH.set(depth)
        return item

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._cond.notify_all()


class GroupDispatchQueue:
    """Group-aware admission buffer: the ``DispatchQueue`` surface
    (offer/take/depth/close/check_capacity) over a
    :class:`~trino_tpu_torch.server.resource_groups.ResourceGroupTree`.
    Queries park in their GROUP's queue (bounded by the group's
    ``max_queued``) and lanes drain by weighted-fair pick among eligible
    groups instead of global FIFO; the global ``capacity`` still bounds
    total parked queries so coordinator memory stays bounded under any
    config. A query parked past its group's ``queue_timeout_ms`` is
    failed HERE, typed ``EXCEEDED_QUEUE_TIMEOUT``, on the lane thread
    that swept it out."""

    def __init__(self, tree, capacity: int):
        self.tree = tree
        self.capacity = max(1, int(capacity))

    def depth(self) -> int:
        return self.tree.total_queued()

    def drain_rate(self) -> float:
        return self.tree.drain_rate()

    def retry_after_s(self, queued_ahead: int) -> float:
        return self.tree.retry_after_s(queued_ahead,
                                       fallback=DEFAULT_RETRY_AFTER_S)

    def check_capacity(self, group: Optional[str] = None) -> None:
        """Overload probe for the HTTP thread: global capacity first,
        then the target group's ``max_queued`` when known."""
        from trino_tpu_torch.obs import metrics as M

        depth = self.depth()
        if depth >= self.capacity:
            M.DISPATCH_REJECTED.inc(1, "queue-full")
            if group is not None:
                M.RESOURCE_GROUP_REJECTED.inc(1, group, "queue-full")
            raise DispatchRejected(
                depth, self.capacity,
                retry_after_s=self.retry_after_s(depth),
                resource_group=group, queued_ahead=depth)
        if group is not None:
            queued, max_queued = self.tree.queue_state(group)
            if queued >= max_queued:
                M.DISPATCH_REJECTED.inc(1, "queue-full")
                M.RESOURCE_GROUP_REJECTED.inc(1, group, "queue-full")
                raise DispatchRejected(
                    queued, max_queued,
                    retry_after_s=self.retry_after_s(queued),
                    resource_group=group, queued_ahead=queued)

    def offer(self, execution) -> None:
        from trino_tpu_torch.obs import metrics as M

        group = getattr(execution, "resource_group", None)
        if group is None:
            group = self.tree.select(execution.user, getattr(
                execution, "source", ""), execution.session_properties)
            execution.resource_group = group
        depth = self.depth()
        if depth >= self.capacity:
            M.DISPATCH_REJECTED.inc(1, "queue-full")
            M.RESOURCE_GROUP_REJECTED.inc(1, group, "queue-full")
            raise DispatchRejected(
                depth, self.capacity,
                retry_after_s=self.retry_after_s(depth),
                resource_group=group, queued_ahead=depth)
        try:
            ahead = self.tree.enqueue(group, execution.query_id, execution)
        except IndexError:
            queued, max_queued = self.tree.queue_state(group)
            M.DISPATCH_REJECTED.inc(1, "queue-full")
            M.RESOURCE_GROUP_REJECTED.inc(1, group, "queue-full")
            raise DispatchRejected(
                queued, max_queued,
                retry_after_s=self.retry_after_s(queued),
                resource_group=group, queued_ahead=queued)
        execution.queued_ahead = ahead
        M.DISPATCH_QUEUE_DEPTH.set(self.depth())

    def take(self, timeout: float = 0.5):
        """Next ADMITTED execution (weighted-fair, concurrency- and
        memory-eligible), or None on timeout/close. Aged-out queries are
        failed inline and the wait continues — a lane never returns a
        query that was not admitted."""
        from trino_tpu_torch.obs import metrics as M

        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            out = self.tree.dequeue(timeout=remaining)
            if out is None:
                return None
            kind, execution, group, waited = out
            M.DISPATCH_QUEUE_DEPTH.set(self.depth())
            if kind == "run":
                return execution
            self._fail_aged(execution, group, waited)

    def _fail_aged(self, execution, group: str, waited: float) -> None:
        """Typed queue-timeout failure: the query never ran, its whole
        wall clock IS the queued phase (the timeline synthesizes it from
        the created->first-span gap)."""
        from trino_tpu_torch.obs import metrics as M

        M.RESOURCE_GROUP_REJECTED.inc(1, group, "queue-timeout")
        sp = getattr(execution, "_dispatch_queue_span", None)
        if sp is not None:
            execution.tracer.end_span(sp)
            execution._dispatch_queue_span = None
        execution.failure = (
            f"Query exceeded the queue timeout of resource group {group}: "
            f"EXCEEDED_QUEUE_TIMEOUT after {waited:.1f}s queued")
        execution.ended_at = time.time()
        execution.state.set("FAILED")

    def close(self) -> None:
        self.tree.close()


class ServingIndex:
    """The dispatch-plane result-cache index: (user, catalog, schema,
    SQL text) -> (result-cache key, captured data versions) for queries
    that completed as cache MISS-then-fill. A repeat of the exact
    statement revalidates the versions with cheap connector calls and —
    still valid — is served straight from the result cache ON THE
    DISPATCH THREAD: a warm HIT never occupies an executor lane or a
    queue slot. Anything that could change results outside the version
    vocabulary (DDL, CREATE FUNCTION, SET — any non-SELECT statement)
    clears the whole index; DML clears it too, and also moves the data
    versions, so even a racily re-learned entry revalidates false."""

    MAX_ENTRIES = 512

    def __init__(self):
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def _key(user: str, properties: dict, sql: str) -> tuple:
        return (user, str(properties.get("catalog", "")),
                str(properties.get("schema", "")), sql.strip())

    def note(self, user: str, properties: dict, sql: str,
             cache_key: str, versions) -> None:
        if not versions:
            return
        key = self._key(user, properties, sql)
        with self._lock:
            self._entries[key] = (cache_key, tuple(versions))
            self._entries.move_to_end(key)
            while len(self._entries) > self.MAX_ENTRIES:
                self._entries.popitem(last=False)

    def lookup(self, user: str, properties: dict, sql: str):
        key = self._key(user, properties, sql)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                # hits refresh recency: lane repeats of a learned query
                # are cache HITs (never re-learned), so without this the
                # hottest entries would age out of the LRU first
                self._entries.move_to_end(key)
        return ent

    def forget(self, user: str, properties: dict, sql: str) -> None:
        with self._lock:
            self._entries.pop(self._key(user, properties, sql), None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class Dispatcher:
    """The dispatch front + executor plane of one coordinator.

    ``dispatch()`` runs on the caller's (HTTP) thread and does only
    dispatch-plane work: serving-index consult, then a bounded enqueue.
    The executor lanes — long-lived threads created once — pop queued
    executions, run admission, and execute inline (thread plane) or
    forward to an executor process (process plane)."""

    def __init__(self, server, lanes: Optional[int] = None,
                 queue_capacity: Optional[int] = None,
                 plane: Optional[str] = None,
                 processes: Optional[int] = None,
                 groups=None):
        self._server = server
        self.lane_count = (default_lane_count()
                           if lanes is None else max(0, int(lanes)))
        capacity = (default_queue_capacity()
                    if queue_capacity is None else queue_capacity)
        # a coordinator with a ResourceGroupTree gets group-aware
        # admission; one with an injected flat gate keeps the single FIFO
        self.groups = groups
        self.queue = (GroupDispatchQueue(groups, capacity)
                      if groups is not None else DispatchQueue(capacity))
        self.plane = resolve_plane(plane)
        self.index = ServingIndex()
        self.process_plane = None
        if self.plane == "process":
            self.process_plane = ProcessExecutorPlane(
                server, processes or int(os.environ.get(
                    "TRINO_TPU_EXECUTOR_PROCESSES", "2")))
        self._threads: List[threading.Thread] = []
        self._busy = 0
        self._lock = threading.Lock()
        self._stopped = False

    # ------------------------------------------------------------ dispatch
    def dispatch(self, execution) -> bool:
        """Dispatch one registered execution. Returns True when the query
        was answered entirely on the dispatch plane (serving index),
        False when it was enqueued for the executor plane. Raises
        ``DispatchRejected`` when the queue is full."""
        self.ensure_lanes()
        if self._serve_from_index(execution):
            if self.groups is not None:
                group = getattr(execution, "resource_group", None)
                if group:
                    # a serving-index hit is concurrency-free but NOT
                    # invisible: it counts against the group's served
                    # tally so a saturated group's cached repeats stay
                    # auditable
                    self.groups.note_served(group)
            return True
        sp = execution.tracer.start_span("dispatch/queue")
        try:
            self.queue.offer(execution)
        except DispatchRejected:
            execution.tracer.end_span(sp)
            raise
        execution._dispatch_queue_span = sp
        return False

    def precheck(self, group: Optional[str] = None) -> None:
        """HTTP-thread overload probe, before any per-query state.
        ``group`` (known only under group-aware admission) adds the
        target group's ``max_queued`` bound to the global-capacity
        check."""
        if group is not None and self.groups is not None:
            self.queue.check_capacity(group)
        else:
            self.queue.check_capacity()

    def _serve_from_index(self, execution) -> bool:
        """Dispatch-plane result-cache consult: answer a repeat query
        whose cached entry is still version-valid without queueing it.
        Only dict lookups + per-table ``data_version`` calls run here —
        no parsing, no planning, no execution."""
        from trino_tpu_torch.obs import metrics as M

        props = execution.session_properties
        if str(props.get("result_cache_enabled", "")).lower() not in (
                "true", "1"):
            return False
        ent = self.index.lookup(execution.user, props, execution.sql)
        if ent is None:
            return False
        cache_key, versions = ent
        catalogs = self._server.catalogs
        for (catalog, schema, table), version in versions:
            conn = catalogs.get(catalog)
            try:
                current = (conn.data_version(schema, table)
                           if conn is not None else None)
            except Exception:  # noqa: BLE001 — revalidation must not throw
                current = None
            if current is None or str(current) != version:
                self.index.forget(execution.user, props, execution.sql)
                return False
        payload = self._server.query_cache.results.peek(cache_key)
        if payload is None:
            self.index.forget(execution.user, props, execution.sql)
            return False
        columns, rows = payload
        # the served statement IS a plain SELECT (only those are learned)
        # — without this, note_completion would treat the dispatch-plane
        # hit as a non-SELECT and wipe the very index that served it
        execution.is_plain_select = True
        root_span = execution.tracer.start_span(
            "query", query_id=execution.query_id, user=execution.user)
        sp = execution.tracer.start_span(
            "dispatch/serve", parent_id=root_span.span_id)
        sp.set("rows", len(rows))
        execution.columns = list(columns)
        execution.rows = list(rows)
        execution.cache_status = "HIT"
        execution.tracer.end_span(sp)
        execution.tracer.end_span(root_span)
        execution.ended_at = time.time()
        M.RESULT_CACHE_HITS.inc()
        M.DISPATCH_CACHE_SERVED.inc()
        execution.state.set("FINISHING")
        execution.state.set("FINISHED")
        return True

    def note_completion(self, execution, stmt_was_select: bool) -> None:
        """Completion hook (from the server's terminal listener): learn
        MISS-then-filled SELECTs into the serving index; clear the index
        on any statement that is not a plain SELECT."""
        if not stmt_was_select:
            self.index.clear()
            return
        key = getattr(execution, "result_cache_key", None)
        versions = getattr(execution, "result_cache_versions", None)
        if (key and versions and execution.cache_status == "MISS"
                and execution.state.get() == "FINISHED"):
            self.index.note(execution.user, execution.session_properties,
                            execution.sql, key, versions)

    # --------------------------------------------------------------- lanes
    def ensure_lanes(self) -> None:
        if self._threads or self.lane_count <= 0 or self._stopped:
            return
        with self._lock:
            if self._threads or self._stopped:
                return
            for i in range(self.lane_count):
                t = threading.Thread(
                    target=self._lane_loop, name=f"executor-lane-{i}",
                    daemon=True)
                self._threads.append(t)
                t.start()

    def start_lanes(self, count: Optional[int] = None) -> None:
        """Test hook + explicit start: bring up the lanes (optionally
        overriding the count before first start)."""
        if count is not None and not self._threads:
            self.lane_count = count
        self.ensure_lanes()

    def busy_lanes(self) -> int:
        with self._lock:
            return self._busy

    def _lane_loop(self) -> None:
        from trino_tpu_torch.obs import metrics as M

        while not self._stopped:
            execution = self.queue.take(timeout=0.5)
            if execution is None:
                continue
            sp = getattr(execution, "_dispatch_queue_span", None)
            if sp is not None:
                execution.tracer.end_span(sp)
            with self._lock:
                self._busy += 1
            M.EXECUTOR_LANES_BUSY.set(self._busy)
            try:
                self._run_one(execution)
            except Exception as e:  # noqa: BLE001 — a lane never dies
                execution.failure = execution.failure or str(e)
                execution.ended_at = execution.ended_at or time.time()
                execution.state.set("FAILED")
            finally:
                with self._lock:
                    self._busy -= 1
                M.EXECUTOR_LANES_BUSY.set(self._busy)

    def _run_one(self, execution) -> None:
        from trino_tpu_torch.obs import metrics as M
        from trino_tpu_torch.server import resource_groups as rg

        if not self._server._admit(execution):
            return
        # bind the query's group to this lane for the run: cache tiers
        # read it at admission time to tag entries with their owner
        # group (the carve-out bookkeeping)
        token = rg.set_current_group(
            getattr(execution, "resource_group", None))
        try:
            pp = self.process_plane
            if pp is not None:
                key = pp.route_key(execution)
                if key is not None:
                    M.EXECUTOR_PLANE_QUERIES.inc(1, "process")
                    pp.run(execution, key=key)
                    return
            M.EXECUTOR_PLANE_QUERIES.inc(1, "inline")
            execution.run()
        finally:
            rg.reset_current_group(token)

    def refresh_gauges(self) -> None:
        from trino_tpu_torch.obs import metrics as M

        M.DISPATCH_QUEUE_DEPTH.set(self.queue.depth())
        M.EXECUTOR_LANES_BUSY.set(self.busy_lanes())

    # ----------------------------------------------------------- ownership
    def serving_rows(self) -> List[tuple]:
        """Rows of ``system.runtime.serving``: every shared serving-plane
        structure with its owner (the reference's row shape), so the
        ownership of the dispatch/executor split is introspectable over
        SQL."""
        s = self._server
        proc = self.plane == "process"
        owner = "dispatch-process"
        shard = ("executor-process (sticky shard)" if proc
                 else "dispatch-process")
        cache = s.query_cache
        rows = [
            ("dispatch_queue", owner, self.plane, self.queue.depth(), None,
             f"capacity={self.queue.capacity}"),
            ("executor_lanes", owner, self.plane, self.busy_lanes(), None,
             f"lanes={self.lane_count}" + (
                 f" processes={self.process_plane.process_count()}"
                 if proc else "")),
            ("serving_index", owner, self.plane, len(self.index), None,
             "result-cache index consulted on the dispatch thread"),
            ("result_cache", shard, self.plane, len(cache.results),
             cache.results.cached_bytes(),
             "keys embed user + connector data versions"),
            ("plan_cache", shard, self.plane, len(cache.plans._entries),
             None, "keys embed user + session properties + data versions"),
            ("prepared_statements", owner, self.plane,
             len(s.prepared.snapshot()), None,
             "authoritative registry; replicated to executor processes"
             if proc else "authoritative registry"),
            ("materialized_views", owner, self.plane,
             len(s.matviews), None,
             "authoritative registry; replicated to executor processes"
             if proc else "authoritative registry"),
            ("query_registry", owner, self.plane, len(s.queries), None,
             "every query registers here regardless of executing plane"),
            ("query_history", owner, self.plane, len(s.history), None,
             "bounded completed-query ring"),
            ("device", owner, self.plane, None, None,
             "single device owner: device-cache/distributed work runs on "
             "dispatch-side lanes"),
        ]
        return rows

    def shutdown(self) -> None:
        self._stopped = True
        self.queue.close()
        if self.process_plane is not None:
            self.process_plane.shutdown()


def resolve_plane(plane: Optional[str] = None) -> str:
    """The executor plane asked for: the argument, else
    ``TRINO_TPU_EXECUTOR_PLANE``, else ``thread``. An unknown name raises
    ValueError."""
    name = (plane or os.environ.get("TRINO_TPU_EXECUTOR_PLANE") or "thread").lower()
    if name not in PLANES:
        raise ValueError(f"unknown executor plane {name!r} (known: {', '.join(PLANES)})")
    return name


def child_device(server_device) -> str:
    """The device of the executor children: ``TRINO_TPU_EXECPLANE_PLATFORMS``
    (``cpu`` or ``cuda``) where it is set, else the dispatch coordinator's
    own device. Any other value raises ValueError."""
    env = os.environ.get("TRINO_TPU_EXECPLANE_PLATFORMS")
    if env:
        name = env.strip().lower()
        if name not in CHILD_DEVICES:
            raise ValueError(
                f"TRINO_TPU_EXECPLANE_PLATFORMS={env!r}: the executor children run on "
                f"{' or '.join(CHILD_DEVICES)}")
        return name
    return str(server_device)


# --------------------------------------------------------- process plane
def executor_process_main(argv=None) -> None:
    """Entry point of one executor process
    (``python -m trino_tpu_torch.server.dispatch [--lanes N] [--device D]``):
    a full execution coordinator on loopback HTTP with small inline lanes
    and no process plane of its own, on ``--device`` (``cuda`` unless
    named; CUDA without a usable GPU raises). Prints a one-line JSON hello
    ``{"url": ..., "pid": ...}``, then serves until stdin closes (the
    dispatch process owns the lifetime). Everything else the process would
    print goes to stderr, so the hello is the first line the parent reads
    and an unread stdout pipe never blocks the child."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(prog="python -m trino_tpu_torch.server.dispatch")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out, sys.stdout = sys.stdout, sys.stderr
    try:
        from trino_tpu_torch.server.coordinator import CoordinatorServer

        server = CoordinatorServer(executor_lanes=args.lanes,
                                   executor_plane="thread", device=args.device)
        server.start()
        out.write(json.dumps({"url": server.base_url, "pid": os.getpid()}) + "\n")
        out.flush()
        try:
            while sys.stdin.readline():
                pass  # ignore chatter; EOF = the dispatch process is done with us
        except (OSError, KeyboardInterrupt):
            pass
        server.stop()
    finally:
        sys.stdout = out


class _Bounce(Exception):
    """The child cannot own this query (needs workers / owner state) —
    re-run it on a dispatch-side lane."""


class ProcessExecutorPlane:
    """Pool of executor processes, each a spawned execution coordinator
    reached over loopback HTTP. Children boot lazily on the first routed
    query (spawn + engine import is seconds — paid once)."""

    BOOT_TIMEOUT_S = 120.0

    def __init__(self, server, processes: int = 2, device: Optional[str] = None):
        self._server = server
        self._n = max(1, int(processes))
        self.device = device or child_device(server.device)
        self._children: List[dict] = []
        self._boot_lock = threading.Lock()
        self._stopped = False

    def process_count(self) -> int:
        return self._n

    # ------------------------------------------------------------- routing
    def route_key(self, execution) -> Optional[str]:
        """Sticky routing key, or None when the query must run on a
        dispatch-side lane (owner-catalog state, the device cache,
        fault-tolerant and spooled queries, non-SELECT statements). The
        probe is syntactic — cheap enough for the lane — and the child's
        loud failure is the semantic backstop (``_Bounce``)."""
        props = execution.session_properties
        sql = execution.sql
        if str(props.get("catalog", "tpch")).lower() in OWNER_CATALOGS:
            return None
        if _OWNER_CATALOG_RE.search(sql):
            return None
        if str(props.get("device_cache_enabled", "")).lower() in (
                "true", "1"):
            return None  # the dispatch process owns the device cache
        if str(props.get("retry_policy", "NONE")).upper() == "TASK":
            return None
        if str(props.get("spooled_results_enabled", "")).lower() in (
                "true", "1"):
            # a spooled manifest must point at a segment store the
            # dispatch process serves — the child's statement protocol
            # forwards rows, not segments, so these stay inline
            return None
        m = _EXECUTE_RE.match(sql)
        if m:
            return f"execute:{execution.user}:{m.group(1).lower()}"
        if _SELECT_RE.match(sql):
            return (f"select:{execution.user}:{props.get('catalog', '')}:"
                    f"{props.get('schema', '')}:{sql.strip()}")
        return None

    # ------------------------------------------------------------ children
    def _ensure_children(self) -> None:
        if self._children or self._stopped:
            return
        with self._boot_lock:
            if self._children or self._stopped:
                return
            import json
            import selectors
            import subprocess
            import sys

            import trino_tpu_torch
            from trino_tpu_torch.server import wire

            env = dict(os.environ)
            # same cluster secret so internal calls verify both ways
            env["TRINO_TPU_INTERNAL_SECRET"] = wire.get_secret()
            # the child imports the same package tree whatever its
            # working directory
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.abspath(trino_tpu_torch.__file__)))
            env["PYTHONPATH"] = pkg_root + (
                os.pathsep + env["PYTHONPATH"]
                if env.get("PYTHONPATH") else "")
            children = []
            for i in range(self._n):
                proc = subprocess.Popen(
                    [sys.executable, "-m", "trino_tpu_torch.server.dispatch",
                     "--lanes", "4", "--device", self.device],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    env=env, text=True)
                children.append({"proc": proc, "url": None, "index": i,
                                 "pid": proc.pid})
            deadline = time.monotonic() + self.BOOT_TIMEOUT_S
            for ch in children:
                sel = selectors.DefaultSelector()
                sel.register(ch["proc"].stdout, selectors.EVENT_READ)
                line = ""
                while time.monotonic() < deadline and not line:
                    if sel.select(timeout=0.5):
                        line = ch["proc"].stdout.readline()
                    if ch["proc"].poll() is not None:
                        break
                sel.close()
                if not line:
                    for c in children:
                        c["proc"].terminate()
                    raise RuntimeError(
                        "executor process failed to boot within "
                        f"{self.BOOT_TIMEOUT_S:g}s")
                ch["url"] = json.loads(line)["url"]
            self._children = children

    def child_for(self, key: str) -> dict:
        self._ensure_children()
        import zlib

        return self._children[zlib.crc32(key.encode()) % len(self._children)]

    def children_urls(self) -> List[str]:
        return [ch["url"] for ch in self._children]

    def children_pids(self) -> List[int]:
        return [ch["pid"] for ch in self._children]

    # ------------------------------------------------------------- running
    def run(self, execution, key: Optional[str] = None) -> None:
        """Forward one admitted execution to its sticky child; on bounce
        (the child cannot own it) run inline on this lane. ``key`` is the
        routing key the lane already computed (recomputed if omitted)."""
        if key is None:
            key = self.route_key(execution)
        try:
            child = self.child_for(key)
        except Exception as e:  # noqa: BLE001 — boot failure -> inline
            execution.tracer.start_span(
                "dispatch/forward", error=str(e)[:200]).close()
            execution.run()
            return
        try:
            self._forward(execution, child)
        except _Bounce as b:
            from trino_tpu_torch.obs import metrics as M

            M.EXECUTOR_PLANE_QUERIES.inc(1, "bounced")
            sp = execution.tracer.start_span("dispatch/forward")
            sp.set("bounced", str(b)[:200])
            execution.tracer.end_span(sp)
            execution.run()

    # statement-protocol headers the child's session should see — every
    # child-bound request takes its headers from here
    @staticmethod
    def _session_headers(user: str, properties: dict) -> Dict[str, str]:
        headers = {"X-Trino-User": user}
        for k, v in properties.items():
            headers[f"X-Trino-Session-{k}"] = str(v)
        return headers

    def _replay_prepare(self, execution, child) -> bool:
        """Child lost (or never saw) a prepared statement: replay the
        PREPARE from the authoritative dispatch-side registry."""
        from trino_tpu_torch.server import wire

        m = _EXECUTE_RE.match(execution.sql)
        if not m:
            return False
        ps = self._server.prepared.get(execution.user, m.group(1))
        if ps is None:
            return False
        status, _, _ = wire.http_request(
            "POST", f"{child['url']}/v1/statement",
            f"PREPARE {ps.name} FROM {ps.sql}".encode(), "text/plain",
            headers=self._session_headers(execution.user,
                                          execution.session_properties))
        return status < 400

    def broadcast(self, sql: str, user: str, properties: dict) -> None:
        """Replicate a registry mutation (PREPARE / DEALLOCATE / a view's
        sync) to every booted child, best-effort — a child that missed a
        PREPARE re-syncs on its first EXECUTE via ``_replay_prepare``."""
        from trino_tpu_torch.server import wire

        headers = self._session_headers(user, properties)
        for ch in self._children:
            try:
                wire.http_request("POST", f"{ch['url']}/v1/statement",
                                  sql.encode(), "text/plain",
                                  headers=headers, timeout=10.0)
            except Exception:  # noqa: BLE001 — replay covers the miss
                pass

    def _forward(self, execution, child) -> None:
        """One forwarded statement: POST + poll on the child's statement
        protocol, result fields copied onto the dispatch-side execution
        so every read surface (registry, system tables, events, the
        client protocol) covers it like an inline query."""
        import json

        from trino_tpu_torch.server import wire

        execution.state.set("PLANNING")
        root_span = execution.tracer.start_span(
            "query", query_id=execution.query_id, user=execution.user)
        qs = getattr(execution, "_dispatch_queue_span", None)
        if qs is not None:  # adopt the pre-root queue span (single root)
            qs.parent_id = root_span.span_id
        fwd = execution.tracer.start_span(
            "dispatch/forward", parent_id=root_span.span_id)
        fwd.set("child", child["url"])
        headers = self._session_headers(execution.user,
                                        execution.session_properties)
        try:
            # at most two attempts under the same root/forward spans (the
            # trace tree stays single-rooted): the second one only after
            # a prepared-statement replay to a child that lost its replica
            for attempt in range(2):
                cache_status = None
                status, body, resp_headers = wire.http_request(
                    "POST", f"{child['url']}/v1/statement",
                    execution.sql.encode(), "text/plain", headers=headers)
                if status >= 400:
                    raise _Bounce(f"child submit failed: {status}")
                payload = json.loads(body)
                execution.state.set("RUNNING")
                columns: List[str] = []
                rows: List[list] = []
                stats: dict = {}
                child_qid = payload.get("id")
                deadline = time.monotonic() + 600.0
                replayed = False
                while True:
                    for k, v in (resp_headers or {}).items():
                        if k.lower() == "x-trino-tpu-cache":
                            cache_status = v
                    child_qid = payload.get("id", child_qid)
                    stats = payload.get("stats") or stats
                    if "error" in payload:
                        msg = payload["error"].get("message", "")
                        if ("no alive workers" in msg
                                or "Dispatch queue is full" in msg):
                            raise _Bounce(msg)
                        if ("prepared statement not found" in msg
                                and attempt == 0
                                and self._replay_prepare(execution,
                                                         child)):
                            replayed = True
                            break
                        raise RuntimeError(msg)
                    if "columns" in payload:
                        columns = [c["name"] for c in payload["columns"]]
                    rows.extend(payload.get("data", []))
                    next_uri = payload.get("nextUri")
                    if next_uri is None:
                        break
                    if time.monotonic() > deadline:
                        raise RuntimeError("executor-process poll timeout")
                    status, body, resp_headers = wire.http_request(
                        "GET", next_uri, timeout=60.0)
                    if status >= 400:
                        raise RuntimeError(
                            f"executor-process poll failed: {status}")
                    payload = json.loads(body)
                if replayed:
                    fwd.set("replayedPrepare", True)
                    continue
                break
            execution.columns = columns
            execution.rows = [tuple(r) for r in rows]
            execution.cache_status = cache_status or stats.get(
                "cacheStatus")
            execution.fast_path = stats.get("fastPath")
            # view substitutions decided in the child's planner surface on
            # the dispatch-side execution too (queryStats.mvHits/mvNames)
            execution.mv_substitutions = list(stats.get("mvNames") or ())
            execution.plane = f"executor-process:{child['index']}"
            fwd.set("childQueryId", child_qid)
            self._note_child_stats(execution, child, stats)
            self._pull_child_spans(execution, child, child_qid)
            m = _EXECUTE_RE.match(execution.sql)
            if m:
                # keep the authoritative registry's execution counters
                # live (the child bumped only its replica)
                self._server.prepared.touch(execution.user, m.group(1))
        except _Bounce:
            fwd.set("bounced", True)
            execution.tracer.end_span(fwd)
            execution.tracer.end_span(root_span)
            raise
        except Exception as e:  # noqa: BLE001 — reported via query info
            execution.failure = str(e)
            fwd.set("error", str(e)[:300])
            execution.tracer.end_span(fwd)
            execution.tracer.end_span(root_span)
            execution.ended_at = time.time()
            execution._warm_timeline()
            execution.state.set("FAILED")
            return
        execution.tracer.end_span(fwd)
        execution.tracer.end_span(root_span)
        execution.ended_at = time.time()
        execution._warm_timeline()
        execution.state.set("FINISHED")

    def _note_child_stats(self, execution, child, stats: dict) -> None:
        """Feed the child-reported rollup into the dispatch-side task map
        (one synthetic slot) so the stats surfaces cover forwarded
        queries."""
        if not stats:
            return
        execution._note_task_status(
            f"{execution.query_id}.0.proc{child['index']}.a0",
            {"state": "FINISHED", "stats": {
                "elapsedS": float(stats.get("elapsedMs", 0)) / 1e3,
                "deviceS": float(stats.get("deviceS", 0.0)),
                "completedSplits": int(stats.get("completedSplits", 0)),
                "totalSplits": int(stats.get("totalSplits", 0)),
                "inputRows": int(stats.get("totalRows", 0)),
                "outputRows": len(execution.rows),
                "outputBytes": int(stats.get("totalBytes", 0)),
                "peakBytes": int(stats.get("peakBytes", 0)),
                "spills": int(stats.get("spills", 0)),
                "operatorStats": [],
            }})

    def _pull_child_spans(self, execution, child, child_qid) -> None:
        """Merge the child's span tree into the dispatch-side execution
        (``extra_spans`` rides the trace endpoint and the phase ledger),
        so "where did the time go" answers across the process split."""
        import json

        from trino_tpu_torch.obs.trace import flatten_tree
        from trino_tpu_torch.server import wire

        if not child_qid:
            return
        try:
            status, body, _ = wire.http_request(
                "GET", f"{child['url']}/v1/query/{child_qid}/trace",
                timeout=5.0)
            if status >= 400:
                return
            tree = json.loads(body).get("root")
            execution.extra_spans = [
                {k: v for k, v in node.items() if k != "children"}
                for node in flatten_tree(tree)]
        except Exception:  # noqa: BLE001 — spans are observability
            pass

    def shutdown(self) -> None:
        """Close every child's stdin (EOF: a clean stop), wait 10 s for
        each, then terminate what is left."""
        self._stopped = True
        with self._boot_lock:
            children, self._children = self._children, []
        for ch in children:
            try:
                ch["proc"].stdin.close()
            except OSError:
                pass
        for ch in children:
            try:
                ch["proc"].wait(timeout=10.0)
            except Exception:  # noqa: BLE001 — escalate to terminate
                ch["proc"].terminate()
                ch["proc"].wait(timeout=10.0)
            if ch["proc"].stdout is not None:
                ch["proc"].stdout.close()


if __name__ == "__main__":
    executor_process_main()
