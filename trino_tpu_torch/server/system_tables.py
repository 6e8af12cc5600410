"""Coordinator feeds for the ``system`` catalog + the query-history ring
(the port of trino_tpu/server/system_tables.py).

Reference: ``core/trino-main/.../connector/system/`` — the coordinator-
state providers behind ``system.runtime.queries`` (``QuerySystemTable``
reading the DispatchManager/QueryTracker), ``system.runtime.tasks``
(``TaskSystemTable``), ``system.runtime.nodes`` (``NodeSystemTable``
reading the discovery registry) and the ``kill_query`` procedure
(``KillQueryProcedure``) — plus the bounded completed-query history of
``execution/QueryTracker`` (``query.max-history`` /
``query.min-expire-age``), which is what lets ``system.runtime.queries``
cover FINISHED/FAILED queries after their executions are pruned.

Locking contract (the tentpole's deadlock clause): every snapshot takes
the query-registry lock only to COPY the execution list, then builds rows
outside it — so ``SELECT * FROM system.runtime.queries`` issued while
that very query runs scans a consistent snapshot of itself without ever
nesting the registry lock under a per-query lock.

The process-wide ledgers (the flow ledger, the device profiler's compile
ring) reach the coordinator twice in a cluster whose workers share its
process: read directly, and in each worker's announce. ``cluster_rows``
counts each process once: announces name their process (``processId``),
the coordinator's own process is read directly and every other process
from its first announce. The reference keeps its rule ("announce rows win
for the ledger's node id"), which counts such a process once a server.
"""
from __future__ import annotations

import os
import socket
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

from trino_tpu_torch.connector import spi

# retention defaults (the query_max_history / query_min_expire_age_ms
# session properties override per recording query)
DEFAULT_MAX_HISTORY = 100
DEFAULT_MIN_EXPIRE_AGE_MS = 15_000


def process_id() -> str:
    """This process's identity in announces (host and pid)."""
    return f"{socket.gethostname()}:{os.getpid()}"


def cluster_rows(registry, key: str, own_rows: Callable[[], List[dict]],
                 own_node_id: str) -> List[tuple]:
    """``(node id, row)`` pairs of one process-wide ledger across the
    cluster, each process counted once: this process's rows from
    ``own_rows()`` under ``own_node_id``, every other process's from the
    first announce that carries ``key`` (workers sharing a process share
    the ledger)."""
    me = process_id()
    rows = [(own_node_id, r) for r in own_rows()]
    seen = {me}
    for n in registry.snapshot():
        info = n.get("info") or {}
        found = info.get(key)
        pid = info.get("processId")
        if found is None or pid in seen:
            continue
        if pid is not None:
            seen.add(pid)
        rows.extend((n["nodeId"], r) for r in found)
    return rows


def query_record(execution, state: Optional[str] = None,
                 ended_at: Optional[float] = None) -> dict:
    """One query's row-shaped record (live executions and history entries
    share this shape, so ``system.runtime.queries`` unions them
    uniformly). Reads only per-query state — never the registry lock."""
    stages = execution.stage_stats(include_operators=False)
    qs = execution.query_stats(stages)
    failure = (execution.failure or "").split("\n")[0] or None
    adaptations = len(execution.plan_versions)
    # phase-ledger rollups (obs/timeline.py): the three coarse buckets
    # plus the residual, NULL until the ledger exists (query terminal)
    tl = qs.get("timeline")
    queued_ms = planning_ms = execution_ms = unattributed_ms = None
    if tl is not None:
        ph = tl["phases"]
        # the dispatch-queue residency is queue time too (the bounded
        # queue of the dispatcher/executor split sits inside admission)
        queued_ms = (ph.get("queued", 0.0)
                     + ph.get("dispatch-queue", 0.0)) * 1000.0
        planning_ms = sum(ph.get(p, 0.0) for p in (
            "dispatch", "parse-analyze", "plan-optimize",
            "prepare-bind")) * 1000.0
        execution_ms = sum(ph.get(p, 0.0) for p in (
            "schedule", "device-staging", "device-execute",
            "exchange-wait", "result-serialization")) * 1000.0
        unattributed_ms = ph.get("unattributed", 0.0) * 1000.0
    return {
        "queryId": execution.query_id,
        "state": state or execution.state.get(),
        "user": execution.user,
        "query": execution.sql,
        "createdAt": float(execution.created_at),
        "endedAt": (float(ended_at) if ended_at is not None
                    else execution.ended_at),
        "elapsedMs": int(qs.get("elapsedMs", 0)),
        "deviceS": float(qs.get("deviceS", 0.0)),
        "totalSplits": int(qs.get("totalSplits", 0)),
        "completedSplits": int(qs.get("completedSplits", 0)),
        "inputRows": int(qs.get("totalRows", 0)),
        "outputBytes": int(qs.get("totalBytes", 0)),
        "peakBytes": int(qs.get("peakBytes", 0)),
        "shedBytes": int(qs.get("shedBytes", 0)),
        "yieldEvents": int(qs.get("yieldEvents", 0)),
        "resultRows": len(execution.rows),
        "cacheStatus": execution.cache_status,
        "adaptations": adaptations,
        # the initial plan is version 1; every adaptive change adds one
        "planVersions": adaptations + 1,
        "failure": failure,
        # control-plane path of the SELECT (server/fastpath.py):
        # fast-path | distributed | local-catalog; None otherwise
        "fastPath": execution.fast_path,
        "queuedMs": queued_ms,
        "planningMs": planning_ms,
        "executionMs": execution_ms,
        "unattributedMs": unattributed_ms,
        # the resource group that admitted the query (None under a
        # legacy injected gate) — history keeps the attribution after
        # the execution is pruned
        "resourceGroup": execution.resource_group,
    }


def _query_row(rec: dict) -> tuple:
    """Record dict -> system.runtime.queries row (column order must match
    connector/system/schemas.py)."""
    return (
        rec["queryId"], rec["state"], rec["user"], rec["query"],
        rec["createdAt"], rec["endedAt"], rec["elapsedMs"], rec["deviceS"],
        rec["totalSplits"], rec["completedSplits"], rec["inputRows"],
        rec["outputBytes"], rec["peakBytes"], rec.get("shedBytes", 0),
        rec.get("yieldEvents", 0), rec["resultRows"],
        rec["cacheStatus"], rec["adaptations"], rec["planVersions"],
        rec["failure"], rec.get("fastPath"),
        rec.get("queuedMs"), rec.get("planningMs"),
        rec.get("executionMs"), rec.get("unattributedMs"),
        rec.get("resourceGroup"),
    )


class QueryHistory:
    """Bounded ring of completed-query records (QueryTracker's
    ``expireQueries`` analog). Eviction honors BOTH retention knobs: the
    ring prunes to ``max_history`` but never evicts a record younger than
    ``min_expire_age_ms`` — a burst of short queries stays inspectable for
    at least that long; ``HARD_CAP`` bounds memory regardless."""

    HARD_CAP = 1000

    def __init__(self):
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def record(self, entry: dict,
               max_history: int = DEFAULT_MAX_HISTORY,
               min_expire_age_ms: int = DEFAULT_MIN_EXPIRE_AGE_MS) -> None:
        from trino_tpu_torch.obs import metrics as M

        now = time.time()
        evicted = 0
        with self._lock:
            self._entries[entry["queryId"]] = entry
            self._entries.move_to_end(entry["queryId"])
            while len(self._entries) > self.HARD_CAP:
                self._entries.popitem(last=False)
                evicted += 1
            while len(self._entries) > max(0, int(max_history)):
                _qid, oldest = next(iter(self._entries.items()))
                age_ms = (now - (oldest.get("endedAt") or now)) * 1000.0
                if age_ms < min_expire_age_ms:
                    break  # too young to expire; retry on a later record
                self._entries.popitem(last=False)
                evicted += 1
        if evicted:
            M.QUERY_HISTORY_EVICTIONS.inc(evicted)

    def snapshot(self) -> List[dict]:
        """Newest-first record list."""
        with self._lock:
            return list(reversed(self._entries.values()))


class CoordinatorSystemTables(spi.LiveTableProvider):
    """The coordinator's LiveTableProvider: materializes system-table rows
    from live server state at scan time and serves the ``kill_query``
    procedure through the existing administrative kill path."""

    def __init__(self, server):
        self._server = server

    # ------------------------------------------------------------- tables
    def snapshot_rows(self, schema: str, table: str) -> List[tuple]:
        if (schema, table) == ("runtime", "queries"):
            return self._queries_rows()
        if (schema, table) == ("runtime", "tasks"):
            return self._tasks_rows()
        if (schema, table) == ("runtime", "nodes"):
            return self._nodes_rows()
        if (schema, table) == ("runtime", "prepared_statements"):
            return self._prepared_rows()
        if (schema, table) == ("runtime", "serving"):
            return self._server.dispatcher.serving_rows()
        if (schema, table) == ("runtime", "resource_groups"):
            return self._resource_group_rows()
        if (schema, table) == ("runtime", "device_cache"):
            from trino_tpu_torch.connector.system.connector import device_cache_rows

            return device_cache_rows()
        if (schema, table) == ("runtime", "memory"):
            return self._memory_rows()
        if (schema, table) == ("runtime", "kernels"):
            return self._kernels_rows()
        if (schema, table) == ("runtime", "compiles"):
            return self._compiles_rows()
        if (schema, table) == ("runtime", "transfers"):
            return self._transfers_rows()
        if (schema, table) == ("runtime", "stragglers"):
            return self._stragglers_rows()
        if (schema, table) == ("metadata", "materialized_views"):
            return self._matview_rows()
        if (schema, table) == ("metrics", "metrics"):
            return self._metrics_rows()
        raise KeyError(f"system.{schema}.{table} does not exist")

    def _live_executions(self) -> List:
        # COPY under the registry lock, compute outside it (the deadlock /
        # torn-state contract in the module docstring)
        with self._server._qlock:
            return list(self._server.queries.values())

    def _queries_rows(self) -> List[tuple]:
        live = self._live_executions()
        rows = [_query_row(query_record(q)) for q in live]
        seen = {q.query_id for q in live}
        # completed queries whose executions were pruned from the registry
        # survive in the history ring (live records win: fresher stats)
        rows.extend(_query_row(rec) for rec in self._server.history.snapshot()
                    if rec["queryId"] not in seen)
        return rows

    def _tasks_rows(self) -> List[tuple]:
        rows = []
        for q in self._live_executions():
            for rec in q.task_records():
                s = rec.get("stats") or {}
                ops = s.get("operatorStats") or ()
                rows.append((
                    q.query_id, rec["taskId"], int(rec["fragment"]),
                    rec["state"], rec.get("workerUri"),
                    int(s.get("totalSplits", 0)),
                    int(s.get("completedSplits", 0)),
                    int(s.get("inputRows", 0)), int(s.get("outputRows", 0)),
                    int(s.get("outputBytes", 0)), int(s.get("peakBytes", 0)),
                    float(s.get("elapsedS", 0.0)),
                    float(s.get("deviceS", 0.0)), len(ops),
                ))
        return rows

    def _nodes_rows(self) -> List[tuple]:
        rows = []
        for n in self._server.registry.snapshot():
            info = n.get("info") or {}
            mem_limit = info.get("memoryLimit")
            dev_mem = info.get("deviceMemoryBytes")
            rows.append((
                n["nodeId"], n["url"], "active" if n["alive"] else "dead",
                info.get("version"), int(info.get("tasks", 0)),
                int(info.get("memoryBytes", 0)),
                int(mem_limit) if mem_limit is not None else None,
                int(dev_mem) if dev_mem is not None else None,
                int(info.get("deviceCacheBytes") or 0),
                int(n["ageS"] * 1000.0),
                int(info.get("hostCacheBytes") or 0),
                int(info.get("hostCacheHits") or 0),
                int(info.get("netBytesSent") or 0),
                int(info.get("netBytesReceived") or 0),
            ))
        return rows

    def _memory_rows(self) -> List[tuple]:
        """``system.runtime.memory``: the cluster memory ledger — one row
        per (node, pool, owner). Worker rows come from each node's newest
        announce payload (cluster_memory.memory_rows); the coordinator
        contributes its own process ledger directly (it never announces
        to itself). A worker ledger sharing this process (in-process test
        clusters stamp the global ledger with the worker's node id) is
        NOT double-reported: announce rows win for that node id."""
        from trino_tpu_torch.obs.memledger import MEMORY_LEDGER

        rows = []
        announced = set()
        for nid, row in self._server.cluster_memory.memory_rows():
            announced.add(nid)
            rows.append((
                nid, str(row.get("pool", "")), str(row.get("owner", "")),
                int(row.get("bytes", 0)), int(row.get("peakBytes", 0)),
                int(row.get("events", 0)),
            ))
        nid = MEMORY_LEDGER.node_id or "coordinator"
        if nid not in announced:
            rows.extend(
                (nid, r["pool"], r["owner"], int(r["bytes"]),
                 int(r["peakBytes"]), int(r["events"]))
                for r in MEMORY_LEDGER.owner_rows())
        return rows

    def _kernels_rows(self) -> List[tuple]:
        """``system.runtime.kernels``: the kernel ledger — one row per
        (query, plan node, operator, tier, node). Terminal queries read
        from the folded device-profiler store; RUNNING queries merge
        their live task rollups so the table never lags the engine."""
        from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER

        rows = []
        seen = set()
        for q in self._live_executions():
            if getattr(q, "_kernels_folded", False):
                continue  # folded rows below are fresher-complete
            for r in q.kernel_rows_live():
                seen.add(q.query_id)
                rows.append(self._kernel_row(r))
        rows.extend(self._kernel_row(r) for r in DEVICE_PROFILER.kernel_rows()
                    if r["queryId"] not in seen)
        return rows

    @staticmethod
    def _kernel_row(r: dict) -> tuple:
        return (
            str(r.get("queryId", "")), str(r.get("nodeId", "")),
            str(r.get("planNodeId", "")), str(r.get("operator", "")),
            str(r.get("tier", "")), int(r.get("launches", 0)),
            float(r.get("wallS", 0.0)), float(r.get("deviceS", 0.0)),
            float(r.get("dispatchOverheadS",
                        max(0.0, float(r.get("wallS", 0.0))
                            - float(r.get("deviceS", 0.0))))),
            int(r.get("inputBytes", 0)), int(r.get("outputBytes", 0)),
            bool(r.get("estimated", False)),
        )

    def _compiles_rows(self) -> List[tuple]:
        """``system.runtime.compiles``: the compile ledger — one row per
        compile event (a graph capture or replay), cluster-wide. Worker
        rows ride the announce payload (``compileEvents``); the
        coordinator contributes its own process ring directly; each
        process once (``cluster_rows``)."""
        from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER

        return [self._compile_row(nid, e) for nid, e in cluster_rows(
            self._server.registry, "compileEvents", DEVICE_PROFILER.compile_rows,
            DEVICE_PROFILER.node_id or "coordinator")]

    @staticmethod
    def _compile_row(nid: str, e: dict) -> tuple:
        return (
            str(e.get("nodeId") or nid), str(e.get("queryId", "")),
            str(e.get("tier", "")), str(e.get("fingerprint", "")),
            str(e.get("shapeSig", "")), float(e.get("compileS", 0.0)),
            str(e.get("cache", "")), float(e.get("ts", 0.0)),
        )

    def _transfers_rows(self) -> List[tuple]:
        """``system.runtime.transfers``: the flow ledger — one row per
        (node, link, owner) transfer rollup, cluster-wide. Worker rows
        ride the announce payload (``flows``); the coordinator
        contributes its own process ledger directly; each process once
        (``cluster_rows``)."""
        from trino_tpu_torch.obs.flowledger import FLOW_LEDGER

        return [self._transfer_row(nid, r) for nid, r in cluster_rows(
            self._server.registry, "flows", FLOW_LEDGER.transfer_rows,
            FLOW_LEDGER.node_id or "coordinator")]

    @staticmethod
    def _transfer_row(nid: str, r: dict) -> tuple:
        return (
            nid, str(r.get("link", "")), str(r.get("owner", "")),
            int(r.get("bytes", 0)), int(r.get("pages", 0)),
            int(r.get("transfers", 0)), float(r.get("seconds", 0.0)),
            (float(r["mbPerS"]) if r.get("mbPerS") is not None else None),
            int(r.get("retries", 0)),
            (str(r["lastStatus"]) if r.get("lastStatus") is not None
             else None),
        )

    def _stragglers_rows(self) -> List[tuple]:
        """``system.runtime.stragglers``: one row per flagged task across
        the live query registry — frozen verdicts for terminal queries,
        live detection for RUNNING ones (QueryExecution.straggler_rows
        makes that split)."""
        rows = []
        for q in self._live_executions():
            for f in q.straggler_rows():
                stage = f.get("stageId")
                rows.append((
                    q.query_id,
                    int(stage) if stage is not None else None,
                    f.get("taskId"), f.get("workerUri"),
                    float(f.get("elapsedS", 0.0)),
                    float(f.get("stageMedianS", 0.0)),
                    float(f.get("ratio", 0.0)),
                    float(f.get("multiple", 0.0)),
                    str(f.get("cause", "")),
                    int(f.get("completedSplits", 0)),
                ))
        return rows

    def _resource_group_rows(self) -> List[tuple]:
        """``system.runtime.resource_groups``: one row per live group
        node of the admission tree (empty under a legacy injected flat
        gate — the table only describes group-aware admission)."""
        groups = getattr(self._server, "resource_groups", None)
        if groups is None:
            return []
        return groups.table_rows()

    def _prepared_rows(self) -> List[tuple]:
        return [
            (e.user, e.name, e.sql, int(e.param_count),
             float(e.created_at), int(e.executions),
             float(e.last_executed_at)
             if e.last_executed_at is not None else None)
            for e in self._server.prepared.snapshot()
        ]

    def _matview_rows(self) -> List[tuple]:
        """``system.metadata.materialized_views``: every registered view
        with its freshness recomputed against the connectors' CURRENT
        data versions at scan time — the table never shows a cached
        verdict."""
        from trino_tpu_torch.matview.substitute import staleness_reason

        rows = []
        for mv in self._server.matviews.snapshot():
            reason = staleness_reason(self._server.catalogs, mv)
            base = ", ".join(
                f"{c}.{s}.{t}@{v}" for (c, s, t), v in
                (mv.base_versions or ()))
            rows.append((
                mv.catalog, mv.schema, mv.name, mv.owner,
                mv.definition_sql, mv.storage_qualified,
                reason is None, reason,
                float(mv.last_refresh) if mv.last_refresh else None,
                base or None, int(mv.hits), int(mv.refreshes),
            ))
        return rows

    def _metrics_rows(self) -> List[tuple]:
        from trino_tpu_torch.connector.system.connector import metric_sample_rows
        from trino_tpu_torch.server.events import refreshed_server_gauges

        with refreshed_server_gauges(self._server):
            return metric_sample_rows()

    # --------------------------------------------------------- procedures
    def procedure(self, schema: str, name: str):
        if (schema, name) == ("runtime", "kill_query"):
            return self._kill_query
        if (schema, name) == ("runtime", "sync_materialized_view"):
            return self._sync_materialized_view
        return None

    def _sync_materialized_view(self, session, payload_b64,
                                signature=None) -> str:
        """CALL system.runtime.sync_materialized_view(b64_json, hmac):
        apply one materialized-view registry replication payload — how
        the dispatch process keeps executor-process replicas in step
        with its authoritative registry after CREATE/REFRESH/DROP (the
        prepared-statement broadcast analog, carried as data instead of
        replayed SQL so children never re-execute a refresh). The
        payload must be HMAC-signed with the cluster-internal secret
        (server/wire.py — the same trust root every internal endpoint
        verifies): an ordinary client cannot inject registry entries,
        which would otherwise launder access control through a forged
        storage-table pointer."""
        import base64
        import json

        from trino_tpu_torch.matview.lifecycle import sync_from_payload
        from trino_tpu_torch.server import wire

        blob = str(payload_b64)
        if not wire.verify(blob.encode(), str(signature)
                           if signature is not None else None):
            from trino_tpu_torch.server.security import AccessDeniedError

            raise AccessDeniedError(
                "sync_materialized_view: bad internal signature — this "
                "procedure is the executor-plane replication channel, "
                "not a user surface")
        payload = json.loads(base64.b64decode(blob))
        return sync_from_payload(self._server.matviews, payload)

    def _kill_query(self, session, query_id, reason=None) -> str:
        """CALL system.runtime.kill_query(query_id, reason): FAIL the named
        query with the supplied reason through the administrative kill
        path (reference: KillQueryProcedure -> DispatchManager.failQuery).
        Refuses self-kill (the calling query's own id) and — when end-user
        authentication is enforced — killing another user's query."""
        query_id = str(query_id)
        if query_id == getattr(session, "query_id", None):
            raise ValueError(
                "kill_query cannot kill the query that invoked it")
        q = self._server.get_query(query_id)
        if q is None:
            raise ValueError(f"kill_query: query not found: {query_id}")
        auth = getattr(self._server, "authenticator", None)
        if auth is not None and auth.required:
            from trino_tpu_torch.server.security import AccessDeniedError

            user = getattr(getattr(session, "identity", None), "user", None)
            if q.user != user:
                raise AccessDeniedError(
                    "Access Denied: query belongs to another user")
        if q.state.is_terminal():
            return f"query {query_id} is already {q.state.get()}"
        q.kill(str(reason) if reason is not None
               else "Killed via system.runtime.kill_query")
        return f"killed {query_id}"
