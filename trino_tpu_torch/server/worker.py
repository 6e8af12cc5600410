"""Worker server: task CRUD + result streaming over HTTP.

The port of trino_tpu/server/worker.py (reference:
``server/TaskResource.java``): ``POST /v1/task/{taskId}`` creates a task,
``GET /v1/task/{taskId}/results/{bufferId}/{token}`` streams its pages,
``GET /v1/task/{taskId}/status`` reports it, ``GET /v1/task/{taskId}/spans``
returns its spans (the coordinator merges them into the query's trace),
``DELETE`` acknowledges a buffer or cancels the task,
``GET /v1/segment/{id}`` serves a spooled result segment (whole, or a
``Range`` of it: 200, 206 or 416) and ``DELETE`` is the client's ack
(segment routes take no cluster HMAC: the id is the capability),
``GET /v1/task/{taskId}/recorder`` returns the process's flight-recorder
ring and memory- and flow-ledger snapshots (for a FAILED query's
postmortem), ``GET /v1/metrics`` the Prometheus page, ``GET /v1/info``
lists the tasks; and the announce loop that registers the worker with its
coordinator.

Each announce carries the worker's memory: its live per-query
reservations (``TaskManager.query_memory``) against its pool
(``memory_limit_bytes``, or ``TRINO_TPU_WORKER_MEMORY_BYTES``), the
card's capacity and the device and host caches' bytes; the coordinator's
cluster memory manager kills the largest query of a worker over its pool.
It also carries the device profiler's newest compile events and the flow
ledger's per-link rollups, stall rollups and byte totals, which
``system.runtime.compiles``, ``transfers`` and ``nodes`` read; with
``TRINO_TPU_OTLP_ENDPOINT`` set, each finished task's spans go to that
OTLP collector.
Before that, the announce sheds the device cache (the revocable tier)
when the queries and the warm tables together overflow the pool, and
both cache tiers, host first, when the process's RSS crosses
``TRINO_TPU_HOST_MEMORY_LIMIT_BYTES``.

A worker runs its tasks on one torch device: CUDA unless it is given
another (``device="cpu"`` in the tests); asked for CUDA without a usable
GPU it raises. Its segment store (server/segments.py) holds the result
segments its tasks write under the spooled result protocol; the announce
loop sweeps it for expired segments, and a stop deletes what it holds.

    python -m trino_tpu_torch.server.worker --coordinator URL [--port N]
        [--node-id ID] [--device cuda|cpu]

prints ``{"nodeId": ..., "url": ...}`` once it serves.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Optional

from trino_tpu_torch.obs import otlp
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER
from trino_tpu_torch.obs.flightrecorder import FlightRecorder
from trino_tpu_torch.obs.flowledger import FLOW_LEDGER
from trino_tpu_torch.obs.memledger import MEMORY_LEDGER, TOTAL_OWNER
from trino_tpu_torch.server import wire
from trino_tpu_torch.server.segments import SegmentStore, segment_response
from trino_tpu_torch.server.system_tables import process_id
from trino_tpu_torch.server.task import TaskManager, TaskRequest

_RESULTS_RE = re.compile(r"^/v1/task/([^/]+)/results/(\d+)/(\d+)$")
_TASK_RE = re.compile(r"^/v1/task/([^/]+)$")
_STATUS_RE = re.compile(r"^/v1/task/([^/]+)/status$")
_SPANS_RE = re.compile(r"^/v1/task/([^/]+)/spans$")
_RECORDER_RE = re.compile(r"^/v1/task/([^/]+)/recorder$")
_SEGMENT_RE = re.compile(r"^/v1/segment/([^/]+)$")


def resolve_device(device=None):
    """The torch device a server runs on: CUDA unless named; CUDA without
    a usable GPU raises."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run on the CPU)")
    return dev


def shared_catalog_session_factory(device=None):
    """Session factory bound to one catalog map and routine store for the
    whole process, on ``device``: memory-catalog writes and CREATE
    FUNCTION persist across tasks and statements."""
    from trino_tpu_torch.connector.registry import default_catalogs

    device = resolve_device(device)
    catalogs = default_catalogs()
    udfs: dict = {}

    def factory(properties):
        from trino_tpu_torch.client.session import Session

        return Session(properties, device=device, catalogs=catalogs, udfs=udfs)

    return factory


class WorkerServer:
    """One worker: task manager + HTTP endpoint + announcer."""

    ANNOUNCE_INTERVAL_S = 0.5

    def __init__(self, port: int = 0, coordinator_url: Optional[str] = None,
                 node_id: Optional[str] = None, session_factory=None,
                 memory_limit_bytes: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.node_id = node_id or f"worker-{time.time_ns() & 0xFFFFFF:x}"
        # this worker's flight recorder; the process device profiler,
        # memory ledger and flow ledger take the first server's identity
        # (in-process test clusters share them, as the metrics) and mirror
        # their events into the recorder
        self.recorder = FlightRecorder(node_id=self.node_id)
        for ledger in (DEVICE_PROFILER, MEMORY_LEDGER, FLOW_LEDGER):
            if not ledger.node_id:
                ledger.node_id = self.node_id
            ledger.attach_recorder(self.recorder)
        # OTLP export, on only when TRINO_TPU_OTLP_ENDPOINT is set: each
        # finished task ships its spans under the query's propagated trace
        # id, so they parent into the coordinator's trace in the collector
        self.otlp = otlp.exporter_from_env("trino-tpu-worker", instance_id=self.node_id)
        # spooled result segments: result-producing tasks write here and
        # clients fetch them from GET /v1/segment/{id} (the worker is the
        # data plane; the coordinator never relays them)
        self.segments = SegmentStore(node_id=self.node_id)
        self.tasks = TaskManager(session_factory or shared_catalog_session_factory(self.device),
                                 recorder=self.recorder, otlp=self.otlp,
                                 segment_store=self.segments)
        self.coordinator_url = coordinator_url
        # the worker's memory pool (None = unlimited) and its optional
        # host-RAM ceiling
        env_limit = os.environ.get("TRINO_TPU_WORKER_MEMORY_BYTES")
        self.memory_limit_bytes = (memory_limit_bytes if memory_limit_bytes is not None
                                   else int(env_limit) if env_limit else None)
        env_host = os.environ.get("TRINO_TPU_HOST_MEMORY_LIMIT_BYTES")
        self.host_memory_limit_bytes = int(env_host) if env_host else None
        self.httpd = wire.ServerHTTP(("127.0.0.1", port), _make_handler(self))
        self.port = self.httpd.server_address[1]
        self.base_url = f"http://127.0.0.1:{self.port}"
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._announce_thread = threading.Thread(target=self._announce_loop, daemon=True)
        self._stop = threading.Event()

    def start(self) -> None:
        self._serve_thread.start()
        if self.coordinator_url:
            self._announce_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.segments.close()
        if self.otlp is not None:
            # flush and stop the exporter: a stopped worker reports nothing
            self.otlp.shutdown()

    def _announce_loop(self) -> None:
        """Periodic announce: discovery and liveness in one (the worker
        pushes, the coordinator ages entries out)."""
        while not self._stop.is_set():
            try:
                # the segments' TTL sweep rides the announce cadence
                # (rate-limited inside the store)
                self.segments.maybe_sweep()
            except Exception:  # noqa: BLE001 — the lifecycle is best-effort
                pass
            try:
                wire.json_request(
                    "PUT", f"{self.coordinator_url}/v1/announce/{self.node_id}",
                    self.announce_payload(), timeout=5.0)
            except Exception:  # noqa: BLE001 — the coordinator may not be up yet
                pass
            self._stop.wait(self.ANNOUNCE_INTERVAL_S)

    def announce_payload(self) -> dict:
        """One announce tick: relieve memory pressure, sample the memory
        ledger, and the payload (discovery, the memory fields the
        coordinator's ClusterMemoryManager reads, one device-profiler
        utilization sample since the last tick and the newest compile
        events, and the flow ledger's rollups and byte totals)."""
        from trino_tpu_torch import __version__, devcache
        from trino_tpu_torch.obs import metrics as M

        qmem = self.tasks.query_memory()
        if self.memory_limit_bytes is not None:
            # the device cache is the pool's revocable tier: when queries
            # and warm tables together overflow the pool it yields first,
            # before the coordinator's killer would consider a query. Only
            # in the band where the cache is the overflow (the queries alone
            # fit): reservations are projected peaks, and a spilling join's
            # own per-pass yield (exec/memory.py) handles the rest
            q_total = sum(qmem.values())
            over = q_total + devcache.DEVICE_CACHE.cached_bytes() - self.memory_limit_bytes
            if over > 0 and q_total < self.memory_limit_bytes:
                devcache.DEVICE_CACHE.yield_bytes(over, reason="pool-overflow")
        # host RAM is a separate budget: the current RSS over the node's
        # limit sheds host pages before device ones (no reading, no shed)
        rss = M.current_rss_bytes()
        if self.host_memory_limit_bytes is not None and rss is not None:
            over_host = rss - self.host_memory_limit_bytes
            if over_host > 0:
                devcache.shed_revocable(over_host)
        mem_rows = self._sample_memory(qmem, rss)
        M.refresh_process_gauges()
        net = FLOW_LEDGER.net_totals()
        return {
            "url": self.base_url, "tasks": len(self.tasks.list_info()),
            "device": str(self.device),
            # per-query live reservations against this worker's pool
            "queryMemory": qmem,
            "memoryBytes": sum(qmem.values()),
            "memoryLimit": self.memory_limit_bytes,
            # the card's capacity and the revocable tiers' occupancy
            "deviceMemoryBytes": devcache.device_memory_bytes(),
            "deviceCacheBytes": devcache.DEVICE_CACHE.cached_bytes(),
            "hostCacheBytes": devcache.HOST_CACHE.cached_bytes(),
            "hostCacheHits": devcache.HOST_CACHE.hit_count(),
            # per-pool, per-owner attribution rows of the memory ledger
            "memoryOwners": mem_rows,
            "rssBytes": rss,
            "profiler": DEVICE_PROFILER.sample_utilization(),
            # system.runtime.compiles' rows of this node
            "compileEvents": DEVICE_PROFILER.compile_rows(limit=64),
            # system.runtime.transfers' rows of this node, its stall
            # rollups (the /flows route) and its byte totals (nodes)
            "flows": FLOW_LEDGER.transfer_rows(),
            "flowStalls": FLOW_LEDGER.stall_rows(),
            "netBytesSent": net["sent"],
            "netBytesReceived": net["received"],
            "version": __version__,
            # the process whose ledgers these are: workers sharing a
            # process share them, and the coordinator counts it once
            "processId": process_id(),
        }

    def _sample_memory(self, qmem: dict, rss: Optional[int]) -> list:
        """Sync the ledger's live per-owner bytes from their ground-truth
        sources (task reservations, cache occupancy), sample the per-pool
        watermarks, set the pool gauges, and return the per-owner rows the
        announce ships (``memoryOwners``)."""
        from trino_tpu_torch import devcache
        from trino_tpu_torch.obs import metrics as M

        dev_owners = {f"query:{q}": int(b) for q, b in qmem.items()}
        dev_owners["device-cache"] = devcache.DEVICE_CACHE.cached_bytes()
        host_owners = {"host-cache": devcache.HOST_CACHE.cached_bytes()}
        # transient owners the sources above cannot see (staging scratch)
        # come from the ledger's event-driven live bytes
        for row in MEMORY_LEDGER.owner_rows():
            owners = dev_owners if row["pool"] == "device" else host_owners
            if (row["owner"] != TOTAL_OWNER and not row["owner"].startswith("query:")
                    and row["owner"] not in owners and row["bytes"] > 0):
                owners[row["owner"]] = row["bytes"]
        MEMORY_LEDGER.sync_pool("device", dev_owners, prefix="query:")
        MEMORY_LEDGER.sync_pool("host", host_owners)
        totals = {"device": sum(dev_owners.values()), "host": sum(host_owners.values())}
        MEMORY_LEDGER.sample_watermarks(totals, rss_bytes=rss,
                                        device_total_bytes=devcache.device_memory_bytes())
        for pool, total in totals.items():
            M.MEMORY_POOL_BYTES.set(total, pool, self.node_id)
        ledger = {(r["pool"], r["owner"]): r for r in MEMORY_LEDGER.owner_rows()}
        rows = []
        for pool, owners in (("device", dev_owners), ("host", host_owners)):
            for owner, nbytes in sorted(owners.items()) + [(TOTAL_OWNER, totals[pool])]:
                lr = ledger.get((pool, owner), {})
                rows.append({"pool": pool, "owner": owner, "bytes": int(nbytes),
                             "peakBytes": max(int(lr.get("peakBytes", 0)), int(nbytes)),
                             "events": int(lr.get("events", 0))})
        return rows


def _make_handler(server: WorkerServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 30  # idle keep-alive connections close after this
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

        def _authorized(self) -> bool:
            """Every /v1/task route carries the cluster's HMAC of its body
            (empty for GET and DELETE)."""
            if wire.verify(b"", self.headers.get(wire.H_INTERNAL_AUTH)):
                return True
            self._send(401, b'{"error": "bad internal signature"}')
            return False

        def do_POST(self):
            m = _TASK_RE.match(self.path)
            if m:
                body = self._read_body()
                if not wire.verify(body, self.headers.get(wire.H_INTERNAL_AUTH)):
                    self._send(401, b'{"error": "bad internal signature"}')
                    return
                # the coordinator's schedule span rides in on the traceparent
                # header: the task's spans parent into the query's trace
                task = server.tasks.create_task(
                    TaskRequest.from_bytes(body),
                    traceparent=self.headers.get(tracing.TRACEPARENT_HEADER))
                self._send(200, json.dumps(task.info()).encode())
                return
            self._send(404)

        def do_GET(self):
            m = _SEGMENT_RE.match(self.path)
            if m:
                # no cluster HMAC: the unguessable id is the capability and
                # the caller a protocol client (pre-signed segment URIs)
                status, body, headers, ctype = segment_response(
                    server.segments, m.group(1), self.headers.get("Range"))
                self._send(status, body, ctype, headers)
                return
            m = _RESULTS_RE.match(self.path)
            if m:
                if not self._authorized():
                    return
                task = server.tasks.get(m.group(1))
                if task is None:
                    self._send(404, b'{"error": "no such task"}')
                    return
                pages, next_token, complete, failure = task.output.poll(
                    int(m.group(3)), buffer_id=int(m.group(2)))
                headers = {
                    wire.H_PAGE_TOKEN: m.group(3),
                    wire.H_NEXT_TOKEN: str(next_token),
                    wire.H_BUFFER_COMPLETE: "true" if complete else "false",
                }
                if failure:
                    headers[wire.H_TASK_FAILED] = failure.replace("\n", " ")[:900]
                self._send(200, wire.frame_pages(pages), wire.MEDIA_PAGES, headers)
                return
            m = _STATUS_RE.match(self.path)
            if m:
                if not self._authorized():
                    return
                task = server.tasks.get(m.group(1))
                if task is None:
                    self._send(404, b'{"error": "no such task"}')
                    return
                self._send(200, json.dumps(task.info()).encode())
                return
            m = _SPANS_RE.match(self.path)
            if m:
                if not self._authorized():
                    return
                task = server.tasks.get(m.group(1))
                if task is None:
                    self._send(404, b'{"error": "no such task"}')
                    return
                self._send(200, json.dumps({"taskId": task.request.task_id,
                                            "traceId": task.tracer.trace_id,
                                            "spans": task.tracer.to_dicts()}).encode())
                return
            m = _RECORDER_RE.match(self.path)
            if m:
                if not self._authorized():
                    return
                # the process's ring, not the task's: a postmortem wants
                # the context around the failure, and it still answers
                # after the task was pruned
                self._send(200, json.dumps({
                    "nodeId": server.node_id, "taskId": m.group(1),
                    "taskKnown": server.tasks.get(m.group(1)) is not None,
                    "records": server.recorder.snapshot(),
                    "memory": MEMORY_LEDGER.memory_snapshot(),
                    "flows": FLOW_LEDGER.flow_snapshot()}).encode())
                return
            if self.path == "/v1/metrics":
                from trino_tpu_torch.obs.metrics import render_registry

                self._send(200, render_registry().encode(), "text/plain; version=0.0.4")
                return
            if self.path == "/v1/info":
                self._send(200, json.dumps(
                    {"nodeId": server.node_id, "state": "ACTIVE", "device": str(server.device),
                     "tasks": server.tasks.list_info()}).encode())
                return
            self._send(404)

        def do_DELETE(self):
            m = _SEGMENT_RE.match(self.path)
            if m:
                # the client's ack: the segment was fetched, delete it now
                # rather than at its TTL (a repeated ack is still a 204)
                server.segments.ack(m.group(1))
                self._send(204)
                return
            m = _RESULTS_RE.match(self.path)
            if m:
                if not self._authorized():
                    return
                # final ack: this consumer is done with the buffer
                task = server.tasks.get(m.group(1))
                if task is not None:
                    task.output.destroy_consumer(int(m.group(2)))
                self._send(204)
                return
            m = _TASK_RE.match(self.path)
            if m:
                if not self._authorized():
                    return
                server.tasks.cancel(m.group(1))
                self._send(204)
                return
            self._send(404)

    return Handler


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--node-id", default=None)
    ap.add_argument("--device", default=None, help="torch device (default cuda)")
    args = ap.parse_args(argv)
    w = WorkerServer(args.port, args.coordinator, args.node_id, device=args.device)
    w.start()
    print(json.dumps({"nodeId": w.node_id, "url": w.base_url}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        w.stop()


if __name__ == "__main__":
    main()
