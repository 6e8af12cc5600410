"""Worker server: task CRUD + result streaming over HTTP.

The port of trino_tpu/server/worker.py (reference:
``server/TaskResource.java``): ``POST /v1/task/{taskId}`` creates a task,
``GET /v1/task/{taskId}/results/{bufferId}/{token}`` streams its pages,
``GET /v1/task/{taskId}/status`` reports it, ``DELETE`` acknowledges a
buffer or cancels the task, ``GET /v1/info`` lists the tasks; and the
announce loop that registers the worker with its coordinator.

A worker runs its tasks on one torch device: CUDA unless it is given
another (``device="cpu"`` in the tests); asked for CUDA without a usable
GPU it raises. The reference's spooled result segments
(``/v1/segment/{id}``) answer 501 Not Implemented.

    python -m trino_tpu_torch.server.worker --coordinator URL [--port N]
        [--node-id ID] [--device cuda|cpu]

prints ``{"nodeId": ..., "url": ...}`` once it serves.
"""
from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER
from trino_tpu_torch.server import wire
from trino_tpu_torch.server.task import TaskManager, TaskRequest

_RESULTS_RE = re.compile(r"^/v1/task/([^/]+)/results/(\d+)/(\d+)$")
_TASK_RE = re.compile(r"^/v1/task/([^/]+)$")
_STATUS_RE = re.compile(r"^/v1/task/([^/]+)/status$")
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
                 node_id: Optional[str] = None, session_factory=None, device=None):
        self.device = resolve_device(device)
        self.node_id = node_id or f"worker-{time.time_ns() & 0xFFFFFF:x}"
        # the process device profiler takes the first server's identity
        # (in-process test clusters share one profiler, as the metrics)
        if not DEVICE_PROFILER.node_id:
            DEVICE_PROFILER.node_id = self.node_id
        self.tasks = TaskManager(session_factory or shared_catalog_session_factory(self.device))
        self.coordinator_url = coordinator_url
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(self))
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

    def _announce_loop(self) -> None:
        """Periodic announce: discovery and liveness in one (the worker
        pushes, the coordinator ages entries out). Each tick takes one
        device-profiler utilization sample (launches/sec and busy share
        since the last tick) and carries it."""
        while not self._stop.is_set():
            try:
                wire.json_request(
                    "PUT", f"{self.coordinator_url}/v1/announce/{self.node_id}",
                    {"url": self.base_url, "tasks": len(self.tasks.list_info()),
                     "device": str(self.device),
                     "profiler": DEVICE_PROFILER.sample_utilization()},
                    timeout=5.0)
            except Exception:  # noqa: BLE001 — the coordinator may not be up yet
                pass
            self._stop.wait(self.ANNOUNCE_INTERVAL_S)


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

        def _not_ported(self) -> bool:
            if _SEGMENT_RE.match(self.path):
                self._send(501, b'{"error": "spooled result segments are not ported"}')
                return True
            return False

        def do_POST(self):
            m = _TASK_RE.match(self.path)
            if m:
                body = self._read_body()
                if not wire.verify(body, self.headers.get(wire.H_INTERNAL_AUTH)):
                    self._send(401, b'{"error": "bad internal signature"}')
                    return
                task = server.tasks.create_task(TaskRequest.from_bytes(body))
                self._send(200, json.dumps(task.info()).encode())
                return
            self._send(404)

        def do_GET(self):
            if self._not_ported():
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
            if self.path == "/v1/info":
                self._send(200, json.dumps(
                    {"nodeId": server.node_id, "state": "ACTIVE", "device": str(server.device),
                     "tasks": server.tasks.list_info()}).encode())
                return
            self._send(404)

        def do_DELETE(self):
            if self._not_ported():
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
