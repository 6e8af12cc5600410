"""Failure flight recorder: a bounded per-process ring of recent records (a
copy of trino_tpu/obs/flightrecorder.py).

Reference role: the post-hoc context the reference engine scatters across
coordinator logs, ``QueryInfo.failureInfo`` and per-task diagnostics —
collapsed into one always-on, bounded, in-memory ring per process
(coordinator AND every worker). The ring holds the last N span / event /
admission records regardless of which query produced them, so when a
query FAILS or times out the postmortem shows the PROCESS context around
the failure (what else was running, what the admission gate did, which
task spans closed last) — exactly what a chaos run's kill-a-worker
scenario needs and what a span tree scoped to the dead query cannot show.

On query FAILED the coordinator snapshots its own ring and pulls each
involved worker's ring (``GET /v1/task/{id}/recorder``), merging them
into one postmortem attached to ``GET /v1/query/{id}/trace?recorder=1``,
to ``QueryCompletedEvent.postmortem`` (which the JSONL query log
persists, trimmed), and kept on the execution for later inspection.

Recording is O(1) append under a short lock — safe on the hot path.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

DEFAULT_CAPACITY = 512

# records shipped per node inside a JSONL query-log line (the full rings
# stay available on the live endpoints; the durable log keeps the tail)
LOG_RECORDS_PER_NODE = 64


class FlightRecorder:
    """One process's ring. Records are plain dicts:
    ``{"ts", "kind": "span"|"event"|"admission", "name", ...}``."""

    def __init__(self, node_id: str = "", capacity: int = DEFAULT_CAPACITY):
        self.node_id = node_id
        self._ring: "deque[dict]" = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, kind: str, name: str, **attrs) -> None:
        rec = {"ts": time.time(), "kind": kind, "name": name}
        rec.update(attrs)
        with self._lock:
            self._ring.append(rec)

    def record_span(self, span_dict: dict, trace_id: str) -> None:
        """One closed span (obs/trace hooks this into ``Tracer.end_span``
        via ``tracer.recorder``)."""
        with self._lock:
            self._ring.append({
                "ts": span_dict.get("start"),
                "kind": "span",
                "name": span_dict.get("name"),
                "traceId": trace_id,
                "spanId": span_dict.get("spanId"),
                "durationS": span_dict.get("durationS"),
                "attributes": span_dict.get("attributes") or {},
            })

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """Oldest-first copy of the ring (optionally only the newest
        ``limit`` records)."""
        with self._lock:
            records = list(self._ring)
        if limit is not None and len(records) > limit:
            records = records[-limit:]
        return records

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def pull_worker_rings(locations, timeout: float = 3.0,
                      pool=None) -> List[dict]:
    """Fetch the flight-recorder ring of every distinct worker involved
    in a query. ``locations`` are exchange-client ``TaskLocation``s (one
    representative task id per worker base url is enough — the endpoint
    returns the PROCESS ring). A gone worker contributes an error stub
    instead of sinking the postmortem; fetches run in parallel on the
    server's shared IO ``pool`` when given (serially otherwise — callers
    on the hot path always pass the pool; the per-call executor this
    replaced churned a fresh thread pool per capture)."""
    import json

    from trino_tpu_torch.server import wire

    by_url = {}
    for loc in locations:
        if loc is not None:
            by_url.setdefault(loc.base_url, loc.task_id)
    if not by_url:
        return []

    def fetch(item):
        url, task_id = item
        try:
            status, body, _ = wire.http_request(
                "GET", f"{url}/v1/task/{task_id}/recorder", timeout=timeout)
            if status < 400:
                payload = json.loads(body)
                return {"url": url, "nodeId": payload.get("nodeId"),
                        "records": payload.get("records", []),
                        # memory-ledger snapshot rides the same pull so a
                        # postmortem names each node's top consumers
                        "memory": payload.get("memory"),
                        # flow-ledger snapshot rides along too: per-link
                        # rollups + the node's last transfers/stalls
                        "flows": payload.get("flows")}
            return {"url": url, "error": f"status {status}"}
        except Exception as e:  # noqa: BLE001 — a dead worker IS the story
            return {"url": url, "error": str(e)[:300]}

    items = sorted(by_url.items())
    if pool is not None:
        try:
            return list(pool.map(fetch, items))
        except RuntimeError:  # pool already shut down: fall through
            pass
    return [fetch(item) for item in items]


def trim_postmortem(postmortem: Optional[dict],
                    per_node: int = LOG_RECORDS_PER_NODE) -> Optional[dict]:
    """A bounded copy for the durable JSONL query log: keep each node's
    newest ``per_node`` records and note how many were cut."""
    if postmortem is None:
        return None

    def trim_node(node: dict) -> dict:
        out = {k: v for k, v in node.items() if k != "records"}
        records = node.get("records")
        if records is not None:
            out["records"] = records[-per_node:]
            if len(records) > per_node:
                out["truncated"] = len(records) - per_node
        return out

    out = {k: v for k, v in postmortem.items()
           if k not in ("coordinator", "workers")}
    if "coordinator" in postmortem:
        out["coordinator"] = trim_node(postmortem["coordinator"])
    if "workers" in postmortem:
        out["workers"] = [trim_node(w) for w in postmortem["workers"]]
    return out
