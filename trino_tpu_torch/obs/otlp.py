"""OTLP-JSON export over HTTP: traces + metric snapshots to a collector
(a copy of trino_tpu/obs/otlp.py).

Reference: the reference engine's OpenTelemetry wiring — an
``io.opentelemetry.api.trace.Tracer`` injected through
``QueuedStatementResource``/``DispatchManager``/``SqlTaskManager`` whose
spans a standard OTLP exporter ships to any collector. Here the engine's
in-process span records (obs/trace.py) are translated to the OTLP-JSON
wire shape (``resourceSpans``/``scopeSpans``; the OTLP/HTTP JSON encoding)
and POSTed to ``TRINO_TPU_OTLP_ENDPOINT`` by a background batch exporter,
so traces land in Jaeger/Tempo/any otel collector without new deps.

Contract (the never-block-the-hot-path clause):

- OFF unless ``TRINO_TPU_OTLP_ENDPOINT`` is set at server construction;
- ``export_spans``/``export_metrics_snapshot`` enqueue onto a BOUNDED
  queue and return immediately — overflow DROPS the batch and bumps
  ``trino_tpu_otlp_dropped_total{reason="overflow"}``;
- the background thread drains batches and POSTs with a short timeout;
  an unreachable/non-2xx collector drops (``reason="send-error"``) and
  the engine never notices.

Trace/span ids are already OTLP-shaped (32/16 lowercase hex — see
``trace._hex_id``), so worker task spans exported with the PROPAGATED
trace id parent into the coordinator's trace inside the collector, the
same cross-process tree ``GET /v1/query/{id}/trace`` assembles locally.

``StubCollector`` is the in-process receiving half used by the tier-1
smoke test (and handy for local development): a tiny HTTP server that
stores every posted payload.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

ENDPOINT_ENV = "TRINO_TPU_OTLP_ENDPOINT"
DEFAULT_QUEUE_MAX = 256  # batches (one batch = one query's / task's spans)


def exporter_from_env(service_name: str,
                      instance_id: Optional[str] = None):
    """The server-construction hook: an exporter when
    ``TRINO_TPU_OTLP_ENDPOINT`` is set, else None (export off — the
    default — costs nothing on the query path)."""
    endpoint = os.environ.get(ENDPOINT_ENV)
    if not endpoint:
        return None
    exporter = OtlpExporter(endpoint, service_name, instance_id)
    exporter.start()
    return exporter


def _kv(key: str, value) -> dict:
    """One OTLP attribute key-value."""
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def _otlp_span(span_dict: dict, now: float) -> dict:
    start_ns = int(float(span_dict.get("start") or now) * 1e9)
    dur = span_dict.get("durationS")
    end_ns = start_ns + int(float(dur) * 1e9) if dur is not None \
        else int(now * 1e9)
    return {
        "traceId": "",  # stamped by the batch builder
        "spanId": span_dict.get("spanId") or "",
        "parentSpanId": span_dict.get("parentId") or "",
        "name": span_dict.get("name") or "span",
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "attributes": [
            _kv(k, v)
            for k, v in (span_dict.get("attributes") or {}).items()],
    }


def spans_payload(span_dicts: List[dict], trace_id: str,
                  resource: Dict[str, object]) -> dict:
    """One OTLP-JSON ``ExportTraceServiceRequest`` body."""
    now = time.time()
    spans = []
    for s in span_dicts:
        sp = _otlp_span(s, now)
        sp["traceId"] = trace_id
        spans.append(sp)
    return {
        "resourceSpans": [{
            "resource": {
                "attributes": [_kv(k, v) for k, v in resource.items()]},
            "scopeSpans": [{
                "scope": {"name": "trino_tpu"},
                "spans": spans,
            }],
        }],
    }


def _hist_collect(hist: Dict[str, dict], name: str, labels: Dict[str, str],
                  value: float, help_text: str) -> None:
    """Fold one expanded histogram sample (``_bucket``/``_sum``/
    ``_count``) back into a per-(base name, label set) accumulator."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            break
    else:
        return  # histogram-typed sample with an unknown suffix: drop
    base = name[:-len(suffix)]
    rec = hist.setdefault(base, {"help": help_text, "points": {}})
    base_labels = {k: v for k, v in labels.items() if k != "le"}
    key = tuple(sorted(base_labels.items()))
    pt = rec["points"].setdefault(
        key, {"labels": base_labels, "buckets": [], "sum": 0.0, "count": 0})
    if suffix == "_bucket":
        le = labels.get("le", "+Inf")
        if le != "+Inf":  # +Inf is redundant with _count
            pt["buckets"].append((float(le), value))
    elif suffix == "_sum":
        pt["sum"] = float(value)
    else:
        pt["count"] = int(value)


def _hist_metrics(hist: Dict[str, dict], now_ns: str) -> List[dict]:
    """Real OTLP histogram metrics from the accumulated expansion:
    cumulative Prometheus ``le`` counts become per-bucket counts
    (``bucketCounts`` has ``len(explicitBounds) + 1`` entries — the last
    is the overflow bucket above the highest bound)."""
    out: List[dict] = []
    for base in sorted(hist):
        rec = hist[base]
        points = []
        for key in sorted(rec["points"]):
            pt = rec["points"][key]
            finite = sorted(pt["buckets"])
            counts: List[int] = []
            prev = 0.0
            for _, cum in finite:
                counts.append(max(0, int(cum - prev)))
                prev = cum
            counts.append(max(0, int(pt["count"] - prev)))
            points.append({
                "bucketCounts": [str(c) for c in counts],
                "explicitBounds": [b for b, _ in finite],
                "sum": pt["sum"],
                "count": str(pt["count"]),
                "timeUnixNano": now_ns,
                "attributes": [_kv(k, v)
                               for k, v in pt["labels"].items()],
            })
        out.append({
            "name": base,
            "description": rec["help"],
            "histogram": {"aggregationTemporality": 2,  # CUMULATIVE
                          "dataPoints": points},
        })
    return out


def metrics_payload(samples: List[tuple],
                    resource: Dict[str, object]) -> dict:
    """One OTLP-JSON ``ExportMetricsServiceRequest`` body from the typed
    registry's sample expansion (``registry_samples()``): counters ship
    as cumulative monotonic sums, histograms are reassembled from their
    expanded ``_bucket``/``_sum``/``_count`` series into real OTLP
    histogram points (explicitBounds + per-bucket counts + sum + count),
    everything else as gauges."""
    now_ns = str(int(time.time() * 1e9))
    by_name: Dict[str, dict] = {}
    hist: Dict[str, dict] = {}
    for name, type_name, labels, value, help_text in samples:
        if type_name == "histogram":
            _hist_collect(hist, name, labels, value, help_text)
            continue
        m = by_name.get(name)
        if m is None:
            points_key = "sum" if type_name == "counter" else "gauge"
            body: dict = {"dataPoints": []}
            if type_name == "counter":
                body["aggregationTemporality"] = 2  # CUMULATIVE
                body["isMonotonic"] = True
            m = {"name": name, "description": help_text, points_key: body}
            by_name[name] = m
        body = m.get("sum") or m["gauge"]
        body["dataPoints"].append({
            "asDouble": float(value),
            "timeUnixNano": now_ns,
            "attributes": [_kv(k, v) for k, v in labels.items()],
        })
    metrics = list(by_name.values()) + _hist_metrics(hist, now_ns)
    return {
        "resourceMetrics": [{
            "resource": {
                "attributes": [_kv(k, v) for k, v in resource.items()]},
            "scopeMetrics": [{
                "scope": {"name": "trino_tpu"},
                "metrics": metrics,
            }],
        }],
    }


class OtlpExporter:
    """Bounded-queue background exporter for one server instance
    (coordinator and worker construct their own, so a single test
    process hosting both exports each with its own resource identity)."""

    def __init__(self, endpoint: str, service_name: str,
                 instance_id: Optional[str] = None,
                 queue_max: int = DEFAULT_QUEUE_MAX,
                 flush_interval_s: float = 0.2,
                 metrics_interval_s: Optional[float] = None,
                 timeout_s: float = 3.0):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.instance_id = instance_id
        self.timeout_s = timeout_s
        self.flush_interval_s = flush_interval_s
        # periodic registry snapshots to {endpoint}/v1/metrics, from the
        # exporter's own thread (0 disables; spans are unaffected)
        if metrics_interval_s is None:
            try:
                metrics_interval_s = float(os.environ.get(
                    "TRINO_TPU_OTLP_METRICS_INTERVAL", "10"))
            except ValueError:
                metrics_interval_s = 10.0
        self.metrics_interval_s = metrics_interval_s
        self._last_metrics = time.monotonic()
        self._queue: "deque[tuple]" = deque()
        self._queue_max = queue_max
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._inflight = 0
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ enqueue
    def _resource(self, extra: Optional[Dict[str, object]]) -> dict:
        resource: Dict[str, object] = {"service.name": self.service_name}
        if self.instance_id:
            resource["service.instance.id"] = self.instance_id
        if extra:
            resource.update(extra)
        return resource

    def export_spans(self, span_dicts: List[dict], trace_id: str,
                     resource: Optional[Dict[str, object]] = None) -> bool:
        """Non-blocking: queue one span batch (a completed query's or
        task's tracer dump). Returns False when the bounded queue was
        full and the batch dropped."""
        if not span_dicts:
            return True
        payload = spans_payload(span_dicts, trace_id,
                                self._resource(resource))
        return self._enqueue("/v1/traces", payload, len(span_dicts))

    def export_metrics_snapshot(
            self, resource: Optional[Dict[str, object]] = None) -> bool:
        """Non-blocking: queue one snapshot of the whole metrics
        registry (called by servers on their announce cadence or by
        tests; OFF-path — never from query execution)."""
        from trino_tpu_torch.obs.metrics import registry_samples

        payload = metrics_payload(registry_samples(),
                                  self._resource(resource))
        return self._enqueue("/v1/metrics", payload, 1)

    def _enqueue(self, path: str, payload: dict, weight: int) -> bool:
        with self._lock:
            if len(self._queue) >= self._queue_max:
                dropped = True
            else:
                self._queue.append((path, payload, weight))
                dropped = False
        if dropped:
            from trino_tpu_torch.obs import metrics as M

            M.OTLP_DROPPED.inc(weight, "overflow")
            return False
        self._wake.set()
        return True

    # -------------------------------------------------------------- loop
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"otlp-exporter-{self.service_name}")
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            if (self.metrics_interval_s > 0
                    and time.monotonic() - self._last_metrics
                    >= self.metrics_interval_s):
                self._last_metrics = time.monotonic()
                self.export_metrics_snapshot()
            self._drain()
        self._drain()  # final flush on shutdown

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._queue:
                    return
                path, payload, weight = self._queue.popleft()
                self._inflight += 1
            try:
                self._post(path, payload, weight)
            finally:
                with self._lock:
                    self._inflight -= 1

    def _post(self, path: str, payload: dict, weight: int) -> None:
        import urllib.request

        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.endpoint + path, data=body, method="POST")
        req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                if 200 <= resp.status < 300:
                    return
        except Exception:  # noqa: BLE001 — the engine never feels a
            pass  # collector outage; the drop counter is the signal
        from trino_tpu_torch.obs import metrics as M

        M.OTLP_DROPPED.inc(weight, "send-error")

    # ------------------------------------------------------------- admin
    def pending(self) -> int:
        with self._lock:
            return len(self._queue) + self._inflight

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until the queue fully drains (tests/shutdown only)."""
        self._wake.set()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.pending() == 0:
                return True
            self._wake.set()
            time.sleep(0.01)
        return self.pending() == 0

    def shutdown(self, timeout: float = 5.0) -> None:
        self.flush(timeout)
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)


class StubCollector:
    """In-process OTLP/HTTP collector for tests and local development:
    accepts ``POST /v1/traces`` + ``POST /v1/metrics`` and stores the
    parsed payloads. Point ``TRINO_TPU_OTLP_ENDPOINT`` at
    ``collector.endpoint``."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        collector = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(n)
                try:
                    payload = json.loads(body)
                except ValueError:
                    self.send_response(400)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                with collector._lock:
                    if self.path == "/v1/traces":
                        collector.trace_payloads.append(payload)
                    elif self.path == "/v1/metrics":
                        collector.metric_payloads.append(payload)
                    else:
                        collector.other_payloads.append((self.path, payload))
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

        self._lock = threading.Lock()
        self.trace_payloads: List[dict] = []
        self.metric_payloads: List[dict] = []
        self.other_payloads: List[tuple] = []
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    def start(self) -> "StubCollector":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    def spans(self) -> List[dict]:
        """Every received span, flattened, with its resource attributes
        attached as ``_resource`` (dict) for assertions."""
        out: List[dict] = []
        with self._lock:
            payloads = list(self.trace_payloads)
        for payload in payloads:
            for rs in payload.get("resourceSpans", ()):
                resource = {
                    a["key"]: next(iter(a["value"].values()))
                    for a in rs.get("resource", {}).get("attributes", ())}
                for ss in rs.get("scopeSpans", ()):
                    for sp in ss.get("spans", ()):
                        rec = dict(sp)
                        rec["_resource"] = resource
                        out.append(rec)
        return out

    def wait_for_spans(self, count: int, timeout: float = 10.0) -> List[dict]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            spans = self.spans()
            if len(spans) >= count:
                return spans
            time.sleep(0.02)
        return self.spans()
