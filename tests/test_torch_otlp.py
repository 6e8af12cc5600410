"""The port's OTLP exporter (trino_tpu_torch/obs/otlp.py) and its wiring
into the coordinator, the workers and their tasks, held against the JAX
package on the CPU.

The cases of the reference's tests/test_otlp.py. The same spans and
registry samples go to both packages' payload builders, and the payloads
must be exactly equal (their time stamps aside). The bounded queue drops
and counts rather than block, in both packages. The cluster case runs one
distributed query on a port CPU cluster and a JAX CPU cluster (two
in-process workers each), each exporting to its own in-process stub
collector. The collectors must receive the same span names, each query's
spans must number those of its trace, and the task spans must parent under
the coordinator's schedule span. ``OTLP_DROPPED`` must stay where it was.
Timings are not compared. The stub round trip's histogram is
``trino_tpu_query_seconds``: the port's compile-seconds histogram is not
in its registry.
"""
import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_obs_common import (BOTH, JAX, TINY, TORCH, start_cluster,  # noqa: E402
                              stop_cluster, wait_terminal)


def _untimed(obj):
    """A payload with its time stamps taken out."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if not k.lower().endswith("timeunixnano")}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _both(fn):
    got, want = fn(TORCH), fn(JAX)
    assert got == want
    return got


# ------------------------------------------------------------- unit layer
def test_off_by_default(monkeypatch):
    for pkg in BOTH:
        monkeypatch.delenv(pkg.otlp.ENDPOINT_ENV, raising=False)
        assert pkg.otlp.exporter_from_env("trino-tpu-test") is None
    assert TORCH.otlp.ENDPOINT_ENV == JAX.otlp.ENDPOINT_ENV


@pytest.mark.parametrize("seed", range(3))
def test_spans_payload_shape(seed):
    rng = np.random.default_rng(seed)
    spans = [{"spanId": "aa" * 8, "parentId": "bb" * 8, "name": "schedule",
              "start": 1000.0, "durationS": 0.25,
              "attributes": {"workers": 2, "note": "x", "frac": 0.5, "flag": True}}]
    spans += [{"spanId": f"{i:016x}", "parentId": None if i == 0 else f"{i - 1:016x}",
               "name": str(rng.choice(["query", "task", "device/execute", "exchange/pull"])),
               "start": float(rng.random() * 100), "durationS": float(rng.random()),
               "attributes": {"rows": int(rng.integers(0, 100)), "on": bool(rng.random() < .5)}}
              for i in range(8)]
    resource = {"service.name": "trino-tpu-coordinator", "query_id": "q1"}
    payload = _both(lambda pkg: pkg.otlp.spans_payload(spans, "cc" * 16, resource))
    rs = payload["resourceSpans"][0]
    res_attrs = {a["key"]: a["value"] for a in rs["resource"]["attributes"]}
    assert res_attrs["query_id"] == {"stringValue": "q1"}
    sp = rs["scopeSpans"][0]["spans"][0]
    assert sp["traceId"] == "cc" * 16 and sp["parentSpanId"] == "bb" * 8
    assert int(sp["endTimeUnixNano"]) - int(sp["startTimeUnixNano"]) == int(0.25 * 1e9)
    attrs = {a["key"]: a["value"] for a in sp["attributes"]}
    assert attrs == {"workers": {"intValue": "2"}, "note": {"stringValue": "x"},
                     "frac": {"doubleValue": 0.5}, "flag": {"boolValue": True}}


def test_metrics_payload_counters_are_monotonic_sums():
    samples = [("trino_tpu_tasks_total", "counter", {}, 3.0, "tasks"),
               ("trino_tpu_workers", "gauge", {}, 2.0, "workers"),
               ("trino_tpu_queries", "gauge", {"state": "RUNNING"}, 1.0, "q")]
    payload = _both(lambda pkg: _untimed(pkg.otlp.metrics_payload(samples, {"service.name": "w"})))
    metrics = {m["name"]: m for m in payload["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
    assert metrics["trino_tpu_tasks_total"]["sum"]["isMonotonic"] is True
    assert metrics["trino_tpu_workers"]["gauge"]["dataPoints"][0]["asDouble"] == 2.0


def test_metrics_payload_histograms_are_real_histograms():
    h = "hist help"
    labels = {"tier": "compiled", "cache": "miss"}
    samples = [("trino_tpu_compile_seconds_bucket", "histogram", {**labels, "le": "0.1"}, 1.0, h),
               ("trino_tpu_compile_seconds_bucket", "histogram", {**labels, "le": "1"}, 3.0, h),
               ("trino_tpu_compile_seconds_bucket", "histogram", {**labels, "le": "+Inf"}, 4.0, h),
               ("trino_tpu_compile_seconds_sum", "histogram", labels, 2.5, h),
               ("trino_tpu_compile_seconds_count", "histogram", labels, 4.0, h),
               ("trino_tpu_workers", "gauge", {}, 2.0, "workers")]
    payload = _both(lambda pkg: _untimed(pkg.otlp.metrics_payload(samples, {"service.name": "w"})))
    metrics = {m["name"]: m for m in payload["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
    assert "trino_tpu_compile_seconds_bucket" not in metrics
    dp = metrics["trino_tpu_compile_seconds"]["histogram"]["dataPoints"][0]
    assert dp["explicitBounds"] == [0.1, 1.0] and dp["bucketCounts"] == ["1", "2", "1"]
    assert dp["sum"] == 2.5 and dp["count"] == "4"
    # the port's own registry samples build the same payload as the
    # reference's builder given them
    rows = TORCH.M.registry_samples()
    assert _untimed(TORCH.otlp.metrics_payload(rows, {"service.name": "w"})) == _untimed(
        JAX.otlp.metrics_payload(rows, {"service.name": "w"}))


def test_queue_overflow_drops_counted_and_never_blocks():
    def case(pkg):
        exporter = pkg.otlp.OtlpExporter("http://127.0.0.1:1", "t", queue_max=3)
        dropped0 = pkg.M.OTLP_DROPPED.value("overflow")
        t0 = time.monotonic()
        results = [exporter.export_spans(
            [{"spanId": "s", "name": "n", "start": 1.0, "durationS": 0.1}], "t" * 32)
            for _ in range(10)]
        assert time.monotonic() - t0 < 1.0
        return results, pkg.M.OTLP_DROPPED.value("overflow") - dropped0, exporter.pending()

    assert _both(case) == ([True] * 3 + [False] * 7, 7, 3)


def test_unreachable_collector_drops_as_send_error():
    def case(pkg):
        exporter = pkg.otlp.OtlpExporter("http://127.0.0.1:1", "t", timeout_s=0.2)
        exporter.start()
        dropped0 = pkg.M.OTLP_DROPPED.value("send-error")
        ok = exporter.export_spans([{"spanId": "s", "name": "n", "start": 1.0,
                                     "durationS": 0.1}], "t" * 32)
        flushed = exporter.flush(timeout=10.0)
        exporter.shutdown()
        return ok, flushed, pkg.M.OTLP_DROPPED.value("send-error") - dropped0

    assert _both(case) == (True, True, 1)


def test_stub_collector_round_trip():
    def case(pkg):
        collector = pkg.otlp.StubCollector().start()
        try:
            exporter = pkg.otlp.OtlpExporter(collector.endpoint, "svc", "node-1")
            exporter.start()
            exporter.export_spans([{"spanId": "ab" * 8, "name": "task", "start": 5.0,
                                    "durationS": 1.0, "attributes": {}}],
                                  "fe" * 16, {"query_id": "qz"})
            pkg.M.QUERY_SECONDS.observe(0.05, "FINISHED")
            exporter.export_metrics_snapshot()
            assert exporter.flush(timeout=10.0)
            spans = collector.spans()
            exported = {m["name"]: m for p in collector.metric_payloads
                        for m in p["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
            dp = next(d for d in exported["trino_tpu_query_seconds"]["histogram"]["dataPoints"]
                      if {a["key"]: a["value"].get("stringValue") for a in d["attributes"]}
                      == {"state": "FINISHED"})
            assert int(dp["count"]) >= 1 and float(dp["sum"]) > 0
            assert len(dp["bucketCounts"]) == len(dp["explicitBounds"]) + 1
            assert sum(int(c) for c in dp["bucketCounts"]) == int(dp["count"])
            exporter.shutdown()
            return ([(s["traceId"], s["_resource"]) for s in spans],
                    dp["explicitBounds"])
        finally:
            collector.stop()

    spans, _bounds = _both(case)
    assert spans == [("fe" * 16, {"service.name": "svc", "service.instance.id": "node-1",
                                  "query_id": "qz"})]


# --------------------------------------------- tier-1 cluster smoke test
SQL = "select l_returnflag, count(*) c from lineitem group by l_returnflag order by l_returnflag"


def _cluster_case(pkg, monkeypatch):
    collector = pkg.otlp.StubCollector().start()
    monkeypatch.setenv(pkg.otlp.ENDPOINT_ENV, collector.endpoint)
    coord, workers = start_cluster(pkg, "otlp-w")
    try:
        assert coord.otlp is not None and all(w.otlp is not None for w in workers)
        dropped0 = sum(pkg.M.OTLP_DROPPED.value(r) for r in ("overflow", "send-error"))
        q = coord.submit(SQL, dict(TINY))
        assert wait_terminal(q, 60.0) == "FINISHED", q.failure
        spans = q.tracer.to_dicts() + q.worker_spans()
        want = len(spans)
        deadline = time.time() + 15.0
        trace_spans = []
        while time.time() < deadline:
            trace_spans = [sp for sp in collector.spans() if sp["traceId"] == q.tracer.trace_id]
            if len(trace_spans) >= want:
                break
            time.sleep(0.05)
        names = sorted(sp["name"] for sp in trace_spans)
        assert len(trace_spans) == want, (len(trace_spans), want)
        assert all(sp["_resource"].get("query_id") == q.query_id for sp in trace_spans)
        schedule = next(sp for sp in trace_spans if sp["name"] == "schedule")
        tasks = [sp for sp in trace_spans if sp["name"] == "task"]
        assert len(tasks) >= 2 and {t["parentSpanId"] for t in tasks} == {schedule["spanId"]}
        assert {"otlp-w0", "otlp-w1"} <= {t["_resource"].get("service.instance.id")
                                         for t in tasks}
        assert all(len(sp["traceId"]) == 32 and len(sp["spanId"]) == 16 for sp in trace_spans)
        dropped = sum(pkg.M.OTLP_DROPPED.value(r) for r in ("overflow", "send-error")) - dropped0
        return names, dropped
    finally:
        stop_cluster(coord, workers)
        collector.stop()


def test_distributed_query_exports_parented_otlp_spans(monkeypatch):
    got = _cluster_case(TORCH, monkeypatch)
    want = _cluster_case(JAX, monkeypatch)
    assert got == want
    assert got[1] == 0 and {"query", "schedule", "task"} <= set(got[0])
