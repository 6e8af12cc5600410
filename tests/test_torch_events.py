"""The port's event listeners, metrics page and flight recorder
(trino_tpu_torch/server/events.py, obs/metrics.py, obs/flightrecorder.py)
against the JAX package's, on the CPU.

The cases of the reference's tests/test_observability_events.py through a
cluster of each package: created and completed events fire (a failing
listener isolated), a FAILED query's event carries its error, and
``/v1/metrics`` renders the coordinator's gauges. Both packages declare
the serving plane's series with the same names, types, help and label
names, and both pages carry them after the same statements. Then the flight
recorder's units of the reference's tests/test_flight_recorder.py (the
bounded ring, the tracer's mirror, ``trim_postmortem``, the worker's
``/v1/task/{id}/recorder`` route) and a FAILED distributed query's
postmortem.

Left out by name from tests/test_flight_recorder.py:
``test_span_cap_drops_counted_without_breaking_callers`` (obs/trace.py is
a copy held since the first slice) and
``test_recorder_param_on_live_query_merges_live_rings`` (the
``/v1/query/{id}/trace`` route is not ported).
"""
import re
import time
import types
import urllib.request

import pytest

import trino_tpu  # noqa: F401  (turns on JAX x64 first)

TINY = {"catalog": "tpch", "schema": "tiny"}

# the series the serving plane writes (dispatch, lanes, resource groups,
# the coordinator's gauges, memory pressure and peaks)
SERVING_SERIES = (
    "DISPATCH_QUEUE_DEPTH", "DISPATCH_REJECTED", "DISPATCH_CACHE_SERVED", "EXECUTOR_LANES_BUSY",
    "RESOURCE_GROUP_QUEUED", "RESOURCE_GROUP_RUNNING", "RESOURCE_GROUP_REJECTED",
    "RESOURCE_GROUP_SERVED", "RESOURCE_GROUP_QUEUE_SECONDS", "QUERIES", "QUERIES_TOTAL",
    "QUERY_SECONDS", "QUERY_PEAK_MEMORY_BYTES", "QUERY_HISTORY_SIZE", "WORKERS",
    "UPTIME_SECONDS", "RESULT_ROWS", "MEMORY_PRESSURE_EVENTS")


def _package(name):
    import importlib

    root = "trino_tpu" if name == "jax" else "trino_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    return types.SimpleNamespace(
        name=name, events=mod("server.events"), M=mod("obs.metrics"),
        fr=mod("obs.flightrecorder"), trace=mod("obs.trace"), wire=mod("server.wire"),
        coordinator=mod("server.coordinator"), worker=mod("server.worker"),
        kw={"device": "cpu"} if name == "torch" else {})


JAX = _package("jax")
TORCH = _package("torch")


def _recorder_cls(pkg):
    class Recorder(pkg.events.EventListener):
        def __init__(self):
            self.created = []
            self.completed = []

        def query_created(self, event):
            self.created.append(event)

        def query_completed(self, event):
            self.completed.append(event)

    class Exploder(pkg.events.EventListener):
        def query_completed(self, event):
            raise RuntimeError("listener bug")

    return Recorder, Exploder


@pytest.fixture(scope="module")
def clusters():
    started = {}
    try:
        for pkg in (JAX, TORCH):
            c = pkg.coordinator.CoordinatorServer(**pkg.kw)
            c.start()
            w = pkg.worker.WorkerServer(coordinator_url=c.base_url, node_id="w0", **pkg.kw)
            w.start()
            started[pkg.name] = (c, w)
            assert c.registry.wait_for_workers(1, timeout=15.0)
        yield {name: c for name, (c, _w) in started.items()}
    finally:
        for c, w in started.values():
            w.stop()
            c.stop()


def _wait_terminal(q, timeout=30.0):
    deadline = time.time() + timeout
    while not q.state.is_terminal() and time.time() < deadline:
        time.sleep(0.05)
    return q.state.get()


def _wait_completed(rec, qid):
    deadline = time.time() + 10
    while not any(e.query_id == qid for e in rec.completed) and time.time() < deadline:
        time.sleep(0.05)
    return next(e for e in rec.completed if e.query_id == qid)


def _events_case(pkg, coord):
    Recorder, Exploder = _recorder_cls(pkg)
    rec = Recorder()
    coord.events.add(rec)
    coord.events.add(Exploder())  # must not affect the query or the recorder
    q = coord.submit("select 1 as x", dict(TINY), user="alice")
    state = _wait_terminal(q)
    ev = _wait_completed(rec, q.query_id)
    created = next(e for e in rec.created if e.query_id == q.query_id)
    bad = coord.submit("select definitely_not_a_column from nowhere", {})
    bad_state = _wait_terminal(bad)
    bev = _wait_completed(rec, bad.query_id)
    return {"state": state, "created": (created.user, created.sql),
            "completed": (ev.state, ev.user, ev.output_rows, ev.error, ev.wall_seconds >= 0,
                          ev.end_time >= ev.create_time, bool(ev.spans),
                          ev.session_properties == dict(TINY)),
            "failed": (bad_state, bev.state, bool(bev.error), bev.postmortem is not None,
                       (bev.postmortem or {}).get("state"))}


def test_query_events_fire(clusters):
    got = _events_case(TORCH, clusters["torch"])
    want = _events_case(JAX, clusters["jax"])
    assert got == want
    assert got["completed"] == ("FINISHED", "alice", 1, None, True, True, True, True)
    assert got["failed"] == ("FAILED", "FAILED", True, True, "FAILED")


def _page(coord):
    return urllib.request.urlopen(coord.base_url + "/v1/metrics").read().decode()


def _types(page):
    return {m.group(1): m.group(2) for m in re.finditer(r"^# TYPE (\S+) (\S+)$", page, re.M)}


def test_metrics_endpoint(clusters):
    """Both pages: the queries gauges, one worker, and the serving plane's
    series with the same types."""
    for name in ("jax", "torch"):
        coord = clusters[name]
        coord.submit("select 2", dict(TINY)).state.wait_for_terminal(30.0)
        body = _page(coord)
        assert "trino_tpu_queries_total" in body
        assert 'trino_tpu_queries{state="FINISHED"}' in body
        assert "trino_tpu_workers 1" in body
        total = next(line for line in body.splitlines()
                     if line.startswith("trino_tpu_queries_total"))
        assert int(total.split()[-1]) >= 1
    got, want = _types(_page(clusters["torch"])), _types(_page(clusters["jax"]))
    serving = {getattr(TORCH.M, s).name for s in SERVING_SERIES}
    assert serving <= set(got) and serving <= set(want)
    assert {n: got[n] for n in serving} == {n: want[n] for n in serving}
    # the dispatch and resource-group series carry samples on both pages
    for page in (_page(clusters["torch"]), _page(clusters["jax"])):
        assert 'trino_tpu_resource_group_running{group="global"}' in page
        assert re.search(r"^trino_tpu_resource_group_queue_seconds_count\{group=\"global\"\} \d+",
                         page, re.M)


def test_serving_series_declared_as_the_reference():
    """Each serving series of the port has the reference's name, type,
    help and label names."""
    for attr in SERVING_SERIES + ("EXECUTOR_PLANE_QUERIES", "MEMORY_POOL_BYTES",
                                  "QUERY_HISTORY_EVICTIONS", "PROCESS_RSS_BYTES",
                                  "PROCESS_THREADS", "PROCESS_OPEN_FDS",
                                  "PROCESS_GC_COLLECTIONS"):
        mine, ref = getattr(TORCH.M, attr), getattr(JAX.M, attr)
        assert (mine.name, mine.type_name, mine.help, mine.labelnames) == (
            ref.name, ref.type_name, ref.help, ref.labelnames), attr
        if hasattr(ref, "buckets"):
            assert mine.buckets == ref.buckets, attr
    assert set(TORCH.M.REGISTRY.names()) <= set(JAX.M.REGISTRY.names())


def test_renderer_escapes_and_histograms():
    for pkg in (JAX, TORCH):
        reg = pkg.M.MetricsRegistry()
        c = reg.counter("t_escape_total", "help", ("lab",))
        c.inc(2, 'a"b\\c\nd')
        h = reg.histogram("t_hist_seconds", "help", ("s",), buckets=(0.1, 1.0))
        h.observe(0.5, "x")
        g = reg.gauge("t_untouched", "help")
        assert g.value() == 0
        with pytest.raises(ValueError):
            c.inc(1)
        page = reg.render()
        assert 't_escape_total{lab="a\\"b\\\\c\\nd"} 2' in page
        assert 't_hist_seconds_bucket{s="x",le="0.1"} 0' in page
        assert 't_hist_seconds_bucket{s="x",le="+Inf"} 1' in page
        assert 't_hist_seconds_count{s="x"} 1' in page
        assert not re.search(r"^t_untouched ", page, re.M)  # the header only
    assert JAX.M.escape_label_value('q"\n') == TORCH.M.escape_label_value('q"\n')


def test_worker_metrics_route(clusters):
    for name, pkg in (("jax", JAX), ("torch", TORCH)):
        coord = clusters[name]
        url = coord.registry.alive()[0]["url"]
        body = urllib.request.urlopen(url + "/v1/metrics").read().decode()
        assert "# TYPE trino_tpu_process_rss_bytes gauge" in body, name


# ---------------------------------------------------------- flight recorder
def _ring(pkg):
    r = pkg.fr.FlightRecorder(node_id="n1", capacity=4)
    for i in range(10):
        r.record("event", f"e{i}", seq=i)
    snap = r.snapshot()
    return (len(r), [e["name"] for e in snap], snap[-1]["seq"],
            [e["name"] for e in r.snapshot(limit=2)])


def test_ring_is_bounded_and_ordered():
    got = _ring(TORCH)
    assert got == _ring(JAX) == (4, ["e6", "e7", "e8", "e9"], 9, ["e8", "e9"])


def _mirror(pkg):
    r = pkg.fr.FlightRecorder(node_id="n1")
    t = pkg.trace.Tracer()
    t.recorder = r
    with t.span("schedule", workers=2):
        pass
    sp = t.spans()[0]
    t.end_span(sp)  # the idempotent safety net must not record twice
    records = r.snapshot()
    rec = records[0]
    return (len(records), rec["kind"], rec["name"], rec["traceId"] == t.trace_id,
            rec["spanId"] == sp.span_id, rec["attributes"])


def test_tracer_mirrors_closed_spans_into_ring_once():
    assert _mirror(TORCH) == _mirror(JAX) == (1, "span", "schedule", True, True, {"workers": 2})


def test_trim_postmortem_caps_per_node_records():
    pm = {"queryId": "q", "state": "FAILED",
          "coordinator": {"nodeId": "c", "records": [{"i": i} for i in range(100)]},
          "workers": [{"url": "u", "records": [{"i": i} for i in range(10)]},
                      {"url": "v", "error": "gone"}]}
    got = TORCH.fr.trim_postmortem(pm, per_node=8)
    assert got == JAX.fr.trim_postmortem(pm, per_node=8)
    assert got["coordinator"]["truncated"] == 92 and len(got["coordinator"]["records"]) == 8
    assert got["workers"][1] == {"url": "v", "error": "gone"}
    assert TORCH.fr.trim_postmortem(None) is None


def test_worker_recorder_endpoint_and_failed_postmortem(clusters):
    """A FAILED distributed query's postmortem merges the coordinator's ring
    with its worker's, pulled from ``/v1/task/{id}/recorder`` (the route
    answers for a task the worker no longer knows, too)."""
    coord = clusters["torch"]
    url = coord.registry.alive()[0]["url"]
    status, body, _ = TORCH.wire.http_request("GET", f"{url}/v1/task/nope.0.0.a0/recorder")
    import json

    info = json.loads(body)
    assert status == 200 and info["nodeId"] == "w0" and info["taskKnown"] is False
    assert set(info["memory"]) == {"nodeId", "pools", "topConsumers", "sheds"}
    # a division by zero on the workers fails the query after its tasks ran
    q = coord.submit("select sum(n_nationkey / (n_regionkey - n_regionkey)) from nation",
                     dict(TINY))
    assert _wait_terminal(q) == "FAILED"
    deadline = time.time() + 10
    while q.postmortem is None and time.time() < deadline:
        time.sleep(0.05)
    pm = q.postmortem
    assert pm["state"] == "FAILED" and pm["failure"]
    assert pm["coordinator"]["nodeId"] == "coordinator" and pm["coordinator"]["records"]
    assert any(r["name"] == "submitted" and r.get("queryId") == q.query_id
               for r in pm["coordinator"]["records"])
    if q.fragment_tasks:
        assert [w["nodeId"] for w in pm["workers"]] == ["w0"]
        assert any(r.get("queryId") == q.query_id for r in pm["workers"][0]["records"])
