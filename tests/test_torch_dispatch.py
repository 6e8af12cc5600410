"""The port's dispatch plane (trino_tpu_torch/server/dispatch.py) against
the JAX package's (trino_tpu/server/dispatch.py), on the CPU.

The cases of the reference's tests/test_dispatch.py, each run through both
packages: the bounded queue's typed rejection (both ``DispatchRejected``
payloads equal for the same offers), the lane defaults, overload answered
429 with ``Retry-After`` and drained once lanes start (both clusters give
the same status, header and payload keys), the client's 429 retries, a
stress run of more clients than lanes with bounded threads, the serving
index (MISS fills, a repeat is served on the dispatch thread, DML and
another user miss) and the ``dispatch/queue`` span with the serving rows.

The five process-plane cases (``test_process_plane_point_query``,
``_prepared_zero_planning``, ``_owner_catalog_bounces``,
``_dml_invalidation_crosses_processes``, ``_deallocate_replicates``) are in
tests/test_torch_process_plane.py. Left out by name: of ``test_dispatch_queue_phase_and_serving_table`` the phase ledger and
the ``system.runtime.serving`` query, which
tests/test_torch_system_catalog.py holds (here the serving rows are read
from the dispatcher).
"""
import threading
import time
import types

import pytest

import trino_tpu  # noqa: F401  (turns on JAX x64 first)

PROPS = {"catalog": "tpch", "schema": "tiny", "short_query_fast_path": "true"}


def _package(name):
    import importlib

    root = "trino_tpu" if name == "jax" else "trino_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    kw = {"device": "cpu"} if name == "torch" else {}
    return types.SimpleNamespace(
        name=name, kw=kw, M=mod("obs.metrics"), dispatch=mod("server.dispatch"),
        coordinator=mod("server.coordinator"), remote=mod("client.remote"),
        wire=mod("server.wire"))


JAX = _package("jax")
TORCH = _package("torch")
PACKAGES = pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])


def both(case, *args):
    want = case(JAX, *args)
    got = case(TORCH, *args)
    assert got == want, f"{case.__name__}: the port's {got} != the reference's {want}"
    return got


def _coordinator(pkg, **kw):
    coord = pkg.coordinator.CoordinatorServer(**kw, **pkg.kw)
    coord.start()
    return coord


def _wait(q, timeout=30.0):
    state = q.state.wait_for_terminal(timeout)
    assert state == "FINISHED", (state, q.failure)
    return q


# ------------------------------------------------------------- queue units
def _typed_rejection(pkg):
    q = pkg.dispatch.DispatchQueue(capacity=2)
    q.offer("a")
    q.offer("b")
    with pytest.raises(pkg.dispatch.DispatchRejected) as ei:
        q.offer("c")
    e = ei.value
    assert e.retry_after_s > 0
    taken = [q.take(0.1), q.take(0.1), q.take(0.05)]
    return e.code, e.queued, e.capacity, e.payload(), taken


def test_dispatch_queue_typed_rejection():
    code, queued, capacity, payload, taken = both(_typed_rejection)
    assert (code, queued, capacity) == ("DISPATCH_QUEUE_FULL", 2, 2)
    assert payload["error"]["code"] == "DISPATCH_QUEUE_FULL"
    assert payload["error"]["retryAfterSeconds"] > 0
    assert taken == ["a", "b", None]  # empty: times out, never blocks forever


def _group_rejection(pkg):
    rg = pkg.dispatch.DispatchRejected(3, 3, retry_after_s=2.5, resource_group="global.a",
                                       queued_ahead=3)
    return rg.payload(), str(rg)


def test_group_rejection_payload_equal():
    payload, _msg = both(_group_rejection)
    assert payload["error"]["resourceGroup"] == "global.a"
    assert payload["error"]["queuedAhead"] == 3


def _lane_defaults(pkg):
    return pkg.dispatch.default_lane_count(), pkg.dispatch.default_queue_capacity()


def test_lane_defaults_bounded(monkeypatch):
    monkeypatch.delenv("TRINO_TPU_EXECUTOR_LANES", raising=False)
    monkeypatch.delenv("TRINO_TPU_DISPATCH_QUEUE_CAPACITY", raising=False)
    lanes, capacity = both(_lane_defaults)
    assert 8 <= lanes <= 32 and capacity == 256
    monkeypatch.setenv("TRINO_TPU_EXECUTOR_LANES", "3")
    monkeypatch.setenv("TRINO_TPU_DISPATCH_QUEUE_CAPACITY", "7")
    assert both(_lane_defaults) == (3, 7)


def test_process_plane_refused(monkeypatch):
    """The executor plane by argument or by environment: ``process`` is
    accepted (a dispatcher with a plane of that many children, none booted
    until a query routes there), an unknown name raises ValueError."""
    resolve = TORCH.dispatch.resolve_plane
    assert resolve("process") == "process" and resolve(None) == "thread"
    server = types.SimpleNamespace(device="cpu")
    d = TORCH.dispatch.Dispatcher(server, lanes=0, plane="process", processes=3)
    pp = d.process_plane
    assert d.plane == "process" and pp.process_count() == 3
    assert pp.children_urls() == [] and pp.device == "cpu"
    d.shutdown()
    with pytest.raises(ValueError, match="unknown executor plane"):
        resolve("fiber")
    monkeypatch.setenv("TRINO_TPU_EXECUTOR_PLANE", "process")
    assert resolve() == "process"
    monkeypatch.setenv("TRINO_TPU_EXECUTOR_PLANE", "fiber")
    with pytest.raises(ValueError, match="unknown executor plane"):
        TORCH.coordinator.CoordinatorServer(device="cpu")


# ------------------------------------------------------- overload behavior
def _overload(pkg):
    """Queue full: DispatchRejected on the Python surface, 429 with
    Retry-After over HTTP; once lanes start every queued query finishes."""
    coord = _coordinator(pkg, executor_lanes=0, dispatch_queue_capacity=2)
    try:
        rejected0 = pkg.M.DISPATCH_REJECTED.value("queue-full")
        q1 = coord.submit("select 1", PROPS)
        q2 = coord.submit("select 2", PROPS)
        with pytest.raises(pkg.dispatch.DispatchRejected):
            coord.submit("select 3", PROPS)
        rejected = pkg.M.DISPATCH_REJECTED.value("queue-full") - rejected0
        status, body, headers = pkg.wire.http_request(
            "POST", f"{coord.base_url}/v1/statement", b"select 4", "text/plain",
            headers={f"X-Trino-Session-{k}": v for k, v in PROPS.items()})
        import json

        payload = json.loads(body)
        registered = len(coord.queries)
        coord.dispatcher.start_lanes(2)
        states = [q1.state.wait_for_terminal(30.0), q2.state.wait_for_terminal(30.0)]
        return {"rejected": rejected, "status": status,
                "retry_after_header": any(k.lower() == "retry-after" for k in headers),
                "payload_keys": sorted(payload["error"]),
                "code": payload["error"]["code"], "registered": registered,
                "states": states, "rows": [list(q1.rows), list(q2.rows)]}
    finally:
        coord.stop()


def test_overload_is_typed_and_drains():
    got = both(_overload)
    assert got["rejected"] == 1 and got["status"] == 429 and got["retry_after_header"]
    assert got["code"] == "DISPATCH_QUEUE_FULL"
    assert got["registered"] == 2  # the rejected statements never registered
    assert got["states"] == ["FINISHED", "FINISHED"]
    assert got["rows"] == [[(1,)], [(2,)]]


def _client_retries(pkg):
    coord = _coordinator(pkg, executor_lanes=0, dispatch_queue_capacity=1)
    try:
        blocker = coord.submit("select 0", PROPS)  # fills the queue
        client = pkg.remote.StatementClient(coord.base_url, PROPS)
        result = {}

        def go():
            result["rows"] = client.execute("select 41 + 1", timeout=60.0)[1]

        t = threading.Thread(target=go)
        t.start()
        deadline = time.monotonic() + 30.0
        while client.submit_retries < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        coord.dispatcher.start_lanes(2)
        t.join(timeout=60.0)
        assert not t.is_alive()
        return result["rows"], client.submit_retries >= 1, blocker.state.wait_for_terminal(30.0)
    finally:
        coord.stop()


def test_client_retries_429_to_completion():
    """StatementClient treats 429 as backpressure: it waits the retry
    guidance and resubmits until the queue drains; the query is not lost."""
    assert both(_client_retries) == ([[42]], True, "FINISHED")


def test_client_gives_up_typed_when_the_budget_runs_out():
    coord = _coordinator(TORCH, executor_lanes=0, dispatch_queue_capacity=1)
    try:
        coord.submit("select 0", PROPS)
        client = TORCH.remote.StatementClient(coord.base_url, PROPS)
        with pytest.raises(TORCH.remote.QueueFullError) as ei:
            client.execute("select 1", timeout=0.5)
        assert ei.value.resource_group == "global" and ei.value.queued_ahead == 1
        assert ei.value.retry_after_s > 0
    finally:
        coord.stop()


def _stress(pkg):
    """12 concurrent clients against 2 lanes and a 4-deep queue: every
    query finishes with its rows, and the process does not grow a thread a
    query."""
    coord = _coordinator(pkg, executor_lanes=2, dispatch_queue_capacity=4)
    threads_before = threading.active_count()
    results, errors = [], []

    def client_loop(ci):
        c = pkg.remote.StatementClient(coord.base_url, PROPS)
        for r in range(4):
            try:
                _, rows = c.execute(f"select {ci} * 100 + {r}", timeout=120.0)
                results.append((ci, r, rows[0][0]))
            except Exception as e:  # noqa: BLE001 — the assertion below
                errors.append(f"{ci}.{r}: {e}")

    try:
        workers = [threading.Thread(target=client_loop, args=(ci,)) for ci in range(12)]
        for t in workers:
            t.start()
        peak = 0
        while any(t.is_alive() for t in workers):
            peak = max(peak, threading.active_count())
            time.sleep(0.02)
        for t in workers:
            t.join()
        assert not errors, errors[:5]
        # 12 clients + their 12 keep-alive handler threads + constant
        # overhead: not 48 query threads
        assert peak - threads_before < 34, (peak, threads_before)
        return sorted(results)
    finally:
        coord.stop()


def test_stress_more_clients_than_lanes():
    results = both(_stress)
    assert len(results) == 48  # zero lost queries
    assert all(v == ci * 100 + r for ci, r, v in results)


def test_port_lanes_are_the_only_query_threads():
    """The port's coordinator runs every query on one of its fixed lanes:
    a submit creates no thread, and the lane threads exist before the
    first query."""
    coord = _coordinator(TORCH, executor_lanes=2, dispatch_queue_capacity=64)
    try:
        lanes = {t.name for t in threading.enumerate() if t.name.startswith("executor-lane-")}
        assert lanes == {"executor-lane-0", "executor-lane-1"}
        before = threading.active_count()
        qs = [coord.submit(f"select {i}", PROPS) for i in range(20)]
        after_submit = threading.active_count()
        for q in qs:
            _wait(q)
        assert after_submit <= before
        assert [q.rows for q in qs] == [[(i,)] for i in range(20)]
    finally:
        coord.stop()


# ------------------------------------------------------- dispatch-plane serve
def _serving_index(pkg):
    coord = _coordinator(pkg)
    M = pkg.M
    try:
        props = {"catalog": "memory", "schema": "default", "result_cache_enabled": "true"}
        _wait(coord.submit("create table memory.default.sx (a bigint)", props))
        _wait(coord.submit("insert into memory.default.sx values (1), (2)", props))
        sql = "select count(*) from memory.default.sx"
        out = []

        def run(user="anonymous"):
            served0 = M.DISPATCH_CACHE_SERVED.value()
            q = _wait(coord.submit(sql, props, user=user))
            names = {s["name"] for s in q.tracer.to_dicts()}
            out.append((q.cache_status, list(q.rows), M.DISPATCH_CACHE_SERVED.value() - served0,
                        "dispatch/serve" in names, "dispatch/queue" in names))

        run()           # MISS fills
        run()           # served on the dispatch thread, never queued
        run()           # the hit kept the index: served again
        run("alice")    # another principal is never served anonymous' entry
        _wait(coord.submit("insert into memory.default.sx values (3)", props))
        run()           # DML moved the version: MISS with fresh rows
        run()
        return out
    finally:
        coord.stop()


def test_serving_index_serves_and_invalidates():
    got = both(_serving_index)
    assert got == [
        ("MISS", [(2,)], 0, False, True),
        ("HIT", [(2,)], 1, True, False),
        ("HIT", [(2,)], 1, True, False),
        ("MISS", [(2,)], 0, False, True),
        ("MISS", [(3,)], 0, False, True),
        ("HIT", [(3,)], 1, True, False),
    ]


def _queue_span_and_serving_rows(pkg):
    coord = _coordinator(pkg)
    try:
        q = _wait(coord.submit("select 7", PROPS))
        names = {s["name"] for s in q.tracer.to_dicts()}
        rows = coord.dispatcher.serving_rows()
        return ("dispatch/queue" in names, sorted(r[0] for r in rows),
                {(r[1], r[2]) for r in rows})
    finally:
        coord.stop()


def test_dispatch_queue_span_and_serving_rows():
    in_trace, structures, owners = both(_queue_span_and_serving_rows)
    assert in_trace
    assert {"dispatch_queue", "executor_lanes", "serving_index", "result_cache", "plan_cache",
            "prepared_statements", "query_registry", "query_history", "device"} <= set(structures)
    assert owners == {("dispatch-process", "thread")}


def test_serving_index_unit():
    """Entries need versions, hits refresh recency, and the index is
    bounded; both packages keep the same entries."""
    def case(pkg):
        idx = pkg.dispatch.ServingIndex()
        p = {"catalog": "c", "schema": "s"}
        idx.note("u", p, "select 1", "k0", [])  # unversioned: never learned
        for i in range(idx.MAX_ENTRIES + 3):
            idx.note("u", p, f"select {i}", f"k{i}", [(("c", "s", "t"), "1")])
            if i == idx.MAX_ENTRIES - 1:
                assert idx.lookup("u", p, " select 0 ") is not None  # refresh recency
        out = [len(idx), idx.lookup("u", p, "select 0"), idx.lookup("u", p, "select 2"),
               idx.lookup("v", p, "select 5")]
        idx.forget("u", p, "select 0")
        out.append(idx.lookup("u", p, "select 0"))
        idx.clear()
        out.append(len(idx))
        return out

    got = both(case)
    assert got[0] == 512 and got[1] == ("k0", ((("c", "s", "t"), "1"),)) and got[2] is None
