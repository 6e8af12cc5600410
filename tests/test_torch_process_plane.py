"""The port's executor-process plane (trino_tpu_torch/server/dispatch.py
``ProcessExecutorPlane``) against the JAX package's, on the CPU.

A port coordinator with ``executor_plane="process"`` and two executor
children (``python -m trino_tpu_torch.server.dispatch --device cpu``), one
in-process worker beside it so a bounced query can run on the dispatch
lane. The five process-plane cases of the reference's
tests/test_dispatch.py run against it with their own assertions, their rows
held against the JAX package's Session at tpch.tiny; then ``route_key`` on
a table of statements through both packages' planes (no process spawned),
a bounce, the children's device, the entry point on this box, shutdown,
and the fast-path predictor on the statements chip_smoke.py's phase
procplane routes.

The two filesystem cases need ``pyarrow`` and skip without it. The point
rows of chip_smoke.py's phase procplane at SF1 are written by

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_process_plane.py --write-expected

into trino_tpu_torch/testdata/procplane_sf1_expected.json (a few seconds). Rows cross
the JSON protocol (dates and decimals as strings, doubles rounded to 9
places, as tests/test_torch_cluster.py compares them).
"""
import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
from trino_tpu.client.session import Session as JaxSession

from tpch_sql import QUERIES  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROPS = {"catalog": "tpch", "schema": "tiny", "short_query_fast_path": "true"}
POINT = "select o_orderkey, o_totalprice from orders where o_orderkey = 7"


def rounded(rows):
    """Rows as the JSON protocol carries them: dates and decimals as
    strings, doubles rounded to 9 places."""
    import datetime
    import decimal

    def one(v):
        if isinstance(v, (datetime.date, datetime.datetime)):
            return v.isoformat()
        if isinstance(v, decimal.Decimal):
            return str(v)
        return round(v, 9) if isinstance(v, float) else v

    return [[one(v) for v in r] for r in rows]


def _wait(q, timeout=120.0):
    q.state.wait_for_terminal(timeout)
    assert q.state.get() == "FINISHED", q.failure
    return q


def jax_rows(sql, props=None):
    return rounded(JaxSession(dict(props or PROPS)).execute(sql).rows)


@pytest.fixture(scope="module")
def proc_coord(tmp_path_factory):
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer

    old = os.environ.get("TRINO_TPU_FS_ROOT")
    os.environ["TRINO_TPU_FS_ROOT"] = str(tmp_path_factory.mktemp("proclake"))
    coord = CoordinatorServer(device="cpu", executor_plane="process",
                              executor_processes=2)
    coord.start()
    worker = WorkerServer(coordinator_url=coord.base_url, node_id="w0", device="cpu")
    worker.start()
    try:
        coord.registry.wait_for_workers(1, timeout=15)
        yield coord
    finally:
        worker.stop()
        coord.stop()
        if old is None:
            os.environ.pop("TRINO_TPU_FS_ROOT", None)
        else:
            os.environ["TRINO_TPU_FS_ROOT"] = old


def _trace_span_ids(coord, query_id):
    from trino_tpu_torch.obs.trace import flatten_tree
    from trino_tpu_torch.server import wire

    trace = wire.json_request("GET", f"{coord.base_url}/v1/query/{query_id}/trace")
    return {n["spanId"] for n in flatten_tree(trace["root"])}


# ------------------------------------------------ the reference's five cases
def test_process_plane_point_query(proc_coord):
    coord = proc_coord
    q = _wait(coord.submit(POINT, PROPS))
    assert rounded(q.rows) == jax_rows(POINT) == [[7, "181354.35"]]
    assert q.plane.startswith("executor-process:")
    assert q.fast_path == "fast-path"
    assert q.extra_spans  # the child's span tree merged across the split
    assert {s["spanId"] for s in q.extra_spans} <= _trace_span_ids(coord, q.query_id)
    # the synthetic task slot of the forwarded query
    child = q.plane.split(":")[1]
    assert list(q.task_stats) == [f"{q.query_id}.0.proc{child}"]
    assert q.task_stats[f"{q.query_id}.0.proc{child}"]["taskId"].endswith(".a0")


def test_process_plane_prepared_zero_planning(proc_coord):
    """Sticky routing: the second EXECUTE lands on the child that holds
    the parameterized plan — no parse, analyze, plan or optimize work in
    another process, shown by the child's own spans."""
    coord = proc_coord
    _wait(coord.submit("PREPARE dp FROM select o_orderkey from orders "
                       "where o_orderkey = ?", PROPS))
    first = _wait(coord.submit("EXECUTE dp USING 7", PROPS))
    q = _wait(coord.submit("EXECUTE dp USING 32", PROPS))
    assert rounded(q.rows) == jax_rows("select o_orderkey from orders where o_orderkey = 32")
    assert q.plane.startswith("executor-process:") and q.plane == first.plane
    names = {s["name"] for s in q.extra_spans}
    assert "plan-cache/hit" in names and "prepare/bind" in names
    for absent in ("parse", "analyze/plan", "optimize"):
        assert absent not in names, names
    assert coord.prepared.get("anonymous", "dp") is not None


def test_process_plane_owner_catalog_bounces(proc_coord):
    """Memory and system state is owned by the dispatch process:
    statements touching it run on dispatch-side lanes, and the registry
    covers every query whatever plane ran it."""
    coord = proc_coord
    _wait(coord.submit("create table memory.default.pb (a bigint)", PROPS))
    _wait(coord.submit("insert into memory.default.pb values (5)", PROPS))
    q = _wait(coord.submit("select count(*) from memory.default.pb", PROPS))
    assert q.rows == [(1,)]
    assert q.plane == "dispatch-lane"
    q = _wait(coord.submit("select count(*) from system.runtime.queries", PROPS))
    assert q.rows[0][0] >= 4 and q.plane == "dispatch-lane"
    _wait(coord.submit(POINT, PROPS))
    planes = {e.plane for e in coord.queries.values()}
    assert any(p.startswith("executor-process") for p in planes)
    assert "dispatch-lane" in planes


def test_process_plane_dml_invalidation_crosses_processes(proc_coord):
    """Result-cache shards stay right across the split: the child's cached
    SELECT misses after the dispatch process runs DML, because the
    filesystem connector's data version (file mtime and size) is shared
    through the files themselves."""
    pytest.importorskip("pyarrow")
    coord = proc_coord
    props = {**PROPS, "result_cache_enabled": "true"}
    _wait(coord.submit("create table filesystem.lake.inv as select 1 as a", props))
    sql = "select count(*) from filesystem.lake.inv"
    q = _wait(coord.submit(sql, props))
    assert q.rows == [(1,)] and q.plane.startswith("executor-process:")
    assert q.cache_status == "MISS"
    q = _wait(coord.submit(sql, props))
    assert q.rows == [(1,)] and q.cache_status == "HIT"  # the child's shard
    _wait(coord.submit("insert into filesystem.lake.inv values (2)", props))
    q = _wait(coord.submit(sql, props))
    assert q.rows == [(2,)], "stale cross-process cache entry served"
    assert q.cache_status == "MISS"


def test_process_plane_deallocate_replicates(proc_coord):
    """DEALLOCATE on the authoritative registry replicates to the
    executor processes: a later EXECUTE fails loudly everywhere."""
    coord = proc_coord
    _wait(coord.submit("PREPARE ddp FROM select o_orderkey from orders "
                       "where o_orderkey = ?", PROPS))
    _wait(coord.submit("EXECUTE ddp USING 7", PROPS))
    _wait(coord.submit("DEALLOCATE PREPARE ddp", PROPS))
    q = coord.submit("EXECUTE ddp USING 7", PROPS)
    assert q.state.wait_for_terminal(120.0) == "FAILED"
    assert "prepared statement not found" in (q.failure or "")


# ------------------------------------------------------------------ a bounce
def test_two_stage_select_bounces_to_the_dispatch_lane(proc_coord):
    """Q3 at tiny is a two-stage plan: the child, which has no workers,
    fails it with "no alive workers" and the lane runs it on the dispatch
    coordinator's worker, with the reference's rows."""
    from trino_tpu_torch.obs import metrics as M

    coord = proc_coord
    before = {k: M.EXECUTOR_PLANE_QUERIES.value(k) for k in ("process", "inline", "bounced")}
    q = _wait(coord.submit(QUERIES[3], PROPS))
    assert rounded(q.rows) == jax_rows(QUERIES[3])
    assert q.plane == "dispatch-lane"
    assert {k: M.EXECUTOR_PLANE_QUERIES.value(k) - v for k, v in before.items()} == \
        {"process": 1, "inline": 0, "bounced": 1}
    fwd = [s for s in q.tracer.to_dicts() if s["name"] == "dispatch/forward"]
    assert any("no alive workers" in str(s["attributes"].get("bounced", ""))
               for s in fwd), fwd
    assert any(s["attributes"].get("bounced") is True for s in fwd)


# ------------------------------------------------------------ routing table
ROUTE_CASES = [
    ("select 1", "alice", {"catalog": "tpch", "schema": "tiny"}),
    ("  SELECT o_orderkey FROM orders", "alice", {"catalog": "tpch", "schema": "sf1"}),
    ("with t as (select 1 as x) select * from t", "bob", {"catalog": "tpch"}),
    ("values (1), (2)", "alice", {}),
    ("EXECUTE q1 USING 7", "alice", {"catalog": "tpch", "schema": "tiny"}),
    ("execute Q1", "bob", {}),
    ("insert into t values (1)", "alice", {"catalog": "tpch"}),
    ("PREPARE p FROM select 1", "alice", {}),
    ("select * from t", "alice", {"catalog": "memory", "schema": "default"}),
    ("select * from t", "alice", {"catalog": "System"}),
    ("select * from memory.default.t", "alice", {"catalog": "tpch"}),
    ("select count(*) from system . runtime.queries", "alice", {"catalog": "tpch"}),
    ("select * from nation", "alice", {"catalog": "tpch", "device_cache_enabled": "true"}),
    ("select * from nation", "alice", {"catalog": "tpch", "device_cache_enabled": True}),
    ("select * from nation", "alice", {"catalog": "tpch", "retry_policy": "task"}),
    ("select * from nation", "alice", {"catalog": "tpch", "retry_policy": "NONE"}),
    ("select * from nation", "alice", {"catalog": "tpch", "spooled_results_enabled": "1"}),
    ("select * from nation", "alice", {"catalog": "tpch", "spooled_results_enabled": "false"}),
    ("explain select 1", "alice", {}),
    ("selectivity", "alice", {}),
]


@pytest.mark.parametrize("sql,user,props", ROUTE_CASES)
def test_route_key_equals_the_reference(sql, user, props):
    from trino_tpu.server.dispatch import ProcessExecutorPlane as JaxPlane

    from trino_tpu_torch.server.dispatch import ProcessExecutorPlane

    execution = types.SimpleNamespace(sql=sql, user=user, session_properties=props)
    mine = ProcessExecutorPlane(None, 2, device="cpu").route_key(execution)
    assert mine == JaxPlane(None, 2).route_key(execution)


def test_route_key_sticks_to_one_child():
    from trino_tpu_torch.server.dispatch import ProcessExecutorPlane

    plane = ProcessExecutorPlane(None, 2, device="cpu")
    plane._children = [{"index": 0, "url": "a"}, {"index": 1, "url": "b"}]
    keys = [f"execute:u{i}:p" for i in range(16)]
    picks = [plane.child_for(k)["index"] for k in keys]
    assert picks == [plane.child_for(k)["index"] for k in keys] and set(picks) == {0, 1}


# --------------------------------------------------------- the child's device
def test_child_device(monkeypatch):
    """The children run on the dispatch coordinator's device unless
    TRINO_TPU_EXECPLANE_PLATFORMS names cpu or cuda; anything else raises."""
    from trino_tpu_torch.server.dispatch import ProcessExecutorPlane

    monkeypatch.delenv("TRINO_TPU_EXECPLANE_PLATFORMS", raising=False)
    on = types.SimpleNamespace
    assert ProcessExecutorPlane(on(device=torch.device("cpu"))).device == "cpu"
    assert ProcessExecutorPlane(on(device=torch.device("cuda"))).device == "cuda"
    assert ProcessExecutorPlane(on(device=torch.device("cuda", 0))).device == "cuda:0"
    monkeypatch.setenv("TRINO_TPU_EXECPLANE_PLATFORMS", "cpu")
    assert ProcessExecutorPlane(on(device=torch.device("cuda"))).device == "cpu"
    monkeypatch.setenv("TRINO_TPU_EXECPLANE_PLATFORMS", "CUDA")
    assert ProcessExecutorPlane(on(device=torch.device("cpu"))).device == "cuda"
    monkeypatch.setenv("TRINO_TPU_EXECPLANE_PLATFORMS", "tpu")
    with pytest.raises(ValueError, match="TRINO_TPU_EXECPLANE_PLATFORMS"):
        ProcessExecutorPlane(on(device=torch.device("cpu")))


def test_entry_point_refuses_cuda_without_a_gpu():
    """``executor_process_main(["--device", "cuda"])`` raises on a machine
    without a GPU rather than running on the CPU; run as ``python -m`` it
    exits non-zero, prints nothing on stdout (the parent would read it as
    the hello) and imports neither jax nor the JAX package."""
    from trino_tpu_torch.server.dispatch import executor_process_main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = sys.stdout
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        executor_process_main(["--device", "cuda"])
    assert sys.stdout is out
    code = ("import runpy, sys\n"
            "sys.argv = ['dispatch', '--device', 'cuda']\n"
            "try:\n"
            "    runpy.run_module('trino_tpu_torch.server.dispatch', run_name='__main__')\n"
            "except RuntimeError as e:\n"
            "    loaded = [m for m in sys.modules if m.split('.')[0] in ('jax', 'trino_tpu')]\n"
            "    sys.stderr.write(repr(loaded) + '\\n')\n"
            "    sys.exit(3 if loaded else 2)\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO
    done = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert (done.returncode, done.stdout) == (2, ""), done.stderr[-2000:]


# ------------------------------------------------------------------ shutdown
def test_stop_ends_every_child():
    from trino_tpu_torch.server.coordinator import CoordinatorServer

    coord = CoordinatorServer(device="cpu", executor_plane="process", executor_processes=2)
    coord.start()
    try:
        q = _wait(coord.submit("select count(*) from nation", PROPS))
        assert q.rows == [(25,)] and q.plane.startswith("executor-process:")
        plane = coord.dispatcher.process_plane
        pids = plane.children_pids()
        procs = [ch["proc"] for ch in plane._children]
        assert len(pids) == 2 and all(p.poll() is None for p in procs)
    finally:
        t0 = time.monotonic()
        coord.stop()
    assert time.monotonic() - t0 < 10.0 + 1.0
    assert all(p.poll() is not None for p in procs)
    for pid in pids:
        with pytest.raises(OSError):
            os.kill(pid, 0)
    assert plane.children_urls() == []


# ----------------------------------------------- what phase procplane routes
def test_predictor_agrees_with_the_fragmenter_on_the_routed_queries():
    """chip_smoke.py's phase procplane routes the point lookup, Q1 and Q6
    at SF1 under its session and expects Q3 to bounce: in both packages
    ``predicted_stage_count`` equals ``fragment_plan``'s stage count and
    the fast-path decision is the same (planning only, no data)."""
    import chip_smoke

    from trino_tpu.exec.query import plan_sql as jax_plan
    from trino_tpu.server.fastpath import fast_path_decision as jax_decision
    from trino_tpu.server.fastpath import predicted_stage_count as jax_predict
    from trino_tpu.sql.planner.fragmenter import fragment_plan as jax_fragment

    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.query import plan_sql
    from trino_tpu_torch.server.fastpath import fast_path_decision, predicted_stage_count
    from trino_tpu_torch.sql.planner.fragmenter import fragment_plan

    props = chip_smoke.procplane_props("sf1")
    js, ts = JaxSession(dict(props)), Session(dict(props), device="cpu")
    got = {}
    for name, sql in chip_smoke.procplane_queries(
            {str(q): {"sql": QUERIES[q]} for q in (1, 3, 6)}):
        jr, tr = jax_plan(js, sql), plan_sql(ts, sql)
        jstages, tstages = len(jax_fragment(jr, js)) - 1, len(fragment_plan(tr, ts)) - 1
        assert jax_predict(js, jr) == jstages and predicted_stage_count(ts, tr) == tstages
        assert fast_path_decision(ts, tr) == jax_decision(js, jr)
        got[name] = (tstages, fast_path_decision(ts, tr)[0])
    assert got == {"point": (1, True), "Q1": (1, True), "Q6": (1, True), "Q3": (3, False)}


# ------------------------------------------------------- chip_smoke's phase
EXPECTED = os.path.join(REPO, "trino_tpu_torch", "testdata", "procplane_sf1_expected.json")


def procplane_expected(schema):
    """The point rows of phase procplane by key, from the JAX package."""
    import chip_smoke

    s = JaxSession({"catalog": "tpch", "schema": schema})
    return {"sql": chip_smoke.PROCPLANE_PREPARED,
            "rows": {str(k): chip_smoke.jsonable_rows(s.execute(
                chip_smoke.PROCPLANE_PREPARED.replace("?", str(k))).rows)
                for k in chip_smoke.PROCPLANE_KEYS}}


def test_procplane_expected_is_the_reference():
    with open(EXPECTED) as f:
        assert json.load(f) == procplane_expected("sf1")


def test_chip_smoke_phase_procplane_at_tiny():
    """chip_smoke.py's phase procplane on the CPU at tiny, its rows the JAX
    package's at tiny (nvidia-smi and the card's memory are read on the
    card only)."""
    import chip_smoke

    s = JaxSession({"catalog": "tpch", "schema": "tiny"})
    expected = {str(q): {"sql": QUERIES[q], "rows": chip_smoke.jsonable_rows(
        s.execute(QUERIES[q]).rows)} for q in (1, 3, 6)}
    out = chip_smoke.phase_procplane(torch.device("cpu"), expected, procplane_expected("tiny"),
                                     "cpu", schema="tiny")
    assert out["launches"] == 0 and out["boot_s"] > 0
    assert {r["plane"] for r in out["routed"].values()} <= {"executor-process:0",
                                                            "executor-process:1"}
    assert [st["planes"] for st in out["concurrency_process"]] == \
        [["executor-process:0", "executor-process:1"]] * 2
    assert [st["planes"] for st in out["concurrency_thread"]] == [["dispatch-lane"]] * 2


if __name__ == "__main__" and "--write-expected" in sys.argv[1:]:
    sys.path.insert(0, REPO)
    with open(EXPECTED, "w") as f:
        json.dump(procplane_expected("sf1"), f, indent=1)
        f.write("\n")
    print("wrote", EXPECTED)
