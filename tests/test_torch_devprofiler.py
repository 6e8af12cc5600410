"""The port's device profiler (trino_tpu_torch/obs/devprofiler.py) held
against the JAX package's (trino_tpu/obs/devprofiler.py) on the same
inputs: ``merge_kernel_rows``, ``shape_signature`` over numpy arrays and
tensors of the same shapes and dtypes, the counters and the utilization
sampler, the bounded compile ring, and a tiny ``CompiledQuery`` run twice
(a ``miss`` then a ``hit`` under one fingerprint, as the reference's). Also
the executor's kernel ledger rows (the reference's shape, estimated unless
``device_profiling``) and the compiled tier's ``CompiledBody`` row. Times
are host clocks on the CPU and compared only for sign and order; every
other number exactly.
"""
import copy
import time

import numpy as np
import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
from trino_tpu.obs import devprofiler as jax_prof

from trino_tpu_torch.obs import devprofiler as torch_prof

TINY = {"catalog": "tpch", "schema": "tiny"}


def _rows(rng, n):
    """Seeded kernel rows over a few keys, some estimated."""
    ops = ("TableScan", "Filter", "Join", "Aggregation")
    return [{"planNodeId": str(int(rng.integers(0, 4))), "operator": ops[int(rng.integers(0, 4))],
             "tier": ("eager", "compiled")[int(rng.integers(0, 2))],
             "nodeId": ("", "w0", "w1")[int(rng.integers(0, 3))],
             "launches": int(rng.integers(0, 5)), "wallS": float(rng.random()),
             "deviceS": float(rng.random()) / 2, "inputBytes": int(rng.integers(0, 1 << 20)),
             "outputBytes": int(rng.integers(0, 1 << 20)),
             "estimated": bool(rng.random() < 0.3)} for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_kernel_rows_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    batches = [_rows(rng, int(rng.integers(1, 12))) for _ in range(4)]
    mine, ref = {}, {}
    for rows in batches:
        torch_prof.merge_kernel_rows(mine, copy.deepcopy(rows))
        jax_prof.merge_kernel_rows(ref, copy.deepcopy(rows))
    assert mine == ref
    # estimated is sticky: one estimated contribution marks the rollup
    for key, agg in mine.items():
        assert agg["estimated"] == any(
            r["estimated"] for rows in batches for r in rows
            if (r["planNodeId"], r["operator"], r["tier"], r["nodeId"]) == key)


SHAPES = [
    [((4, 2), np.float32), ((3,), np.int64)],
    [((4, 3), np.float32), ((3,), np.int64)],
    [((4, 2), np.float64), ((3,), np.int64)],
    [((), np.int32), ((0,), np.bool_), ((7, 1, 2), np.int16)],
    [((1024,), np.int32), ((1024,), np.bool_), ((1024,), np.float64), ((1024,), np.uint8)],
]


@pytest.mark.parametrize("spec", SHAPES)
def test_shape_signature_equals_the_reference(spec):
    arrays = [np.zeros(shape, dtype) for shape, dtype in spec]
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    want = jax_prof.shape_signature(arrays)
    assert torch_prof.shape_signature(arrays) == want
    # a tensor signs as the numpy array of its shape and dtype does
    assert torch_prof.shape_signature(tensors) == want
    assert want.endswith(f":{len(spec)}")


def test_shape_signatures_tell_shapes_and_dtypes_apart():
    sigs = {torch_prof.shape_signature([np.zeros(s, d) for s, d in spec]) for spec in SHAPES}
    assert len(sigs) == len(SHAPES)


def test_counters_and_utilization_sampler_as_the_reference():
    mine, ref = torch_prof.DeviceProfiler(node_id="n1"), jax_prof.DeviceProfiler(node_id="n1")
    for p in (mine, ref):
        p.count_launch(0.01, 0.0)  # no measured busy: the wall is charged
        p.count_launch(0.02, 0.005, n=3)  # measured busy wins
    assert mine.counters() == ref.counters()
    assert mine.counters()["launchesTotal"] == 4
    assert mine.counters()["busySTotal"] == pytest.approx(0.015)
    first = mine.sample_utilization()
    assert first["nodeId"] == "n1" and first["launchesPerS"] == 0.0
    assert set(first) == set(ref.sample_utilization())
    time.sleep(0.02)
    mine.count_launch(0.001, 0.001)
    second = mine.sample_utilization()
    assert second["launchesTotal"] == 5 and second["launchesPerS"] > 0
    assert 0.0 <= second["busyFraction"] <= 1.0
    assert mine.utilization_rows() == [first, second]
    assert mine.utilization_rows(limit=1) == [second]


def test_bounded_compile_ring_as_the_reference():
    mine = torch_prof.DeviceProfiler(node_id="n1", compile_capacity=4)
    ref = jax_prof.DeviceProfiler(node_id="n1", compile_capacity=4)
    for p in (mine, ref):
        p.compile_started()
        assert p.counters()["compileInflight"] == 1
        for i in range(6):
            p.record_compile("compiled", f"fp{i}", "sig:1", 0.1, "miss", query_id=f"q{i % 2}",
                             started=(i == 0))
    drop = ("ts",)
    assert [{k: v for k, v in r.items() if k not in drop} for r in mine.compile_rows()] == \
        [{k: v for k, v in r.items() if k not in drop} for r in ref.compile_rows()]
    assert [r["fingerprint"] for r in mine.compile_rows()] == ["fp2", "fp3", "fp4", "fp5"]
    assert [r["fingerprint"] for r in mine.compile_rows(query_id="q1")] == ["fp3", "fp5"]
    assert mine.compile_rows(limit=1)[0]["fingerprint"] == "fp5"
    assert mine.counters() == ref.counters()
    assert mine.counters()["compileInflight"] == 0 and mine.counters()["compilesTotal"] == 6
    assert len(mine) == 4


def test_query_fold_kernel_rows_and_snapshot_as_the_reference():
    from trino_tpu_torch.obs import metrics as M

    rng = np.random.default_rng(7)
    rows = _rows(rng, 10)
    mine, ref = torch_prof.DeviceProfiler(node_id="c"), jax_prof.DeviceProfiler(node_id="c")
    l0 = M.KERNEL_LAUNCHES.value("Join")
    for p in (mine, ref):
        p.record_query_kernels("q1", copy.deepcopy(rows))
        p.record_query_kernels("q2", copy.deepcopy(rows[:3]), node_id="w9")
    assert mine.kernel_rows() == ref.kernel_rows()
    assert mine.kernel_rows("q2") == ref.kernel_rows("q2")
    assert M.KERNEL_LAUNCHES.value("Join") - l0 == sum(
        r["launches"] for r in rows + rows[:3] if r["operator"] == "Join")
    snap = mine.profile_snapshot("q1")
    assert snap["nodeId"] == "c" and snap["kernels"] == mine.kernel_rows("q1")
    assert all(r["dispatchOverheadS"] >= 0 for r in snap["kernels"])


COMPILED_SQL = ("select o_orderstatus, count(*), sum(o_totalprice) from orders "
                "group by o_orderstatus")


def test_compiled_query_run_twice_misses_then_hits_as_the_reference():
    """One CompiledQuery of each package run twice: a miss, then a hit with
    0 compile seconds under the same fingerprint. The plans canonicalize to
    the same text, so the two packages' fingerprints are equal too."""
    from trino_tpu.client.session import Session as JaxSession
    from trino_tpu.exec.compiled import CompiledQuery as JaxCompiled
    from trino_tpu.exec.query import plan_sql as jax_plan

    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.compiled import CompiledQuery
    from trino_tpu_torch.exec.query import plan_sql

    events = {}
    for name, prof, build, session in (
            ("torch", torch_prof.DEVICE_PROFILER,
             lambda s: CompiledQuery.build(s, plan_sql(s, COMPILED_SQL)),
             Session(dict(TINY), device="cpu")),
            ("jax", jax_prof.DEVICE_PROFILER,
             lambda s: JaxCompiled.build(s, jax_plan(s, COMPILED_SQL)), JaxSession(dict(TINY)))):
        cq = build(session)
        got = []
        for _ in range(2):
            ts0 = time.time()  # the ring is bounded: take the run's events by time
            rows = cq.run().to_pylist()
            got.append([e for e in prof.compile_rows() if e["ts"] >= ts0])
        events[name] = (got, sorted(rows))
    (first, second), rows = events["torch"]
    assert [e["cache"] for e in first] == ["miss"] and [e["cache"] for e in second] == ["hit"]
    assert first[0]["tier"] == "compiled" and first[0]["shapeSig"]
    assert second[0]["compileS"] == 0.0
    assert second[0]["fingerprint"] == first[0]["fingerprint"]
    (jfirst, jsecond), jrows = events["jax"]
    assert [e["cache"] for e in jfirst + jsecond] == ["miss", "hit"]
    assert first[0]["fingerprint"] == jfirst[0]["fingerprint"]
    assert len(rows) == len(jrows) == 3


def test_compiled_body_row_and_device_profiling():
    """The CompiledBody row counts the runs; without device_profiling it is
    estimated (a capturing run charges no device seconds), with it on the
    CPU the body's wall is its device time."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.compiled import CompiledQuery
    from trino_tpu_torch.exec.query import plan_sql

    for props, estimated in ((TINY, True), (dict(TINY, device_profiling=True), False)):
        s = Session(dict(props), device="cpu")
        cq = CompiledQuery.build(s, plan_sql(s, COMPILED_SQL))
        c0 = torch_prof.DEVICE_PROFILER.counters()["launchesTotal"]
        for _ in range(3):
            cq.run()
        (row,) = cq.kernel_stats.values()
        assert row["operator"] == "CompiledBody" and row["tier"] == "compiled"
        assert row["planNodeId"] == str(cq.root.id)
        assert row["launches"] == 3 and row["estimated"] is estimated
        assert 0.0 <= row["deviceS"] and row["wallS"] >= 0.0
        if not estimated:
            assert row["deviceS"] > 0 and row["deviceS"] <= row["wallS"] + 1e-9
        assert torch_prof.DEVICE_PROFILER.counters()["launchesTotal"] - c0 == 3


def test_eager_kernel_rows_in_the_reference_shape():
    """A plain eager query keeps kernel rows with every key of the
    reference's row (estimated, one launch a node execution) and no
    per-operator stats; device_profiling turns the stats on and measures."""
    from trino_tpu.client.session import Session as JaxSession
    from trino_tpu.exec.executor import Executor as JaxExecutor
    from trino_tpu.exec.query import plan_sql as jax_plan

    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.executor import Executor
    from trino_tpu_torch.exec.query import plan_sql

    sql = "select l_returnflag, count(*) from lineitem where l_quantity < 10 group by 1"
    s = Session(dict(TINY), device="cpu")
    ex = Executor(s)
    ex.execute_checked(plan_sql(s, sql))
    assert not ex.collect_stats and not ex.node_stats
    js = JaxSession(dict(TINY))
    jex = JaxExecutor(js)
    jex.execute_checked(jax_plan(js, sql))
    assert [set(r) for r in ex.kernel_stats.values()] == \
        [set(r) for r in jex.kernel_stats.values()]
    assert [(r["operator"], r["tier"], r["launches"], r["estimated"])
            for r in ex.kernel_stats.values()] == \
        [(r["operator"], r["tier"], r["launches"], r["estimated"])
         for r in jex.kernel_stats.values()]
    assert all(r["deviceS"] == pytest.approx(r["wallS"]) for r in ex.kernel_stats.values())
    sp = Session(dict(TINY, device_profiling=True), device="cpu")
    exp = Executor(sp)
    exp.execute_checked(plan_sql(sp, sql))
    assert exp.collect_stats and exp.node_stats
    assert all(r["estimated"] is False and r["deviceS"] <= r["wallS"] + 1e-9
               for r in exp.kernel_stats.values())
