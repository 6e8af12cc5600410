"""The compiled SPMD program of the port (trino_tpu_torch/parallel/mesh.py
``RankProgram``, parallel/spmd.py ``DistributedQuery``), on the CPU.

On CUDA a ``DistributedQuery`` warms each rank up eagerly, records the
rank's schedule of collectives (op, kind, bytes sent and received), checks
that every rank recorded the same one, captures the body as CUDA graph
segments cut at the collectives and replays them. The CPU has no graphs:
every run executes the body eagerly and records each rank's schedule,
which is what these tests hold on thread meshes over gloo at ``tiny``:
every rank records the same schedule and two runs record equal ones (Q3
with every exchange hashed, the same with the probe exchange overlapped,
Q18 and Q9 on four ranks, Q5 on eight), a forced regrowth records a new
schedule, a rank whose step differs fails the run naming the step, and
the rows equal the JAX ``DistributedQuery``'s on a CPU mesh of the same
width. One ``cuda``-marked test holds a replay to its warm-up on the card.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from trino_tpu import Session as JaxSession  # noqa: E402
from trino_tpu.exec.query import plan_sql as jax_plan_sql  # noqa: E402
from trino_tpu.parallel.spmd import DistributedQuery as JaxDQ  # noqa: E402
from trino_tpu.sql.planner import stats as jax_stats  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql  # noqa: E402
from trino_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from trino_tpu_torch.parallel import spmd  # noqa: E402
from trino_tpu_torch.parallel.mesh import OPS, Mesh, ScheduleError  # noqa: E402
from trino_tpu_torch.parallel.spmd import DistributedQuery  # noqa: E402
from trino_tpu_torch.sql.planner import stats as torch_stats  # noqa: E402

from tpch_sql import QUERIES  # noqa: E402

TINY = {"catalog": "tpch", "schema": "tiny"}
HASHED = {"GATHER_AGG_MAX_ROWS_PER_DEVICE": 8, "BROADCAST_BUILD_MAX": 8}
OVERLAP_BLOCKS = 4


@pytest.fixture(scope="module")
def meshes():
    """The port's thread meshes of width 4 and 8 (gloo, 60 s timeout)."""
    out = {w: Mesh.threads(w, "cpu", timeout_s=60) for w in (4, 8)}
    yield out
    for m in out.values():
        m.close()


@pytest.fixture()
def hashed(monkeypatch):
    """Every exchange a hash all-to-all, in both packages."""
    for mod in (jax_stats, torch_stats):
        for k, v in HASHED.items():
            monkeypatch.setattr(mod, k, v)


def jax_rows(sql, width, props=None, hints=None):
    """The JAX DistributedQuery's rows on ``width`` CPU devices."""
    js = JaxSession(dict(TINY, **(props or {})))
    root = jax_plan_sql(js, sql)
    mesh = JaxMesh(np.array(jax.devices()[:width]), ("d",))
    dq = JaxDQ.build(js, root, mesh, None if hints is None else hints(js, root, jax_stats, width))
    return dq.run().to_pylist(), dq.recompiles


def port_query(sql, mesh, props=None, hints=None):
    ts = TorchSession(dict(TINY, **(props or {})), device="cpu")
    root = plan_sql(ts, sql)
    return DistributedQuery.build(
        ts, root, mesh, None if hints is None else hints(ts, root, torch_stats, mesh.size))


def check_pairs(schedule):
    """Every ``wait`` joins an earlier ``start`` of its op, each start once."""
    starts = [i for i, s in enumerate(schedule) if s.kind == "start"]
    joined = [s.pair for s in schedule if s.kind == "wait"]
    assert sorted(joined) == starts
    for i, s in enumerate(schedule):
        if s.kind == "wait":
            assert s.pair < i and schedule[s.pair].op == s.op == "all_to_all"


def calls_by_op(schedule):
    """The collective calls a schedule makes, by op, as CollectiveStats
    counts them (an issued all-to-all counts at its join)."""
    out = dict.fromkeys(OPS, 0)
    for s in schedule:
        if s.kind != "start":
            out[s.op] += 1
    return out


@pytest.mark.parametrize("name,q,width,props", [
    ("q3_hashed", 3, 4, None),
    ("q3_hashed_overlapped", 3, 4, {"exchange_overlap_blocks": OVERLAP_BLOCKS}),
    ("q18", 18, 4, None),
    ("q9", 9, 4, None),
    ("q5_eight_ranks", 5, 8, None),
])
def test_every_rank_records_one_schedule(meshes, request, name, q, width, props):
    """Every rank records the same schedule, a second run records it
    again, the mesh's stats count exactly its calls, and the rows equal
    the JAX DistributedQuery's at the same width."""
    if name.startswith("q3_hashed"):
        request.getfixturevalue("hashed")
    mesh = meshes[width]
    dq = port_query(QUERIES[q], mesh, props)
    first = dq.run().to_pylist()
    sched = dict(dq.schedules)
    assert sorted(sched) == list(range(width))
    assert all(sched[r] == sched[0] for r in sched), name
    assert sched[0] and dq.recorded == [sched[0]]
    check_pairs(sched[0])
    before = mesh.stats.snapshot()["calls"]
    second = dq.run().to_pylist()
    after = mesh.stats.snapshot()["calls"]
    assert all(dq.schedules[r] == sched[r] for r in sched)
    assert dq.recorded == [sched[0]]  # the second run compiled nothing
    assert {op: after[op] - before[op] for op in OPS} == \
        {op: width * n for op, n in calls_by_op(sched[0]).items()}
    kinds = {(s.op, s.kind) for s in sched[0]}
    if name.startswith("q3_hashed"):
        assert ("all_to_all", "call") in kinds
    if name == "q3_hashed_overlapped":
        # each overlapped exchange: its first block in one call, then
        # every other block issued before the previous one is consumed
        n_starts = sum(1 for s in sched[0] if s.kind == "start")
        assert n_starts and n_starts % (OVERLAP_BLOCKS - 1) == 0, sched[0]
    want, jax_recompiles = jax_rows(QUERIES[q], width, props)
    assert first == second == want
    assert dq.recompiles == jax_recompiles


def _aggregate_hint_32(session, root, stats, width):
    """The estimated hints with the aggregation's hash exchange cut to 32
    send slots: Q3 hashed at tiny needs 64, so it regrows once."""
    hints = stats.estimate_capacity_hints(session, root)
    hints.update(stats.estimate_exchange_hints(session, root, width))
    assert sum(1 for k in hints if k.startswith("xchg:")) == 1, hints
    return {k: (32 if k.startswith("xchg:") else v) for k, v in hints.items()}


def test_forced_regrowth_records_a_new_schedule(meshes, hashed):
    """A capacity hint set too small overflows, the hint doubles and the
    run compiles again: one recompile, two recorded schedules that differ
    only in the regrown exchange's bytes (twice as many), and the rows and
    the regrowth count of the JAX DistributedQuery under the same hints."""
    dq = port_query(QUERIES[3], meshes[4], hints=_aggregate_hint_32)
    rows = dq.run().to_pylist()
    assert dq.recompiles == 1
    assert len(dq.recorded) == 2
    small, grown = dq.recorded
    assert len(small) == len(grown)
    diff = [(a, b) for a, b in zip(small, grown) if a != b]
    assert diff and all(a.op == b.op == "all_to_all" for a, b in diff), diff
    assert all(b.send_bytes == 2 * a.send_bytes and b.recv_bytes == 2 * a.recv_bytes
               for a, b in diff), diff
    assert all(dq.schedules[r] == grown for r in range(4))
    want, jax_recompiles = jax_rows(QUERIES[3], 4, hints=_aggregate_hint_32)
    assert rows == want and jax_recompiles == 1
    # the next run keeps the grown hint and records what the regrown run did
    assert dq.run().to_pylist() == want and dq.recompiles == 1
    assert dq.schedules[0] == grown


def test_schedule_mismatch_raises_naming_the_step(meshes, monkeypatch):
    """One rank recording a step unlike its peers' fails the run, on every
    rank, naming that step and the rank; the next run passes."""
    mesh = meshes[4]
    original = mesh_mod.RankProgram.record

    def skewed(self, step):
        if self.rank == 2 and len(self.schedule) == 1:
            step = mesh_mod.Step(step.op, step.kind, step.send_bytes + 8, step.recv_bytes,
                                 step.pair)
        original(self, step)

    monkeypatch.setattr(mesh_mod.RankProgram, "record", skewed)
    dq = port_query(QUERIES[3], mesh)
    with pytest.raises(ScheduleError, match=r"disagree at step 1: rank 0 .*, rank 2 "):
        dq.run()
    monkeypatch.undo()
    ts = TorchSession(dict(TINY), device="cpu")
    assert dq.run().to_pylist() == ts.execute(QUERIES[3]).rows
    assert len(dq.recorded) == 1


def test_agreeing_ranks_make_no_counted_collective(meshes):
    """The schedule check's own all-gathers are outside the schedule and
    the mesh's stats: a compiling run counts what its schedule holds."""
    mesh = meshes[4]
    dq = port_query(QUERIES[1], mesh)
    before = mesh.stats.snapshot()["calls"]
    dq.run()
    after = mesh.stats.snapshot()["calls"]
    (sched,) = dq.recorded
    assert {op: after[op] - before[op] for op in OPS} == \
        {op: 4 * n for op, n in calls_by_op(sched).items()}


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_replay_equals_the_warm_up_on_the_card(monkeypatch):
    """On a four-rank gloo mesh on the card: the first run warms up,
    captures and replays; a warm run builds no SpmdExecutor, replays every
    rank's segments, and its page equals the warm-up's bit for bit."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trino_tpu_torch.exec.page_tree import flatten_page

    for k, v in HASHED.items():
        monkeypatch.setattr(torch_stats, k, v)
    mesh = Mesh.threads(4, "cuda", timeout_s=60)
    try:
        ts = TorchSession(dict(TINY), device="cuda")
        dq = DistributedQuery.build(ts, plan_sql(ts, QUERIES[3]), mesh)
        cold = dq.run()
        built = []
        init = spmd.SpmdExecutor.__init__

        def counted(self, *a, **kw):
            built.append(1)
            init(self, *a, **kw)

        monkeypatch.setattr(spmd.SpmdExecutor, "__init__", counted)
        warm = dq.run()
        assert built == []
        assert len(dq.captures) == 4 and all(c["replays"] == 2 for c in dq.captures)
        assert all(c["segments"] == c["steps"] + 1 for c in dq.captures)
        for page in (cold, warm):
            (xa, sa), (xb, sb) = flatten_page(page), flatten_page(dq.warmup_page)
            assert len(xa) == len(xb) and all(torch.equal(a, b) for a, b in zip(xa, xb))
            assert [c.dictionary and c.dictionary.values for c in sa.col_specs] == \
                [c.dictionary and c.dictionary.values for c in sb.col_specs]
        assert warm.to_pylist() == ts.execute(QUERIES[3]).rows
        dq.close()
    finally:
        mesh.close()
