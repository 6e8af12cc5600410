"""The port's memory accounting and partitioned spill
(trino_tpu_torch/exec/memory.py and the executor's spill passes) against
the JAX package's (trino_tpu/exec/memory.py), at ``tiny`` on the CPU.

Both packages run each query under the same ``query_max_device_memory``
budget: a quarter of the largest working set the reference's unbudgeted
run handed its spill decision. The port must take the same spills (kind,
partitions and projected bytes) and return the reference's rows.
"""
import numpy as np
import pytest

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
from trino_tpu import types as JT
from trino_tpu.client.session import Session as JaxSession
from trino_tpu.devcache import DEVICE_CACHE as JAX_DEVICE_CACHE
from trino_tpu.exec import memory as jax_memory
from trino_tpu.exec.executor import Executor as JaxExecutor
from trino_tpu.exec.query import plan_sql as jax_plan_sql

from trino_tpu_torch import Session as TorchSession
from trino_tpu_torch import types as T
from trino_tpu_torch.data.page import to_numpy
from trino_tpu_torch.devcache import DEVICE_CACHE, HOST_CACHE
from trino_tpu_torch.exec import memory
from trino_tpu_torch.exec.executor import Executor
from trino_tpu_torch.exec.query import plan_sql
from trino_tpu_torch.obs import metrics as M


@pytest.fixture(autouse=True)
def fresh_caches():
    for c in (DEVICE_CACHE, HOST_CACHE, JAX_DEVICE_CACHE):
        c.invalidate_all()
    yield
    for c in (DEVICE_CACHE, HOST_CACHE, JAX_DEVICE_CACHE):
        c.invalidate_all()


@pytest.mark.parametrize("budget,projected", [
    (1000, 900), (1000, 1000), (1000, 1001), (1000, 1500), (1000, 7000),
    (1000, 64_000), (1000, 10**9), (None, 10**12), (0, 5)])
def test_memory_context_partition_choice(budget, projected):
    """The partition count (a power of two whose per-pass share fits) and
    the peak agree with the reference's for every budget."""
    port, ref = memory.MemoryContext(budget), jax_memory.MemoryContext(budget)
    assert port.spill_partitions(projected) == ref.spill_partitions(projected)
    assert port.peak == ref.peak


def test_cache_yields_under_spill_pressure():
    """A query over its budget reclaims the device cache's bytes before it
    partitions (the revocable tier), as in the reference."""
    s = TorchSession({"catalog": "memory", "schema": "db", "device_cache_enabled": True},
                     device="cpu")
    s.catalogs["memory"].create_table("db", "t", [("a", T.BIGINT)],
                                      [(i,) for i in range(1000)])
    s.execute("select sum(a) from t")
    assert DEVICE_CACHE.cached_bytes() > 0
    e0 = M.DEVICE_CACHE_EVICTIONS.value()
    ctx = memory.MemoryContext(budget_bytes=1024)
    assert ctx.spill_partitions(1 << 20) > 1
    assert DEVICE_CACHE.cached_bytes() == 0
    assert M.DEVICE_CACHE_EVICTIONS.value() > e0
    assert ctx.shed_bytes > 0 and ctx.yields == 1


def _keyed_rows():
    """Rows with NULL keys, negative and wide integers and a varchar."""
    rng = np.random.default_rng(11)
    rows = []
    for i in range(3000):
        k = None if i % 17 == 0 else int(rng.integers(-2**40, 2**40))
        rows.append((k, int(rng.integers(0, 50)), f"s{int(rng.integers(0, 40))}", i))
    return rows


def _key_table(conn, types_):
    conn.create_table("db", "k", [("k", types_.BIGINT), ("g", types_.BIGINT),
                                  ("v", types_.VARCHAR), ("i", types_.BIGINT)],
                      _keyed_rows())


def _live(page, host):
    """Each column's live values, in row order."""
    live = np.ones(page.num_rows, bool) if page.sel is None else host(page.sel)
    out = []
    for c in page.columns:
        vals = host(c.values)[live]
        nulls = None if c.nulls is None else host(c.nulls)[live]
        out.append((vals.tolist(), None if nulls is None else nulls.tolist()))
    return out


@pytest.mark.parametrize("channels,parts", [([0], 4), ([0, 1], 8), ([2], 4), ([1, 2], 2)])
def test_partition_page_host_equals_reference(channels, parts):
    """The same page partitioned on the host by the same keys gives the
    reference's partitions row for row (splitmix64 on uint64, NULL keys to
    one partition, dead rows dropped)."""
    sql = "select k, g, v, i from k where g < 40"  # a filter leaves dead rows
    ps = TorchSession({"catalog": "memory", "schema": "db"}, device="cpu")
    js = JaxSession({"catalog": "memory", "schema": "db"})
    _key_table(ps.catalogs["memory"], T)
    _key_table(js.catalogs["memory"], JT)
    page = Executor(ps).execute_checked(plan_sql(ps, sql))
    jpage = JaxExecutor(js).execute_checked(jax_plan_sql(js, sql))
    got = [_live(p, to_numpy) for p in memory.partition_page_host(page, channels, parts)]
    want = [_live(p, np.asarray)
            for p in jax_memory.partition_page_host(jpage, channels, parts)]
    assert len(got) == len(want) == parts
    assert got == want
    assert sum(len(p[0][0]) for p in got) == sum(1 for r in _keyed_rows() if r[1] < 40)
    assert all(len(p[0][0]) for p in got)  # every partition holds rows here


def _spy_projected(module):
    """Patch ``module.MemoryContext.spill_partitions`` to record the
    largest working set it is handed; returns (cell, undo)."""
    seen = [0]
    orig = module.MemoryContext.spill_partitions

    def spy(self, projected_bytes):
        seen[0] = max(seen[0], int(projected_bytes))
        return orig(self, projected_bytes)

    module.MemoryContext.spill_partitions = spy
    return seen, lambda: setattr(module.MemoryContext, "spill_partitions", orig)


def _run_jax(sql, props):
    seen, undo = _spy_projected(jax_memory)
    try:
        s = JaxSession(dict(props))
        ex = JaxExecutor(s)
        rows = ex.execute_checked(jax_plan_sql(s, sql)).to_pylist()
    finally:
        undo()
    return ex.memory, rows, seen[0]


def _run_port(sql, props):
    s = TorchSession(dict(props), device="cpu")
    ex = Executor(s)
    rows = ex.execute_checked(plan_sql(s, sql)).to_pylist()
    return ex.memory, rows


SEMI_SQL = ("select o_orderpriority, count(*) from orders where o_orderkey in "
            "(select l_orderkey from lineitem where l_quantity > 45) "
            "group by o_orderpriority order by o_orderpriority")


def _tpch(q):
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpch_sql import QUERIES

    return QUERIES[q]


@pytest.mark.parametrize("case,kinds", [
    ("q3", {"join"}),  # inner joins
    ("q18", {"aggregation"}),  # the grouped aggregation under a semi join
    ("q13", {"join", "aggregation"}),  # the left outer join
    ("semi", {"join"}),  # an IN subquery's semi join
])
@pytest.mark.parametrize("cache", [False, True])
def test_spill_rows_equal_reference(case, kinds, cache):
    """Under the reference's budget the port takes the same spills and
    returns the reference's rows, which equal the unbudgeted rows; with the
    cache on the spill first yields cached bytes."""
    sql = SEMI_SQL if case == "semi" else _tpch(int(case[1:]))
    props = {"catalog": "tpch", "schema": "tiny", "fused_join_pallas": True,
             "device_cache_enabled": cache}
    _mem, want, projected = _run_jax(sql, props)
    budget = projected // 4
    props["query_max_device_memory"] = budget
    jmem, ref, _ = _run_jax(sql, props)
    pmem, got = _run_port(sql, props)
    assert ref == want and got == ref
    spills = [(e.kind, e.partitions, e.projected_bytes) for e in pmem.spills]
    assert spills == [(e.kind, e.partitions, e.projected_bytes) for e in jmem.spills]
    assert {k for k, _, _ in spills} >= kinds
    assert max(p for _, p, _ in spills) >= 2
    assert (pmem.shed_bytes > 0) == cache  # the cached scans yielded first
