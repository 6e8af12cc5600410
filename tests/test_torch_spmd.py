"""The port's SPMD tier (trino_tpu_torch/parallel/spmd.py) against the JAX
package's, on the CPU.

The JAX ``DistributedQuery`` runs on the conftest's CPU mesh
(``jax.devices()[:W]``), the port's on a thread mesh of the same width
(parallel/mesh.py: gloo over one ``HashStore``, one thread a rank, a 60 s
group timeout), W = 4 and one W = 8 case. Rows must be exact, and the join
tiers, the exchange hints (node ids as plan positions) and the regrowths
equal. The cases are the reference's tests/test_distributed.py,
test_distributed_breadth.py, the mesh cases of test_set_operations.py,
test_window.py, test_adaptive.py (the exchange half of the reseed),
test_two_phase_df.py, test_aggregate_breadth.py, test_int128_storage.py,
test_sketch_aggregates.py and test_functions.py, and
``__graft_entry__.dryrun_multichip``'s three
plans; the overlapped exchange's cases (test_overlapped_exchange.py); then
the port's own: a rank that raises mid-query ends its run at once and the
mesh runs again, the profiler's ``spmd`` tier, the device cache's
``spmd:<n>`` key, and two processes under ``init_process_group``.

Phase spmd of chip_smoke.py holds the port on the card to what the JAX
``DistributedQuery`` selects at SF1 on a 4-device CPU mesh:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_spmd.py --write-expected

writes trino_tpu_torch/testdata/spmd_sf1_expected.json (the 22 TPC-H
queries, the dry run's three plans and a 1-device mesh's Q1, Q3 and Q18:
join tiers, exchange hints, regrowths, row counts, refusals).
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from decimal import Decimal

if __name__ == "__main__":  # the writer runs outside pytest's conftest
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from trino_tpu import Session as JaxSession  # noqa: E402
from trino_tpu import types as JT  # noqa: E402
from trino_tpu.exec.query import plan_sql as jax_plan_sql  # noqa: E402
from trino_tpu.obs import metrics as JM  # noqa: E402
from trino_tpu.parallel.spmd import DistributedQuery as JaxDQ  # noqa: E402
from trino_tpu.sql.planner import plan as JP  # noqa: E402
from trino_tpu.sql.planner import stats as jax_stats  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch import types as TT  # noqa: E402
from trino_tpu_torch.exec.executor import QueryError  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql  # noqa: E402
from trino_tpu_torch.obs import metrics as TM  # noqa: E402
from trino_tpu_torch.parallel import spmd  # noqa: E402
from trino_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from trino_tpu_torch.parallel.spmd import DistributedQuery  # noqa: E402
from trino_tpu_torch.sql.planner import plan as TP  # noqa: E402
from trino_tpu_torch.sql.planner import stats as torch_stats  # noqa: E402

from test_torch_repartition import xchg_shape  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIERS = ("dense", "fused", "merge-sorted", "merge-pallas", "legacy")

Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity) q, avg(l_extendedprice) p,
       count(*) c
from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus order by 1, 2
"""

Q3 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15' and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10
"""

Q18 = """
select c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (
        select l_orderkey from lineitem group by l_orderkey
        having sum(l_quantity) > 300)
  and c_custkey = o_custkey and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate limit 100
"""

Q_MN = """
select n1.n_name a, n2.n_name b from nation n1, nation n2
where n1.n_regionkey = n2.n_regionkey and n1.n_nationkey < n2.n_nationkey
order by 1, 2
"""

Q13 = """
select c_count, count(*) as custdist
from (
    select c_custkey, count(o_orderkey) as c_count
    from customer left outer join orders on
        c_custkey = o_custkey and o_comment not like '%special%requests%'
    group by c_custkey
    ) as c_orders (c_custkey, c_count)
group by c_count
order by custdist desc, c_count desc
"""

Q21_CORE = """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey
    and o_orderkey = l1.l_orderkey
    and o_orderstatus = 'F'
    and l1.l_receiptdate > l1.l_commitdate
    and exists (
        select * from lineitem l2
        where l2.l_orderkey = l1.l_orderkey
            and l2.l_suppkey <> l1.l_suppkey)
    and not exists (
        select * from lineitem l3
        where l3.l_orderkey = l1.l_orderkey
            and l3.l_suppkey <> l1.l_suppkey
            and l3.l_receiptdate > l3.l_commitdate)
    and s_nationkey = n_nationkey
    and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
"""

EMP_ROWS = []
_rng = np.random.default_rng(11)
for _i in range(200):
    EMP_ROWS.append((_i, int(_rng.integers(0, 6)), int(_rng.integers(1000, 9000)),
                     None if _i % 23 == 0 else int(_rng.integers(0, 50))))


@pytest.fixture(scope="module")
def meshes():
    """The JAX and the port meshes of width 4 and 8."""
    out = {w: (JaxMesh(np.array(jax.devices()[:w]), ("d",)),
               Mesh.threads(w, "cpu", timeout_s=60)) for w in (4, 8)}
    yield out
    for _jm, tm in out.values():
        tm.close()


def _tiers(metric):
    return {t: metric.value(t) for t in TIERS}


def both(sql, meshes, w=4, props=None, tables=(), hints=None):
    """The SQL through both DistributedQuerys on width ``w``: (JAX dq, JAX
    rows, JAX tier counts, port dq, port rows, port tier counts).
    ``hints(session, root, stats module)`` gives each build's hints."""
    props = dict({"catalog": "tpch", "schema": "tiny"}, **(props or {}))
    js, ts = JaxSession(dict(props)), TorchSession(dict(props), device="cpu")
    for name, cols_j, cols_t, rows in tables:
        js.catalogs["memory"].create_table("t", name, cols_j, rows)
        ts.catalogs["memory"].create_table("t", name, cols_t, rows)
    jm, tm = meshes[w]
    out = []
    for S, plan, DQ, M, mesh, st in ((js, jax_plan_sql, JaxDQ, JM, jm, jax_stats),
                                    (ts, plan_sql, DistributedQuery, TM, tm, torch_stats)):
        before = _tiers(M.FUSED_JOIN_SELECTIONS)
        root = plan(S, sql)
        dq = DQ.build(S, root, mesh, None if hints is None else hints(S, root, st))
        rows = dq.run().to_pylist()
        after = _tiers(M.FUSED_JOIN_SELECTIONS)
        out.extend([dq, rows, {t: after[t] - before[t] for t in TIERS if after[t] != before[t]}])
    return out


def check(sql, meshes, w=4, props=None, tables=(), hint=None):
    """Rows exact, tiers, exchange hints and regrowths equal; returns the
    port's dq and rows."""
    jdq, want, jt, tdq, got, tt = both(sql, meshes, w, props, tables)
    assert got == want, f"port {got[:3]} != reference {want[:3]}"
    assert tt == jt
    assert xchg_shape(tdq, TP.walk_plan) == xchg_shape(jdq, JP.walk_plan)
    assert tdq.recompiles == jdq.recompiles
    if hint is not None:
        assert any(k.startswith(hint) for k in tdq.capacity_hints), tdq.capacity_hints
    return tdq, got


# ------------------------------------------- tests/test_distributed.py
@pytest.mark.parametrize(
    "sql", [Q1, Q3, Q18, Q_MN, Q13, Q21_CORE],
    ids=["q1", "q3", "q18", "mn_join", "q13_left_mn", "q21_filtered_exists"])
def test_distributed_matches_reference(meshes, sql):
    _dq, got = check(sql, meshes)
    assert got == TorchSession({"catalog": "tpch", "schema": "tiny"},
                               device="cpu").execute(sql).rows


def test_uneven_splits_on_eight_ranks(meshes):
    # nation's 25 rows over 8 ranks: unequal shards exercise the padding
    check("select n_regionkey, count(*) from nation group by n_regionkey order by 1",
          meshes, w=8)


def test_distributed_no_exchange_query(meshes):
    # a scan/filter/project-only plan needs the final gather, not rank 0's shard
    jdq, want, _jt, tdq, got, _tt = both(
        "select n_name from nation where n_regionkey = 1", meshes)
    assert sorted(got) == sorted(want) and len(got) == 5


def test_distributed_error_on_any_shard(meshes):
    props = {"catalog": "tpch", "schema": "tiny"}
    ts = TorchSession(props, device="cpu")
    dq = DistributedQuery.build(ts, plan_sql(ts, "select 10/(n_nationkey-10) from nation"),
                                meshes[4][1])
    with pytest.raises(QueryError, match="Division by zero"):
        dq.run()


@pytest.fixture()
def xchg_props():
    # gather_max_rows_per_device=1 forces the exchange paths at tiny scale
    return {"gather_max_rows_per_device": 1}


def test_sharded_order_by_never_gathers_unsorted(meshes, xchg_props):
    """A full ORDER BY range-partitions by sampled splitters (hint
    ``xchgo:``) and sorts the shards locally."""
    check("""select l_orderkey, l_extendedprice from lineitem where l_orderkey < 600
             order by l_extendedprice desc, l_orderkey""", meshes, props=xchg_props,
          hint="xchgo:")


def test_repartitioned_window(meshes, xchg_props):
    check("""select o_custkey, o_orderkey,
                    rank() over (partition by o_custkey order by o_totalprice desc) r
             from orders where o_orderkey < 800 order by o_custkey, r, o_orderkey""",
          meshes, props=xchg_props, hint="xchgw:")


def test_repartitioned_set_op(meshes, xchg_props):
    jdq, want, _jt, tdq, got, _tt = both(
        """select o_custkey from orders where o_orderkey < 600
           intersect select c_custkey from customer""", meshes, props=xchg_props)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("xchgs:") for k in tdq.capacity_hints)


# ------------------------------------ tests/test_distributed_breadth.py
def test_unnest_on_mesh(meshes):
    _dq, got = check("""select n_name, u from nation
                        cross join unnest(array[n_nationkey, n_regionkey]) as t(u)
                        where n_regionkey = 1 order by n_name, u""", meshes)
    assert len(got) == 10


def test_map_agg_on_mesh(meshes):
    _dq, got = check("""select r_name, map_agg(n_name, n_nationkey) m
                        from nation, region where n_regionkey = r_regionkey
                        group by r_name order by r_name""", meshes)
    assert got[0][0] == "AFRICA" and len(got[0][1]) == 5


def test_int128_sum_on_mesh(meshes):
    _dq, got = check("""select sum(cast(o_totalprice as decimal(38,2)) * 100000000000) s
                        from orders""", meshes)
    assert abs(int(got[0][0] * 100)) > 2**63


def test_window_frame_on_mesh(meshes):
    check("""select n_regionkey, n_name,
                    sum(n_nationkey) over (partition by n_regionkey order by n_name
                                           rows between 1 preceding and 1 following) w
             from nation order by n_regionkey, n_name""", meshes)


def test_grouping_sets_on_mesh(meshes):
    check("""select n_regionkey, count(*) c from nation
             group by rollup(n_regionkey) order by n_regionkey""", meshes)


# ------------- mesh cases of the aggregate, int128, sketch and function tests
_AGG_ROWS = [(i % 3, i * 7 % 11) for i in range(64)]
_WIDE_ROWS = [(i % 3, Decimal("9" * 19) if i % 2 == 0 else Decimal(i)) for i in range(48)]


@pytest.mark.parametrize("sql,tables,w", [
    ("select g, min_by(x, x), bool_and(x > 0) from memory.t.d group by g order by g",
     [("d", [("g", JT.BIGINT), ("x", JT.BIGINT)], [("g", TT.BIGINT), ("x", TT.BIGINT)],
       _AGG_ROWS)], 4),
    ("select g, sum(v) from memory.t.w group by g order by g",
     [("w", [("g", JT.BIGINT), ("v", JT.decimal(38, 0))],
       [("g", TT.BIGINT), ("v", TT.decimal(38, 0))], _WIDE_ROWS)], 4),
    ("""select l_returnflag, approx_percentile(l_extendedprice, 0.5) from lineitem
        group by l_returnflag order by l_returnflag""", [], 8),
    ("""select n_regionkey, stddev(n_nationkey), var_pop(n_nationkey) from nation
        group by n_regionkey order by 1""", [], 8),
], ids=["min_by_bool_and", "int128_grouped_sum", "approx_percentile", "variance"])
def test_aggregate_mesh_cases(meshes, sql, tables, w):
    """test_aggregate_breadth.py, test_int128_storage.py,
    test_sketch_aggregates.py and test_functions.py's mesh cases."""
    check(sql, meshes, w=w, tables=tables)


# --------------------- mesh cases of set operations, windows, two-phase DF
def test_union_distributed_matches_reference(meshes):
    check("""select n_regionkey from nation where n_nationkey < 10
             union select r_regionkey from region order by n_regionkey""", meshes)


def test_intersect_distributed_matches_reference(meshes):
    check("""select c_nationkey from customer intersect select s_nationkey from supplier
             order by c_nationkey""", meshes)


def test_distributed_window_matches_reference(meshes):
    cols_j = [("id", JT.BIGINT), ("dept", JT.BIGINT), ("salary", JT.BIGINT),
              ("bonus", JT.BIGINT)]
    cols_t = [("id", TT.BIGINT), ("dept", TT.BIGINT), ("salary", TT.BIGINT),
              ("bonus", TT.BIGINT)]
    check("""select id, rank() over (partition by dept order by salary desc, id),
                    sum(salary) over (partition by dept order by id)
             from memory.t.emp order by id""", meshes,
          tables=[("emp", cols_j, cols_t, EMP_ROWS)])


def test_spmd_staging_narrows(meshes):
    """Phase 1's domains narrow lineitem's staging below a fifth of it."""
    ts = TorchSession(device="cpu")
    root = plan_sql(ts, Q3)
    dq = DistributedQuery.build(ts, root, meshes[4][1])
    narrowed = {n.table: n.runtime_rows for n in TP.walk_plan(root)
                if isinstance(n, TP.TableScanNode)}
    assert narrowed["lineitem"] < 59837 / 5
    assert dq.run().to_pylist() == ts.execute(Q3).rows


def test_spmd_multistage_reseed_zero_recompiles(meshes, monkeypatch):
    """Understated exchange hints regrow in both packages alike; under
    ``adaptive_capacity_reseed`` the send blocks are priced from the
    staged keys: no regrowth, the reference's hints."""
    for mod in (jax_stats, torch_stats):
        monkeypatch.setattr(mod, "BROADCAST_BUILD_MAX", 64)
    sql = """select c_mktsegment, count(*) c, sum(o_totalprice) s
             from customer, orders where c_custkey = o_custkey
             group by c_mktsegment order by 1"""

    def understated(session, root, stats):
        hints = stats.estimate_capacity_hints(session, root)
        hints.update(stats.estimate_exchange_hints(session, root, 4))
        return {k: (128 if k.startswith("xchg") else v) for k, v in hints.items()}

    for reseed, regrows in ((False, True), (True, False)):
        props = {"adaptive_capacity_reseed": True} if reseed else {}
        jdq, want, _jt, tdq, got, _tt = both(sql, meshes, props=props, hints=understated)
        assert got == want
        assert tdq.recompiles == jdq.recompiles
        assert (tdq.recompiles >= 1) == regrows
        assert xchg_shape(tdq, TP.walk_plan) == xchg_shape(jdq, JP.walk_plan)


# -------------------------------- __graft_entry__.py dryrun_multichip
def test_dryrun_multichip_plans(meshes, monkeypatch):
    """Q3 with the default thresholds, Q3 with every exchange hashed
    (thresholds 8) and Q18's semi-join build: rows, tiers and hints as the
    reference's on 4 ranks."""
    check(Q3, meshes)
    for mod in (jax_stats, torch_stats):
        monkeypatch.setattr(mod, "GATHER_AGG_MAX_ROWS_PER_DEVICE", 8)
        monkeypatch.setattr(mod, "BROADCAST_BUILD_MAX", 8)
    dq, _ = check(Q3, meshes, hint="xchg")
    assert sum(1 for k in dq.capacity_hints if k.startswith("xchg")) == 5
    monkeypatch.undo()
    check(Q18, meshes)


# ------------------------------------ tests/test_overlapped_exchange.py
OVERLAP_BLOCKS = 4


def _overlap_tables():
    rng = np.random.default_rng(5)
    orders = [(i, int(rng.integers(0, 200))) for i in range(1200)]
    customer = [(i, i * 10) for i in range(200)]
    return [("orders", [("ok", JT.BIGINT), ("ck", JT.BIGINT)],
             [("ok", TT.BIGINT), ("ck", TT.BIGINT)], orders),
            ("customer", [("ck", JT.BIGINT), ("v", JT.BIGINT)],
             [("ck", TT.BIGINT), ("v", TT.BIGINT)], customer)]


def _pages_equal(p0, p1):
    assert len(p0.columns) == len(p1.columns)
    for c0, c1 in zip(p0.columns, p1.columns):
        assert np.array_equal(np.asarray(c0.values), np.asarray(c1.values))
        assert (c0.nulls is None) == (c1.nulls is None)
        if c0.nulls is not None:
            assert np.array_equal(np.asarray(c0.nulls), np.asarray(c1.nulls))
    assert (p0.sel is None) == (p1.sel is None)
    if p0.sel is not None:
        assert np.array_equal(np.asarray(p0.sel), np.asarray(p1.sel))


@pytest.mark.parametrize("kind,sql", [
    ("lookup", """select c_custkey, o_orderkey from customer, orders
       where c_custkey = o_custkey and o_totalprice > 100000
       order by o_orderkey limit 50"""),
    ("semi", """select o.ok from orders o where o.ck in
       (select ck from customer where v > 500) order by o.ok limit 40"""),
])
def test_overlapped_exchange_bit_identical(meshes, kind, sql):
    """The overlapped exchange's page equals the one-shot run's bit for
    bit in the port, as in the reference, and both packages' rows agree;
    the counter moves once a query, and only with the blocks set."""
    if kind == "lookup":
        base, tables = {"catalog": "tpch", "schema": "tiny", "join_max_broadcast_rows": 1}, ()
    else:
        base = {"catalog": "memory", "schema": "t", "join_max_broadcast_rows": 1,
                "gather_max_rows_per_device": 1}
        tables = _overlap_tables()
    key = str(OVERLAP_BLOCKS)
    pages = {}
    for blocks in (0, OVERLAP_BLOCKS):
        props = dict(base, **({"exchange_overlap_blocks": blocks} if blocks else {}))
        ts = TorchSession(dict(props), device="cpu")
        for name, _cj, cols_t, rows in tables:
            ts.catalogs["memory"].create_table("t", name, cols_t, rows)
        before = TM.EXCHANGE_OVERLAPPED.value(key)
        pages[blocks] = DistributedQuery.build(ts, plan_sql(ts, sql), meshes[4][1]).run()
        assert TM.EXCHANGE_OVERLAPPED.value(key) - before == (1 if blocks else 0)
    _pages_equal(pages[0], pages[OVERLAP_BLOCKS])
    props = dict(base, exchange_overlap_blocks=OVERLAP_BLOCKS)
    _jdq, want, _jt, _tdq, got, _tt = both(sql, meshes, props=props, tables=tables)
    assert got == want == pages[0].to_pylist()


# ------------------------------------------------------- the port's own
def test_failing_rank_ends_the_run_and_the_mesh_recovers(meshes, monkeypatch):
    """A rank that raises mid-query (after the others entered a
    collective) fails the run with its own exception well inside the
    group's 60 s timeout; the next run rebuilds the groups and passes."""
    mesh = meshes[4][1]
    ts = TorchSession(device="cpu")
    original = spmd.SpmdExecutor.aggregate_page

    def failing(self, node, page):
        if self.comm.rank == 2:
            time.sleep(0.2)  # the other ranks are waiting in a gather
            raise RuntimeError("rank 2 failed on purpose")
        return original(self, node, page)

    monkeypatch.setattr(spmd.SpmdExecutor, "aggregate_page", failing)
    dq = DistributedQuery.build(ts, plan_sql(ts, Q1), mesh)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 failed on purpose"):
        dq.run()
    assert time.monotonic() - t0 < mesh.timeout_s / 2
    monkeypatch.undo()
    assert dq.run().to_pylist() == ts.execute(Q1).rows


def test_profiler_records_the_spmd_tier(meshes):
    """Each run is a compile-ledger event of tier ``spmd`` (a miss, then
    hits) and one launch of the query's ``SpmdBody`` row."""
    from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER

    ts = TorchSession(device="cpu")
    dq = DistributedQuery.build(ts, plan_sql(ts, Q1), meshes[4][1])
    n0 = len(DEVICE_PROFILER.compile_rows())
    dq.run()
    dq.run()
    rows = [r for r in DEVICE_PROFILER.compile_rows()[n0:] if r["tier"] == "spmd"]
    assert [r["cache"] for r in rows] == ["miss", "hit"]
    assert rows[0]["fingerprint"] == rows[1]["fingerprint"]
    (row,) = dq.kernel_stats.values()
    assert (row["operator"], row["tier"], row["launches"]) == ("SpmdBody", "spmd", 2)


def test_device_cache_pins_the_mesh_width(meshes):
    """A cached staging serves the same width and never another."""
    from trino_tpu_torch.devcache import DEVICE_CACHE

    ts = TorchSession({"catalog": "tpch", "schema": "tiny", "device_cache_enabled": True},
                      device="cpu")
    sql = "select count(*), sum(n_nationkey) from nation"
    DEVICE_CACHE.invalidate_all()
    copied = []
    for w in (4, 4, 8):
        b0 = TM.STAGED_H2D_BYTES.value()
        dq = DistributedQuery.build(ts, plan_sql(ts, sql), meshes[w][1])
        assert dq.run().to_pylist() == [(25, 300)]
        copied.append(TM.STAGED_H2D_BYTES.value() - b0)
    assert copied[0] > 0 and copied[1] == 0 and copied[2] > 0, copied
    keys = {e["shard"] for e in DEVICE_CACHE.snapshot() if e["table"] == "nation"}
    assert {"spmd:4", "spmd:8"} <= keys
    DEVICE_CACHE.invalidate_all()


def test_cuda_mesh_without_a_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Mesh.threads(2, "cuda")


_WORKER = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.query import plan_sql
    from trino_tpu_torch.parallel.mesh import Mesh
    from trino_tpu_torch.parallel.spmd import DistributedQuery

    rank, port, sql = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    mesh = Mesh.world("cpu")
    s = Session({"catalog": "tpch", "schema": "tiny"}, device="cpu")
    rows = DistributedQuery.build(s, plan_sql(s, sql), mesh).run().to_pylist()
    print(json.dumps({"rank": rank, "rows": [[str(v) for v in r] for r in rows],
                      "calls": mesh.stats.snapshot()["calls"]}))
    dist.destroy_process_group()
""")


def test_two_processes_under_init_process_group(meshes):
    """The same executor with one rank a process over the default gloo
    group: both ranks return the reference's rows of width 2."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), port, Q3],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=REPO) for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    js = JaxSession({"catalog": "tpch", "schema": "tiny"})
    jm = JaxMesh(np.array(jax.devices()[:2]), ("d",))
    want = [[str(v) for v in r] for r in
            JaxDQ.build(js, jax_plan_sql(js, Q3), jm).run().to_pylist()]
    assert [o["rows"] for o in outs] == [want, want]
    assert all(o["calls"]["all_gather"] > 0 for o in outs)


# ------------------------------------------------- SF1 expected file
EXPECTED = os.path.join(REPO, "trino_tpu_torch", "testdata", "spmd_sf1_expected.json")
SF1_WIDTH = 4
HASHED = {"GATHER_AGG_MAX_ROWS_PER_DEVICE": 8, "BROADCAST_BUILD_MAX": 8}
# a JAX run at SF1 slower than this on the CPU is recorded at tiny instead
WRITER_QUERY_TIMEOUT_S = 300


def spmd_record(dq, rows, tiers, walk) -> dict:
    """What phase spmd compares: join tiers, exchange hints by plan
    position, regrowths and the row count."""
    return {"tiers": tiers, "xchg": xchg_shape(dq, walk), "recompiles": dq.recompiles,
            "rows": len(rows)}


def _writer_tasks():
    """(name, query, width, hashed) of every record the file holds."""
    tasks = [(f"q{q}", q, SF1_WIDTH, False) for q in range(1, 23)]
    tasks.append(("hashed3", 3, SF1_WIDTH, True))
    tasks += [(f"world1_{q}", q, 1, False) for q in (1, 3, 18)]
    return tasks


def _sqls():
    with open(os.path.join(REPO, "trino_tpu_torch", "testdata",
                           "tpch_sf1_expected.json")) as f:
        return {int(q): e["sql"] for q, e in json.load(f)["queries"].items()}


def jax_record(js, sql, width, hashed=False) -> dict:
    """One query through the JAX DistributedQuery on ``width`` CPU devices
    (``hashed``: every exchange a hash all-to-all): its record, or its
    refusal."""
    saved = {k: getattr(jax_stats, k) for k in HASHED}
    t0 = time.perf_counter()
    try:
        if hashed:
            for k, v in HASHED.items():
                setattr(jax_stats, k, v)
        mesh = JaxMesh(np.array(jax.devices()[:width]), ("d",))
        before = _tiers(JM.FUSED_JOIN_SELECTIONS)
        dq = JaxDQ.build(js, jax_plan_sql(js, sql), mesh)
        rows = dq.run().to_pylist()
        after = _tiers(JM.FUSED_JOIN_SELECTIONS)
        tiers = {t: after[t] - before[t] for t in TIERS if after[t] != before[t]}
        rec = spmd_record(dq, rows, tiers, JP.walk_plan)
    except Exception as e:  # noqa: BLE001 — a refusal is recorded
        rec = {"refused": f"{type(e).__name__}: {e}"}
    finally:
        for k, v in saved.items():
            setattr(jax_stats, k, v)
    rec["seconds"] = round(time.perf_counter() - t0, 1)
    return rec


def _writer_child(names, schema):
    """Run the named tasks through the JAX DistributedQuery in this process,
    printing one JSON line a task (a refusal is a record too)."""
    sqls = _sqls()
    js = JaxSession({"catalog": "tpch", "schema": schema, "fused_join_pallas": True})
    tasks = {t[0]: t for t in _writer_tasks()}
    for name in names:
        _, q, width, hashed = tasks[name]
        rec = jax_record(js, sqls[q], width, hashed)
        print("RECORD " + json.dumps({"name": name, **rec}), flush=True)


def _run_writer_children(names, schema, timeout_s):
    """Run the tasks in child processes (the tables generate once a child);
    a task that takes longer than ``timeout_s`` is killed with its child,
    and a new child takes the rest. Returns (records, timed-out names)."""
    import selectors

    records, slow = {}, []
    todo = list(names)
    while todo:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--writer-child", schema, ",".join(todo)],
            stdout=subprocess.PIPE, text=True, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        while todo:
            if not sel.select(timeout_s):
                proc.kill()
                slow.append(todo.pop(0))
                print(f"{slow[-1]}: over {timeout_s} s at {schema}", flush=True)
                break
            line = proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the writer's child ended before {todo[0]}")
            if line.startswith("RECORD "):
                rec = json.loads(line[len("RECORD "):])
                records[rec.pop("name")] = rec
                todo.remove(next(n for n in todo if n in records))
                print(line.strip(), flush=True)
        proc.wait()
    return records, slow


def spmd_sf1_expected() -> dict:
    """The JAX DistributedQuery on the CPU at SF1: the 22 queries and the
    dry run's hashed Q3 on 4 devices, Q1, Q3 and Q18 on 1 device. A task
    over ``WRITER_QUERY_TIMEOUT_S`` is recorded at tiny under
    ``tiny_only`` (tier-1 holds the port to it there)."""
    names = [t[0] for t in _writer_tasks()]
    records, slow = _run_writer_children(names, "sf1", WRITER_QUERY_TIMEOUT_S)
    tiny, _ = _run_writer_children(slow, "tiny", 3600) if slow else ({}, [])
    out = {"scale": "sf1", "width": SF1_WIDTH,
           "writer": "JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_spmd.py "
                     "--write-expected",
           "queries": {}, "refused": {}, "dryrun": {}, "world1": {},
           "tiny_only": {n: {"reason": f"the JAX run took over {WRITER_QUERY_TIMEOUT_S} s "
                                       "at SF1 on the CPU", **tiny[n]} for n in slow}}
    for name, rec in records.items():
        if name.startswith("q"):
            q = name[1:]
            if "refused" in rec:
                out["refused"][q] = rec["refused"]
            else:
                out["queries"][q] = rec
        elif name == "hashed3":
            out["dryrun"]["q3_hashed"] = rec
        else:
            out["world1"][name.split("_")[1]] = rec
    out["dryrun"]["q3"] = out["queries"].get("3")
    out["dryrun"]["q18"] = out["queries"].get("18")
    return out


def test_tiny_only_queries_match_the_recorded_tiers(meshes):
    """The queries whose JAX mesh run is too slow at SF1 for the CPU
    writer: the port's tiers, exchange hints and regrowths at tiny equal
    those the writer recorded from the JAX mesh at tiny, rows as the JAX
    eager Session's."""
    with open(EXPECTED) as f:
        tiny_only = json.load(f)["tiny_only"]
    props = {"catalog": "tpch", "schema": "tiny", "fused_join_pallas": True}
    ts = TorchSession(dict(props), device="cpu")
    js = JaxSession(dict(props))
    from tpch_sql import QUERIES

    for name, rec in tiny_only.items():
        assert name.startswith("q"), name
        sql = QUERIES[int(name[1:])]
        before = _tiers(TM.FUSED_JOIN_SELECTIONS)
        dq = DistributedQuery.build(ts, plan_sql(ts, sql), meshes[SF1_WIDTH][1])
        got = dq.run().to_pylist()
        after = _tiers(TM.FUSED_JOIN_SELECTIONS)
        tiers = {t: after[t] - before[t] for t in TIERS if after[t] != before[t]}
        assert spmd_record(dq, got, tiers, TP.walk_plan) == \
            {k: v for k, v in rec.items() if k not in ("reason", "seconds")}, name
        assert got == js.execute(sql).rows, name


def test_phase_spmd_at_tiny_on_the_cpu():
    """chip_smoke.phase_spmd runs on the CPU at tiny against expectations
    the JAX mesh makes here for Q1, Q3 and Q18 (the dry run's three plans,
    the overlapped Q3, one rank): every check of the phase holds."""
    import torch

    import chip_smoke

    sqls = _sqls()
    js = JaxSession({"catalog": "tpch", "schema": "tiny", "fused_join_pallas": True})
    queries = (1, 3, 18)
    recs = {q: jax_record(js, sqls[q], SF1_WIDTH) for q in queries}
    spmdexp = {"queries": {str(q): r for q, r in recs.items()}, "refused": {},
               "dryrun": {"q3": recs[3], "q18": recs[18],
                          "q3_hashed": jax_record(js, sqls[3], SF1_WIDTH, hashed=True)},
               "world1": {str(q): jax_record(js, sqls[q], 1) for q in queries},
               "tiny_only": {}}
    expected = {str(q): {"sql": sqls[q],
                         "rows": chip_smoke.jsonable_rows(js.execute(sqls[q]).rows)}
                for q in queries}
    out = chip_smoke.phase_spmd(torch.device("cpu"), expected, spmdexp, "cpu",
                                schema="tiny", queries=queries)
    assert out["dryrun"]["q3_overlapped"]["bit_identical"]
    assert out["dryrun"]["q3_hashed"]["xchg"] and out["launches"] == 0
    assert sorted(out["queries"]) == ["1", "18", "3"] and out["world1"]["backend"] == "gloo"
    assert out["collectives"]["bytes"]["all_to_all"] > 0


if __name__ == "__main__" and sys.argv[1:2] == ["--writer-child"]:
    _writer_child(sys.argv[3].split(","), sys.argv[2])

if __name__ == "__main__" and "--write-expected" in sys.argv[1:]:
    sys.path.insert(0, REPO)
    expected = spmd_sf1_expected()
    with open(EXPECTED, "w") as f:
        json.dump(expected, f, indent=1)
        f.write("\n")
    print("wrote", EXPECTED)
