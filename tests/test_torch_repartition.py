"""The port's hash exchange over a mesh (trino_tpu_torch/parallel/exchange.py
and mesh.py) against the JAX package's.

Exchange-level cases run the reference's functions under ``shard_map`` on
the conftest's CPU mesh (``jax.devices()[:W]``) and the port's on a thread
mesh of the same width (gloo over one ``HashStore``, one thread a rank),
from the same numpy shards: partition ids, each rank's received page and
overflow flag, and the overlapped exchange's restacked output must be
bit-equal. Then the cases of the reference's tests/test_repartition.py:
the same SQL through both ``DistributedQuery``s, rows exact, the same
exchange hints and regrowths.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as PSpec  # noqa: E402

from trino_tpu import Session as JaxSession  # noqa: E402
from trino_tpu import types as JT  # noqa: E402
from trino_tpu.data.page import Column as JColumn, Page as JPage  # noqa: E402
from trino_tpu.exec.query import plan_sql as jax_plan_sql  # noqa: E402
from trino_tpu.parallel import exchange as jx  # noqa: E402
from trino_tpu.parallel.spmd import DistributedQuery as JaxDQ, _shard_map  # noqa: E402
from trino_tpu.sql.planner import plan as JP  # noqa: E402
from trino_tpu.sql.planner import stats as jax_stats  # noqa: E402

import torch  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch import types as TT  # noqa: E402
from trino_tpu_torch.data.page import Column as TColumn, Page as TPage  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql  # noqa: E402
from trino_tpu_torch.parallel import exchange as tx  # noqa: E402
from trino_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from trino_tpu_torch.parallel.spmd import DistributedQuery  # noqa: E402
from trino_tpu_torch.sql.planner import plan as TP  # noqa: E402
from trino_tpu_torch.sql.planner import stats as torch_stats  # noqa: E402

W = 4


@pytest.fixture(scope="module")
def meshes():
    jm = JaxMesh(np.array(jax.devices()[:W]), ("d",))
    tm = Mesh.threads(W, "cpu", timeout_s=60)
    yield jm, tm
    tm.close()


def _shards(rng, n):
    """Per-rank numpy shards: an int64 key with NULLs, an int32 payload, a
    float64 payload and a selection with dead rows."""
    key = rng.integers(-50, 50, size=(W, n)).astype(np.int64)
    key_nulls = rng.random((W, n)) < 0.1
    v32 = rng.integers(-2**31, 2**31 - 1, size=(W, n)).astype(np.int32)
    f64 = rng.normal(size=(W, n))
    sel = rng.random((W, n)) < 0.8
    return key, key_nulls, v32, f64, sel


def _jax_page(key, nulls, v32, f64, sel):
    return JPage([JColumn(JT.BIGINT, key, nulls), JColumn(JT.INTEGER, v32),
                  JColumn(JT.DOUBLE, f64)], sel)


def _torch_page(key, nulls, v32, f64, sel):
    t = torch.from_numpy
    return TPage([TColumn(TT.BIGINT, t(key), t(nulls)), TColumn(TT.INTEGER, t(v32)),
                  TColumn(TT.DOUBLE, t(f64))], t(sel))


def _page_arrays(p):
    out = []
    for c in p.columns:
        out.append(c.values)
        if c.nulls is not None:
            out.append(c.nulls)
    out.append(p.sel)
    return out


def _jax_per_rank(jm, fn, arrays, n_out):
    """``fn`` on every device of the JAX mesh under shard_map: each input
    [W, n] sharded by rank, each output gathered back as [W, ...]."""
    def per_shard(*flat):
        outs = fn(*[a.reshape(a.shape[1:]) for a in flat])
        return tuple(o[None] for o in outs)

    f = jax.jit(_shard_map(per_shard, jm, tuple(PSpec("d") for _ in arrays),
                           tuple(PSpec("d") for _ in range(n_out))))
    return [np.asarray(o) for o in f(*[jnp.asarray(a) for a in arrays])]


@pytest.mark.parametrize("n_devices", [4, 8, 3])
def test_partition_ids_bit_equal(n_devices):
    rng = np.random.default_rng(n_devices)
    n = 4096
    k1 = rng.integers(-2**62, 2**62, size=n).astype(np.int64)
    k2 = rng.integers(0, 1000, size=n).astype(np.int32)
    valid = rng.random(n) < 0.9
    want = np.asarray(jx.partition_ids(
        [(jnp.asarray(k1), None), (jnp.asarray(k2), jnp.asarray(valid))], n_devices))
    got = tx.partition_ids(
        [(torch.from_numpy(k1), None), (torch.from_numpy(k2), torch.from_numpy(valid))],
        n_devices).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= set(range(n_devices))


@pytest.mark.parametrize("capacity", [256, 16])
def test_repartition_page_bit_equal_per_rank(meshes, capacity):
    """Each rank's received page and its overflow flag equal the
    reference's device for device (capacity 16 overflows)."""
    jm, tm = meshes
    key, nulls, v32, f64, sel = _shards(np.random.default_rng(capacity), 300)

    def jfn(k, nl, a, b, s):
        out, flag = jx.repartition_page(_jax_page(k, nl, a, b, s), [0], W, capacity, "d")
        return tuple(_page_arrays(out)) + (flag,)

    want = _jax_per_rank(jm, jfn, [key, nulls, v32, f64, sel], 6)

    def tfn(comm):
        r = comm.rank
        page = _torch_page(key[r], nulls[r], v32[r], f64[r], sel[r])
        out, flag = tx.repartition_page(page, [0], W, capacity, comm)
        assert not out.replicated
        return [a.numpy() for a in _page_arrays(out)] + [bool(flag)]

    got = tm.run(tfn)
    for r in range(W):
        for g, w in zip(got[r][:5], want[:5]):
            np.testing.assert_array_equal(g, w[r])
        assert got[r][5] == bool(want[5][r])
    # every live row arrives once, with the rows of its key
    received = sum(int(g[4].sum()) for g in got)
    assert (received == int(sel.sum())) == (capacity == 256)


def test_overlapped_exchange_restack_bit_equal(meshes):
    """The overlapped exchange with a row-local consume: per rank, equal
    to the reference's overlapped exchange and to the one-shot exchange
    followed by the same consume."""
    jm, tm = meshes
    key, nulls, v32, f64, sel = _shards(np.random.default_rng(9), 257)
    blocks, capacity = 4, 128

    def jconsume(p):
        c = p.columns[1]
        return JPage(p.columns + [JColumn(JT.BIGINT, c.values.astype(jnp.int64) * 3)],
                     p.sel)

    def jfn(k, nl, a, b, s):
        out, flag = jx.repartition_page_overlapped(
            _jax_page(k, nl, a, b, s), [0], W, capacity, "d", blocks, jconsume)
        return tuple(_page_arrays(out)) + (flag,)

    want = _jax_per_rank(jm, jfn, [key, nulls, v32, f64, sel], 7)

    def tconsume(p):
        c = p.columns[1]
        return TPage(p.columns + [TColumn(TT.BIGINT, c.values.to(torch.int64) * 3)], p.sel)

    def tfn(comm):
        r = comm.rank
        page = _torch_page(key[r], nulls[r], v32[r], f64[r], sel[r])
        out, flag = tx.repartition_page_overlapped(page, [0], W, capacity, comm, blocks,
                                                   tconsume)
        one, _ = tx.repartition_page(page, [0], W, capacity, comm)
        return ([a.numpy() for a in _page_arrays(out)] + [bool(flag)],
                [a.numpy() for a in _page_arrays(tconsume(one))])

    got = tm.run(tfn)
    for r in range(W):
        over, one_shot = got[r]
        for g, w in zip(over[:6], want[:6]):
            np.testing.assert_array_equal(g, w[r])
        for g, o in zip(over[:6], one_shot):
            np.testing.assert_array_equal(g, o)
        assert over[6] == bool(want[6][r]) is False


def test_mesh_collectives_pack_every_dtype(meshes):
    """all_gather, all_to_all and any over bool, int8, int16, int32, int64
    and float64 arrays in one call each: every dtype round-trips."""
    _jm, tm = meshes
    dtypes = (torch.bool, torch.int8, torch.int16, torch.int32, torch.int64, torch.float64)

    def fn(comm):
        r = comm.rank
        arrays = [(torch.arange(5) + r * 10).to(dt) if dt != torch.bool
                  else (torch.arange(5) % (r + 2) == 0) for dt in dtypes]
        g = comm.all_gather(arrays)
        blocks = [torch.stack([a] * W) + 0 if a.dtype != torch.bool else torch.stack([a] * W)
                  for a in arrays]
        x = comm.all_to_all(blocks)
        fired = comm.any(torch.tensor([r == 2, False, r == 0]))
        return g, x, fired.tolist()

    got = tm.run(fn)
    for r in range(W):
        g, x, fired = got[r]
        for i, dt in enumerate(dtypes):
            assert g[i].dtype == x[i].dtype == dt and g[i].shape == (5 * W,)
            want = torch.cat([(torch.arange(5) + s * 10).to(dt) if dt != torch.bool
                              else (torch.arange(5) % (s + 2) == 0) for s in range(W)])
            assert torch.equal(g[i], want) and torch.equal(x[i], want)
        assert fired == [True, False, True]


# ------------------------------------------- tests/test_repartition.py
def _sessions(tables=()):
    """A JAX and a port Session on the CPU with the same memory tables."""
    js, ts = JaxSession(), TorchSession(device="cpu")
    for name, schema_j, schema_t, rows in tables:
        js.catalogs["memory"].create_table("t", name, schema_j, rows)
        ts.catalogs["memory"].create_table("t", name, schema_t, rows)
    return js, ts


def _facts_tables(n_rows=4096, n_keys=1500):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, n_keys, n_rows)
    vals = rng.integers(0, 1000, n_rows)
    dim_keys = rng.permutation(n_keys)[: n_keys // 2]
    facts = [(int(k), int(v)) for k, v in zip(keys, vals)]
    dims = [(int(k), int(k) * 10) for k in dim_keys]
    return [("facts", [("k", JT.BIGINT), ("v", JT.BIGINT)],
             [("k", TT.BIGINT), ("v", TT.BIGINT)], facts),
            ("dims", [("k", JT.BIGINT), ("w", JT.BIGINT)],
             [("k", TT.BIGINT), ("w", TT.BIGINT)], dims)]


@pytest.fixture()
def low_thresholds(monkeypatch):
    """The reference test's thresholds, in both packages' stats."""
    for mod in (jax_stats, torch_stats):
        monkeypatch.setattr(mod, "GATHER_AGG_MAX_ROWS_PER_DEVICE", 64)
        monkeypatch.setattr(mod, "BROADCAST_BUILD_MAX", 64)


def xchg_shape(dq, walk):
    """A query's exchange hints with each node id replaced by the node's
    position in the plan walk (ids differ between packages)."""
    pos = {n.id: i for i, n in enumerate(walk(dq.root))}
    out = {}
    for k, v in dq.capacity_hints.items():
        if k.startswith("xchg"):
            kind, nid = k.split(":")
            out[f"{kind}:@{pos[int(nid)]}"] = v
    return out


def run_both(js, ts, sql, meshes, hints=None):
    jm, tm = meshes
    jdq = JaxDQ.build(js, jax_plan_sql(js, sql), jm,
                      None if hints is None else dict(hints[0]))
    tdq = DistributedQuery.build(ts, plan_sql(ts, sql), tm,
                                 None if hints is None else dict(hints[1]))
    return jdq, jdq.run().to_pylist(), tdq, tdq.run().to_pylist()


def test_agg_repartition_matches_reference(meshes, low_thresholds):
    js, ts = _sessions(_facts_tables())
    sql = ("select k, sum(v), count(*), min(v), max(v) from memory.t.facts "
           "group by k order by k")
    root = plan_sql(ts, sql)
    aggs = [n for n in TP.walk_plan(root) if isinstance(n, TP.AggregationNode)]
    assert any(torch_stats.agg_repartitions(ts, a, W) for a in aggs), "must take hash path"
    jdq, want, tdq, got = run_both(js, ts, sql, meshes)
    assert got == want == ts.execute(sql).rows
    assert any(k.startswith("xchg:") for k in tdq.capacity_hints)
    assert xchg_shape(tdq, TP.walk_plan) == xchg_shape(jdq, JP.walk_plan)


def test_partitioned_join_matches_reference(meshes, low_thresholds):
    js, ts = _sessions(_facts_tables())
    sql = """select f.k, f.v, d.w from memory.t.facts f, memory.t.dims d
             where f.k = d.k order by f.k, f.v, d.w"""
    jdq, want, tdq, got = run_both(js, ts, sql, meshes)
    assert got == want == ts.execute(sql).rows
    assert any(k.startswith("xchgl:") for k in tdq.capacity_hints)
    assert xchg_shape(tdq, TP.walk_plan) == xchg_shape(jdq, JP.walk_plan)


def test_partitioned_join_with_nulls_and_outer(meshes, low_thresholds):
    rng = np.random.default_rng(3)
    rows = [(None if i % 17 == 0 else int(rng.integers(0, 300)), i) for i in range(1024)]
    right = [(k, k * 2) for k in range(0, 300, 2)]
    js, ts = _sessions([
        ("l", [("k", JT.BIGINT), ("v", JT.BIGINT)], [("k", TT.BIGINT), ("v", TT.BIGINT)], rows),
        ("r", [("k", JT.BIGINT), ("w", JT.BIGINT)], [("k", TT.BIGINT), ("w", TT.BIGINT)],
         right)])
    sql = """select l.v, r.w from memory.t.l l left join memory.t.r r on l.k = r.k
             order by l.v"""
    jdq, want, tdq, got = run_both(js, ts, sql, meshes)
    assert got == want == ts.execute(sql).rows
    assert any(k.startswith("xchgl:") for k in tdq.capacity_hints)


def test_exchange_overflow_recompiles(meshes, low_thresholds):
    """Skewed keys overflow the uniform-share exchange block: both run
    loops double the bucket and run again, with the same regrowths."""
    rows = [(42 if i % 4 != 0 else i, i) for i in range(8000)]
    js, ts = _sessions([("skew", [("k", JT.BIGINT), ("v", JT.BIGINT)],
                         [("k", TT.BIGINT), ("v", TT.BIGINT)], rows)])
    sql = "select k, count(*) from memory.t.skew group by k order by 2 desc, 1 limit 5"
    jdq, want, tdq, got = run_both(js, ts, sql, meshes)
    assert got == want == ts.execute(sql).rows
    before = {k: v for k, v in torch_stats.estimate_exchange_hints(
        ts, tdq.root, W).items() if k.startswith("xchg")}
    assert before
    grown = {k: v for k, v in tdq.capacity_hints.items() if k.startswith("xchg")}
    assert any(grown[k] > before[k] for k in before), (before, grown)
    assert tdq.recompiles == jdq.recompiles >= 1
    assert xchg_shape(tdq, TP.walk_plan) == xchg_shape(jdq, JP.walk_plan)
