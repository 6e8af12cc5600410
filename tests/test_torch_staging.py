"""The port's split staging (trino_tpu_torch/exec/staging.py) and host-RAM
tier (trino_tpu_torch/devcache/hostcache.py) against the JAX package's
(trino_tpu/exec/staging.py, trino_tpu/devcache/hostcache.py), on the CPU.

Parallel and serial staging stage bit-identical pages, equal to the
reference's; each split copied into its slice of a column gives the
reference's concatenated column; split sizing agrees; the host tier
single-flights, never
parks a pool thread, keeps its byte budget, refills the device cache
without connector scans and is invalidated by every DML statement. The
pinned double-buffered copy runs only on a GPU (marked ``cuda``).
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
from trino_tpu import types as JT
from trino_tpu.client.session import Session as JaxSession
from trino_tpu.devcache import DEVICE_CACHE as JAX_DEVICE_CACHE
from trino_tpu.devcache import HOST_CACHE as JAX_HOST_CACHE
from trino_tpu.exec import staging as jax_staging
from trino_tpu.exec.executor import Executor as JaxExecutor
from trino_tpu.exec.query import plan_sql as jax_plan_sql
from trino_tpu.sql.planner import plan as JP

from trino_tpu_torch import Session as TorchSession
from trino_tpu_torch import types as T
from trino_tpu_torch.data.page import to_numpy
from trino_tpu_torch.devcache import DEVICE_CACHE, HOST_CACHE, CacheKey
from trino_tpu_torch.devcache.hostcache import HostColumnCache
from trino_tpu_torch.exec import staging
from trino_tpu_torch.exec.executor import Executor
from trino_tpu_torch.exec.query import plan_sql
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.sql.planner import plan as P


@pytest.fixture(autouse=True)
def fresh_caches():
    for c in (DEVICE_CACHE, HOST_CACHE, JAX_DEVICE_CACHE, JAX_HOST_CACHE):
        c.invalidate_all()
    yield
    for c in (DEVICE_CACHE, HOST_CACHE, JAX_DEVICE_CACHE, JAX_HOST_CACHE):
        c.invalidate_all()


def _session(**props):
    return TorchSession({"catalog": "memory", "schema": "db",
                         "device_cache_enabled": True, **props}, device="cpu")


def _jax_session(**props):
    return JaxSession({"catalog": "memory", "schema": "db",
                       "device_cache_enabled": True, **props})


def _tables(conn, types, n_lineitem=4000):
    """The reference test suite's Q3-shaped memory tables, in either
    package (``types`` is that package's types module)."""
    rng = np.random.default_rng(7)
    n_cust, n_ord = 120, 900
    conn.create_table(
        "db", "customer", [("c_custkey", types.BIGINT), ("c_seg", types.VARCHAR)],
        [(i, "BUILDING" if i % 5 == 0 else "AUTO") for i in range(n_cust)])
    conn.create_table(
        "db", "orders",
        [("o_orderkey", types.BIGINT), ("o_custkey", types.BIGINT),
         ("o_pri", types.BIGINT)],
        [(i, int(rng.integers(0, n_cust)), i % 3) for i in range(n_ord)])
    conn.create_table(
        "db", "lineitem", [("l_orderkey", types.BIGINT), ("l_price", types.BIGINT)],
        [(int(rng.integers(0, n_ord)), int(rng.integers(1, 100)))
         for _ in range(n_lineitem)])


Q3 = ("select l_orderkey, sum(l_price) rev, o_pri "
      "from customer, orders, lineitem "
      "where c_seg = 'BUILDING' and c_custkey = o_custkey "
      "and l_orderkey = o_orderkey group by l_orderkey, o_pri "
      "order by rev desc limit 10")

# TPC-H tiny scans with dictionaries, a sorted key and nulls-free decimals,
# cut into many splits
TPCH_SCAN = ("select o_orderkey, o_custkey, o_orderstatus, o_totalprice, o_orderdate, "
             "o_orderpriority, o_comment from orders")


def _scans(root, plan=P):
    """The plan's table scans (``plan`` is that package's plan module)."""
    return [n for n in plan.walk_plan(root) if isinstance(n, plan.TableScanNode)]


def _page_arrays(page, host):
    """(values, nulls, dictionary, ascending, vrange) per column."""
    out = []
    for c in page.columns:
        out.append((host(c.values), None if c.nulls is None else host(c.nulls),
                    None if c.dictionary is None else list(c.dictionary.values),
                    bool(c.ascending), None if c.vrange is None else tuple(c.vrange)))
    return out


def _assert_same_pages(a, b):
    assert len(a) == len(b)
    for (va, na, da, sa, ra), (vb, nb, db, sb, rb) in zip(a, b):
        assert va.dtype == vb.dtype and np.array_equal(va, vb)
        assert (na is None) == (nb is None)
        if na is not None:
            assert np.array_equal(na, nb)
        assert da == db and sa == sb and ra == rb


def _port_scan_pages(sql, par, setup=None, schema_props=None):
    s = TorchSession(dict(schema_props or {"catalog": "memory", "schema": "db"},
                          staging_parallelism=par, staging_split_bytes=1 << 12),
                     device="cpu")
    if setup is not None:
        setup(s)
    ex = Executor(s)
    return [_page_arrays(ex._exec_TableScanNode(n), to_numpy)
            for n in _scans(plan_sql(s, sql))]


def _jax_scan_pages(sql, setup=None, schema_props=None):
    s = JaxSession(dict(schema_props or {"catalog": "memory", "schema": "db"},
                        staging_parallelism=4, staging_split_bytes=1 << 12))
    if setup is not None:
        setup(s)
    ex = JaxExecutor(s)
    return [_page_arrays(ex._exec_TableScanNode(n), np.asarray)
            for n in _scans(jax_plan_sql(s, sql), JP)]


@pytest.mark.parametrize("case", ["memory_q3", "tpch_orders"])
def test_parallel_serial_bit_identical_and_equal_reference(case):
    """The staged pages are bitwise the same whether the split reads run
    serial or 4-wide over many small splits, and equal the reference's
    (values, nulls, merged dictionaries, the sorted flag, vranges)."""
    if case == "memory_q3":
        sql, props = Q3, None
        port_setup = lambda s: _tables(s.catalogs["memory"], T)  # noqa: E731
        jax_setup = lambda s: _tables(s.catalogs["memory"], JT)  # noqa: E731
    else:
        sql, props = TPCH_SCAN, {"catalog": "tpch", "schema": "tiny"}
        port_setup = jax_setup = None
    serial = _port_scan_pages(sql, 1, port_setup, props)
    parallel = _port_scan_pages(sql, 4, port_setup, props)
    ref = _jax_scan_pages(sql, jax_setup, props)
    assert len(serial) == len(parallel) == len(ref) >= 1
    for a, b, r in zip(serial, parallel, ref):
        _assert_same_pages(a, b)
        _assert_same_pages(a, r)
    if case == "tpch_orders":
        assert serial[0][0][3]  # o_orderkey kept its sorted flag across splits


def test_target_split_count_equals_reference():
    port, ref = _session(), _jax_session()
    _tables(port.catalogs["memory"], T)
    _tables(ref.catalogs["memory"], JT)
    pconn, rconn = port.catalogs["memory"], ref.catalogs["memory"]
    for split_bytes in (1 << 10, 1 << 12, 1 << 16, 1 << 30):
        port.properties["staging_split_bytes"] = split_bytes
        ref.properties["staging_split_bytes"] = split_bytes
        for table in ("customer", "orders", "lineitem"):
            assert (staging.target_split_count(port, pconn, "db", table)
                    == jax_staging.target_split_count(ref, rconn, "db", table))
    port.properties["staging_split_bytes"] = 1 << 10
    assert 1 < staging.target_split_count(port, pconn, "db", "lineitem") \
        <= staging.MAX_TARGET_SPLITS
    # a pushdown handle keeps the caller's floor; so does an unknown size
    assert staging.target_split_count(port, pconn, "db", "lineitem", handle=("x",)) == 1

    class NoStats:
        def table_row_count(self, schema, table):
            return None

        def get_table(self, schema, table):
            return None

    assert staging.target_split_count(port, NoStats(), "db", "x", floor=3) == 3
    # TPC-H: the SF1 lineitem target the smoke run stages
    tp, tr = TorchSession({"catalog": "tpch", "schema": "sf1"}, device="cpu"), \
        JaxSession({"catalog": "tpch", "schema": "sf1"})
    for table in ("lineitem", "orders", "nation"):
        assert (staging.target_split_count(tp, tp.catalogs["tpch"], "sf1", table)
                == jax_staging.target_split_count(tr, tr.catalogs["tpch"], "sf1", table))


def _count_scans(conn):
    """Wrap conn.scan with a counter: [calls, set of tables]."""
    calls = [0, set()]
    inner = conn.scan

    def scan(split, columns, constraint=None):
        calls[0] += 1
        calls[1].add(split.table)
        return inner(split, columns, constraint=constraint)

    conn.scan = scan
    return calls


def test_single_flight_four_concurrent_stagings():
    """Four threads staging one table through the host tier run exactly one
    connector scan per split; every thread gets the same columns."""
    s = _session(staging_split_bytes=1 << 12, staging_parallelism=2)
    _tables(s.catalogs["memory"], T)
    node = _scans(plan_sql(s, "select l_orderkey, l_price from lineitem"))[0]
    conn = s.catalogs["memory"]
    target = staging.target_split_count(s, conn, "db", "lineitem")
    n_splits = len(conn.get_splits("db", "lineitem", target))
    assert n_splits > 1
    calls = _count_scans(conn)
    results = [None] * 4
    barrier = threading.Barrier(4)

    def work(i):
        barrier.wait()
        splits = conn.get_splits("db", "lineitem", target)
        results[i], _prof = staging.stage_splits(s, node, conn, splits, None)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls[0] == n_splits, (calls[0], n_splits)
    base = [np.asarray(d["l_orderkey"].values) for d in results[0]]
    for r in results[1:]:
        for x, d in zip(base, r):
            assert np.array_equal(x, np.asarray(d["l_orderkey"].values))


def test_inflight_split_never_parks_a_pool_caller():
    """``lookup_or_stage(wait=False)`` returns (None, "inflight") at once
    while another caller leads the flight."""
    cache = HostColumnCache(max_bytes=1 << 20)
    key = CacheKey("c", "s", "t", "v1", "sig", "host:0", 1, "host")
    leading = threading.Event()
    release = threading.Event()

    def slow_loader():
        leading.set()
        assert release.wait(30)
        return {"x": 1}, 1, 100, 1

    leader = threading.Thread(target=lambda: cache.lookup_or_stage(key, slow_loader))
    leader.start()
    try:
        assert leading.wait(30)
        t0 = time.perf_counter()
        ent, disp = cache.lookup_or_stage(
            key, lambda: pytest.fail("follower must not load"), wait=False)
        assert (ent, disp) == (None, "inflight")
        assert time.perf_counter() - t0 < 5
    finally:
        release.set()
        leader.join()
    ent, disp = cache.lookup_or_stage(key, lambda: pytest.fail("resident entry must serve"))
    assert disp == "hit" and ent.value == {"x": 1}


def test_host_cache_budget_lru():
    cache = HostColumnCache(max_bytes=3000)
    for i in range(5):
        cache.lookup_or_stage(
            CacheKey("c", "s", f"t{i}", "v1", "sig", f"host:{i}", 1, "host"),
            lambda: (object(), 1, 1000, 1))
    assert cache.cached_bytes() == 3000
    assert {e["table"] for e in cache.snapshot()} == {"t2", "t3", "t4"}


def test_hbm_evict_refills_from_host_with_zero_connector_scans():
    """After the device cache is emptied, staging refills from the host
    tier: zero connector scans, rows equal, and rows equal the
    reference's."""
    s = _session(staging_split_bytes=1 << 12)
    _tables(s.catalogs["memory"], T)
    r1 = s.execute(Q3).rows
    assert HOST_CACHE.cached_bytes() > 0
    DEVICE_CACHE.invalidate_all()
    calls = _count_scans(s.catalogs["memory"])
    hits_before = HOST_CACHE.hit_count()
    r2 = s.execute(Q3).rows
    assert calls[0] == 0
    assert HOST_CACHE.hit_count() > hits_before
    assert r1 == r2
    ref = _jax_session(staging_split_bytes=1 << 12)
    _tables(ref.catalogs["memory"], JT)
    assert r1 == ref.execute(Q3).rows


def test_host_cache_dml_invalidation_matrix_memory():
    """Each of INSERT, UPDATE, DELETE and CTAS moves the version: the next
    read of both a cached and an uncached session (sharing the catalogs)
    agrees, and equals the reference's after the same statements; DROP and
    CTAS again never serve the dropped table's entries; an INSERT into
    lineitem re-scans only lineitem."""
    s = _session(staging_split_bytes=1 << 12)
    _tables(s.catalogs["memory"], T)
    plain = TorchSession({"catalog": "memory", "schema": "db"}, device="cpu",
                         catalogs=s.catalogs)
    ref = _jax_session(staging_split_bytes=1 << 12)
    _tables(ref.catalogs["memory"], JT)

    def probe(sess):
        return sess.execute(
            "select l_orderkey, sum(l_price) rev from lineitem "
            "group by l_orderkey order by rev desc, l_orderkey limit 5").rows

    ops = [
        "insert into lineitem values (1, 100000)",
        "update lineitem set l_price = 200000 where l_price = 100000",
        "delete from lineitem where l_price = 200000",
        "create table lineitem2 as select * from lineitem",
    ]
    for sql in ops:
        before = probe(s)
        assert probe(s) == before  # warm
        assert s.execute(sql).rows == ref.execute(sql).rows
        got = probe(s)
        assert got == probe(plain) == probe(ref)
    s.execute("drop table lineitem")
    s.execute("create table lineitem as "
              "select l_orderkey, l_price + 1 as l_price from lineitem2")
    DEVICE_CACHE.invalidate_all()
    assert probe(s) == probe(plain)
    versions = {e["version"] for e in HOST_CACHE.snapshot() if e["table"] == "lineitem"}
    assert len(versions) <= 1  # stale host entries are reclaimed

    s.execute(Q3)
    s.execute("insert into lineitem values (2, 3)")
    DEVICE_CACHE.invalidate_all()
    calls = _count_scans(s.catalogs["memory"])
    s.execute(Q3)
    assert calls[0] >= 1 and calls[1] == {"lineitem"}


def _parts_fixture(spi, dictionary, types):
    """Per-split column parts with what assembly must get right, in either
    package (its spi, dictionary and types modules): differing
    dictionaries, nulls and high limbs in some splits only, an empty split,
    a narrowable int64 column, a sorted flag that holds and one that
    breaks at a split boundary."""
    rng = np.random.default_rng(11)
    sizes = [700, 0, 1300, 512, 9]
    starts = np.cumsum([0] + sizes)
    vocabs = [["a", "b"], ["a"], ["b", "c", "d"], ["a", "b"], ["e"]]
    col_types = [types.BIGINT, types.BIGINT, types.VARCHAR, types.DOUBLE, types.decimal(30, 2)]
    names = ["k", "unsorted", "s", "x", "dec"]
    datas = []
    for i, n in enumerate(sizes):
        cd = spi.ColumnData
        datas.append({
            "k": cd(types.BIGINT, np.arange(starts[i], starts[i] + n, dtype=np.int64),
                    vrange=(0, 10**6), sorted=True),
            "unsorted": cd(types.BIGINT, np.arange(n, dtype=np.int64) * 3 - i,
                           vrange=(-10, 2**40), sorted=True),
            "s": cd(types.VARCHAR, rng.integers(-1, len(vocabs[i]), size=n).astype(np.int32),
                    dictionary=dictionary.Dictionary(vocabs[i])),
            "x": cd(types.DOUBLE, rng.standard_normal(n),
                    nulls=rng.integers(0, 2, size=n).astype(bool) if i % 2 else None),
            "dec": cd(types.decimal(30, 2), rng.integers(-2**62, 2**62, size=n),
                      hi=rng.integers(-5, 5, size=n) if i == 2 else None),
        })
    return names, col_types, datas


def test_split_columns_equal_reference_concatenation():
    """Copying each split into its slice of the column gives bitwise what
    the reference's scan assembly builds (its concat_column_data, then its
    int32 narrowing): values, dtypes, nulls, high limbs, merged
    dictionaries, vranges and sorted flags."""
    from trino_tpu.connector import spi as jax_spi
    from trino_tpu.data import dictionary as jax_dictionary
    from trino_tpu.data.page import fits_int32 as jax_fits_int32
    from trino_tpu_torch.connector import spi
    from trino_tpu_torch.data import dictionary

    names, types, datas = _parts_fixture(spi, dictionary, T)
    page = staging.page_from_split_columns(
        types, staging.split_columns(names, types, datas),
        staging.blocked_transfer("cpu"), "cpu")
    _, _, ref_datas = _parts_fixture(jax_spi, jax_dictionary, JT)
    want = []
    for name in names:
        cd = jax_spi.concat_column_data([d[name] for d in ref_datas])
        vals = np.asarray(cd.values)
        if cd.hi is None and vals.dtype == np.int64 and jax_fits_int32(cd.vrange):
            vals = vals.astype(np.int32)
        want.append((vals, cd.nulls, cd.dictionary, cd.sorted, cd.vrange, cd.hi))
    assert [c.values.dtype for c in page.columns][:2] == [torch.int32, torch.int64]
    for c, (vals, nulls, d, srt, vr, hi) in zip(page.columns, want):
        got = to_numpy(c.values)
        assert got.dtype == vals.dtype and np.array_equal(got, vals)
        assert (c.nulls is None) == (nulls is None)
        if nulls is not None:
            assert np.array_equal(to_numpy(c.nulls), np.asarray(nulls))
        assert (c.hi is None) == (hi is None)
        if hi is not None:
            assert np.array_equal(to_numpy(c.hi), np.asarray(hi))
        assert (c.dictionary is None) == (d is None)
        if d is not None:
            assert list(c.dictionary.values) == list(d.values)
        assert c.ascending == srt and c.vrange == vr
    assert page.columns[0].ascending and not page.columns[1].ascending
    # and the port's own host concatenation agrees with the reference's
    for name, (vals, *_rest) in zip(names, want):
        cd = spi.concat_column_data([d[name] for d in datas])
        ref = jax_spi.concat_column_data([d[name] for d in ref_datas])
        assert np.array_equal(np.asarray(cd.values), np.asarray(ref.values))
        assert cd.sorted == ref.sorted and cd.vrange == ref.vrange
    # no row left: the all-dead page
    empty = [{n: dataclasses.replace(d[n], values=np.asarray(d[n].values)[:0], nulls=None,
                                     hi=None) for n in names} for d in datas[:2]]
    assert staging.split_columns(names, types, empty) is None


def test_blocked_transfer_cpu_parts_concatenate_and_cast():
    """On the CPU the parts of a column end to end, cast to the asked
    dtype, with the copied bytes counted once."""
    prof = staging.StageProfile()
    parts = [np.arange(5, dtype=np.int64), np.zeros(0, np.int64), np.arange(7, 10)]
    out = staging.blocked_transfer("cpu", prof)(parts, np.int32)
    assert to_numpy(out).dtype == np.int32
    assert np.array_equal(to_numpy(out), np.concatenate(parts).astype(np.int32))
    assert prof.h2d_bytes == 8 * 4


def test_blocked_transfer_cpu_is_plain_host_path():
    """A CPU session's transfer is the plain host path: no blocks, the
    bytes counted, the result bitwise the input."""
    prof = staging.StageProfile()
    b0 = M.STAGED_H2D_BYTES.value()
    arr = np.arange(1 << 16, dtype=np.int64)
    out = staging.blocked_transfer("cpu", prof, block_bytes=1 << 10)(arr)
    assert np.array_equal(to_numpy(out), arr) and prof.transfer_blocks == 0
    assert M.STAGED_H2D_BYTES.value() - b0 == arr.nbytes == prof.h2d_bytes


@pytest.mark.cuda
def test_blocked_transfer_pinned_stream_path():
    """On the card: columns of more than two blocks copy through the two
    pinned buffers on the side stream, bitwise equal to the input, for each
    dtype a scan stages; a consumer kernel right after the copy reads the
    finished column; per-split parts narrowed on the way land in their
    slices, packed across block edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA copy streams and pinned memory)")
    rng = np.random.default_rng(5)
    dev = torch.device("cuda", 0)
    for dtype in (np.int32, np.int64, np.float64, np.bool_):
        arr = (rng.integers(0, 2, size=100_003).astype(np.bool_) if dtype is np.bool_
               else rng.integers(-2**30, 2**30, size=100_003).astype(dtype))
        prof = staging.StageProfile()
        out = staging.blocked_transfer(dev, prof, block_bytes=4096)(arr)
        total = out.to(torch.float64).sum()  # consumer stream, no sync between
        assert prof.transfer_blocks == -(-arr.nbytes // 4096)
        assert np.array_equal(out.cpu().numpy(), arr)
        assert float(total.item()) == float(arr.astype(np.float64).sum())
    small = np.arange(10, dtype=np.int64)
    prof = staging.StageProfile()
    out = staging.blocked_transfer(dev, prof, block_bytes=4096)(small)
    assert prof.transfer_blocks == 0 and np.array_equal(out.cpu().numpy(), small)
    # per-split parts, narrowed to int32 in the pinned copy: packed across
    # block edges (more than two blocks), or one copy per slice (fewer)
    parts = [rng.integers(-2**30, 2**30, size=n) for n in (3001, 0, 517, 1024, 2)]
    for block_bytes, want_blocks in ((4096, -(-4544 * 4 // 4096)), (1 << 20, 0)):
        prof = staging.StageProfile()
        out = staging.blocked_transfer(dev, prof, block_bytes=block_bytes)(parts, np.int32)
        total = out.to(torch.int64).sum()
        want = np.concatenate(parts).astype(np.int32)
        assert out.dtype == torch.int32 and np.array_equal(out.cpu().numpy(), want)
        assert prof.transfer_blocks == want_blocks
        assert int(total.item()) == int(want.astype(np.int64).sum())
