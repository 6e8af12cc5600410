"""The port's device table cache (trino_tpu_torch/devcache/) against the
JAX package's (trino_tpu/devcache/), at ``tiny`` on the CPU: the DML
invalidation matrix on the memory connector, stale versions reclaimed,
the LRU under its byte budget, single flight and the stuck-leader bypass,
the bypass rules, private catalogs, the scan signature, and (port only)
keys that carry the device.

Also the writer of the expected data the GPU smoke run (chip_smoke.py)
holds the cached session, Q3 at SF10, the spill queries and the DML
sequence against, on a machine without JAX:

    JAX_PLATFORMS=cpu python tests/test_torch_devcache.py --write-expected [PART ...]

PART is any of ``tiers``, ``sf10``, ``spill`` and ``dml`` (all four when
none is named); each part rewrites its own key of
``trino_tpu_torch/testdata/plane_expected.json``.
"""
import json
import os
import sys
import threading
import time
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from trino_tpu import types as JT  # noqa: E402
from trino_tpu.client.session import Session as JaxSession  # noqa: E402
from trino_tpu.devcache import DEVICE_CACHE as JAX_DEVICE_CACHE  # noqa: E402
from trino_tpu.devcache import CacheKey as JaxCacheKey  # noqa: E402
from trino_tpu.devcache import DeviceTableCache as JaxDeviceTableCache  # noqa: E402
from trino_tpu.obs import metrics as jax_metrics  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch import types as T  # noqa: E402
from trino_tpu_torch.connector.memory.connector import MemoryConnector  # noqa: E402
from trino_tpu_torch.devcache import (  # noqa: E402
    DEVICE_CACHE, HOST_CACHE, CacheKey, DeviceTableCache, scan_cache_key)
from trino_tpu_torch.obs import metrics as M  # noqa: E402

PLANE_EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                              "trino_tpu_torch", "testdata", "plane_expected.json")
TIERS = ("dense", "fused", "merge-sorted", "merge-pallas", "legacy")

# the spill queries: joins (Q3), aggregation and a semi join (Q18), a left
# join (Q13); each runs under a quarter of the largest working set its
# unbudgeted run handed the spill decision, so that join or aggregation
# takes 4 partitions (a quarter of the whole peak leaves Q13's join at 2)
SPILL_QUERIES = (3, 18, 13)
SPILL_BUDGET_FRACTION = 4

# the DML sequence on a memory table copied from tpch.tiny.orders: each
# ("dml", sql) step mutates the table and each ("read", label) step runs
# DML_READ, which must miss right after a mutation and hit when repeated.
# What it checks does not depend on the row count; chip_smoke.py --profile
# also times the same statements over tpch.sf1.orders.
DML_READ = ("select o_orderstatus, count(*), sum(o_totalprice), min(o_orderdate), "
            "max(o_orderkey) from memory.db.orders group by o_orderstatus "
            "order by o_orderstatus")
DML_CTAS = "create table memory.db.orders as select * from tpch.tiny.orders"
DML_STEPS = (
    ("dml", DML_CTAS),
    ("read", "miss"),
    ("read", "hit"),
    ("dml", "insert into memory.db.orders select o_orderkey + 6000000, o_custkey, "
            "o_orderstatus, o_totalprice, o_orderdate, o_orderpriority, o_clerk, "
            "o_shippriority, o_comment from tpch.tiny.orders where o_orderkey < 1000"),
    ("read", "miss"),
    ("dml", "update memory.db.orders set o_totalprice = o_totalprice + 1 "
            "where o_orderkey < 1000"),
    ("read", "miss"),
    ("dml", "delete from memory.db.orders where o_orderstatus = 'P'"),
    ("read", "miss"),
    ("dml", "drop table memory.db.orders"),
    ("dml", DML_CTAS),
    ("read", "miss"),
    ("read", "hit"),
)


# ----------------------------------------------------------------- tests
@pytest.fixture
def fresh_caches():
    for c in (DEVICE_CACHE, HOST_CACHE, JAX_DEVICE_CACHE):
        c.invalidate_all()
    yield
    for c in (DEVICE_CACHE, HOST_CACHE, JAX_DEVICE_CACHE):
        c.invalidate_all()


def _counters(metrics):
    return {"hits": metrics.DEVICE_CACHE_HITS.value(),
            "misses": metrics.DEVICE_CACHE_MISSES.value(),
            "evictions": metrics.DEVICE_CACHE_EVICTIONS.value(),
            "staged_rows": metrics.STAGED_ROWS.value()}


def _delta(metrics, before):
    now = _counters(metrics)
    return {k: now[k] - before[k] for k in before}


def _port_session(catalogs=None, **props):
    return TorchSession({"catalog": "memory", "schema": "db",
                         "device_cache_enabled": True, **props},
                        device="cpu", catalogs=catalogs)


def _jax_session(catalogs=None, **props):
    return JaxSession({"catalog": "memory", "schema": "db",
                       "device_cache_enabled": True, **props}, catalogs=catalogs)


def _warm_then(session, metrics, sql, mutate):
    """The matrix step of the reference's test: a provably warm entry,
    then ``mutate``, then a miss and a hit. Returns the rows after it."""
    r1 = session.execute(sql).rows
    before = _counters(metrics)
    r2 = session.execute(sql).rows
    d = _delta(metrics, before)
    assert r1 == r2 and d["hits"] >= 1 and d["misses"] == 0
    mutate()
    before = _counters(metrics)
    r3 = session.execute(sql).rows
    assert _delta(metrics, before)["misses"] >= 1, "mutation did not invalidate"
    before = _counters(metrics)
    assert session.execute(sql).rows == r3
    d = _delta(metrics, before)
    assert d["hits"] >= 1 and d["misses"] == 0
    return r3


def test_invalidation_matrix_memory(fresh_caches):
    """INSERT, UPDATE, DELETE and DROP + CTAS each invalidate a warm entry
    (miss, then hit), in both packages, with equal rows."""
    results = []
    for sess, types_, metrics in ((_port_session(), T, M),
                                  (_jax_session(), JT, jax_metrics)):
        sess.catalogs["memory"].create_table(
            "db", "t", [("a", types_.BIGINT), ("b", types_.BIGINT)],
            [(i, i * 2) for i in range(500)])
        sql = "select sum(a), sum(b), count(*) from t"

        def drop_and_ctas(sess=sess):
            sess.execute("drop table t")
            sess.execute("create table t as select 1 a, 2 b")

        steps = [lambda sess=sess: sess.execute("insert into t values (1000, 2000)"),
                 lambda sess=sess: sess.execute("update t set b = 0 where a = 1000"),
                 lambda sess=sess: sess.execute("delete from t where a >= 250"),
                 drop_and_ctas]
        results.append([_warm_then(sess, metrics, sql, m) for m in steps])
    port, ref = results
    assert port == ref == [[(125750, 251500, 501)], [(125750, 249500, 501)],
                           [(31125, 62250, 250)], [(1, 2, 1)]]


def test_stale_version_entries_reclaimed(fresh_caches):
    """The lookup after a mutation drops the dead version's entry: one
    entry stays, not two, and the drop counts as an eviction."""
    s = _port_session()
    s.catalogs["memory"].create_table("db", "t", [("a", T.BIGINT)],
                                      [(i,) for i in range(100)])
    s.execute("select sum(a) from t")
    assert len(DEVICE_CACHE) == 1 and DEVICE_CACHE.cached_bytes() > 0
    s.execute("insert into t values (1)")
    before = _counters(M)
    assert s.execute("select sum(a) from t").rows == [(4951,)]
    assert len(DEVICE_CACHE) == 1
    assert _delta(M, before)["evictions"] >= 1


def _lru_sequence(cache_cls, key_cls, metrics, extra_key=()):
    """The reference test's LRU sequence; returns what it observed."""
    cache = cache_cls(max_bytes=1000)

    def key(i):
        return key_cls("c", "s", f"t{i}", "v1", "sig", "table", 1, *extra_key)

    def load(nbytes):
        return lambda: (object(), 10, nbytes, 1)

    seen = []
    e0 = metrics.DEVICE_CACHE_EVICTIONS.value()
    for i in (0, 1, 2):
        cache.lookup_or_stage(key(i), load(400))
        seen.append((cache.cached_bytes(), len(cache)))
    seen.append(metrics.DEVICE_CACHE_EVICTIONS.value() - e0)
    seen.append(cache.lookup_or_stage(key(0), load(400))[1])  # t0 was the victim
    cache.lookup_or_stage(key(9), load(5000))  # above the budget: served, not kept
    seen.append((cache.cached_bytes() <= 1000, cache.lookup_or_stage(key(9), load(5000))[1]))
    cache2 = cache_cls(max_bytes=1000)
    cache2.lookup_or_stage(key(5), load(600), admit_bytes=500)
    seen.append(len(cache2))
    cache2.lookup_or_stage(key(6), load(400))
    cache2.lookup_or_stage(key(7), load(400))
    cache2.lookup_or_stage(key(8), load(100), admit_bytes=150)
    seen.append((cache2.cached_bytes(), len(cache2)))
    freed = cache2.yield_bytes(500)
    seen.append((freed, sorted(e["table"] for e in cache2.snapshot())))
    return seen


def test_lru_eviction_under_byte_budget():
    port = _lru_sequence(DeviceTableCache, CacheKey, M, ("cpu",))
    ref = _lru_sequence(JaxDeviceTableCache, JaxCacheKey, jax_metrics)
    assert port == ref
    assert port[:5] == [(400, 1), (800, 2), (800, 2), 1, "miss"]


def test_follower_bypasses_stuck_leader():
    """A follower that outwaits FLIGHT_WAIT_S stages on its own instead of
    hanging behind a wedged leader."""
    cache = DeviceTableCache(max_bytes=10_000)
    cache.FLIGHT_WAIT_S = 0.05
    key = CacheKey("c", "s", "t", "v1", "sig", "table", 1, "cpu")
    release = threading.Event()
    leading = threading.Event()

    def stuck_loader():
        leading.set()
        release.wait(10.0)
        return object(), 1, 100, 1

    leader = threading.Thread(target=lambda: cache.lookup_or_stage(key, stuck_loader))
    leader.start()
    try:
        assert leading.wait(10.0)
        t0 = time.time()
        ent, disp = cache.lookup_or_stage(key, lambda: ("mine", 1, 100, 1))
        assert disp == "miss" and ent.value == "mine"
        assert time.time() - t0 < 5.0
    finally:
        release.set()
        leader.join(timeout=10.0)


def test_single_flight_concurrent_queries(fresh_caches):
    """Four concurrent queries over one cold table in sessions sharing the
    catalogs: one connector scan, one miss and three hits."""
    s = _port_session()
    mem = s.catalogs["memory"]
    mem.create_table("db", "t", [("a", T.BIGINT)], [(i,) for i in range(10_000)])
    scans = []
    real_scan = mem.scan

    def slow_scan(split, columns, constraint=None):
        scans.append(split.table)
        time.sleep(0.1)  # hold the flight open so the followers queue
        return real_scan(split, columns, constraint=constraint)

    mem.scan = slow_scan
    before = _counters(M)
    results, errors = [], []

    def run():
        try:
            results.append(_port_session(catalogs=s.catalogs)
                           .execute("select sum(a) from t").rows)
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert results == [[(49995000,)]] * 4
    assert scans == ["t"]
    d = _delta(M, before)
    assert d["misses"] == 1 and d["hits"] == 3


class _UnversionedMemory(MemoryConnector):
    """A connector that cannot say which version of a table it serves."""

    def data_version(self, schema, table):
        return None


def test_bypass_rules(fresh_caches):
    """A session without the cache, an unversioned connector and an open
    transaction never touch the cache, and still answer."""
    off = TorchSession({"catalog": "memory", "schema": "db"}, device="cpu")
    off.catalogs["memory"].create_table("db", "t", [("a", T.BIGINT)], [(1,), (2,)])
    before = _counters(M)
    assert off.execute("select sum(a) from t").rows == [(3,)]
    d = _delta(M, before)
    assert d["hits"] == d["misses"] == 0 and len(DEVICE_CACHE) == 0
    assert d["staged_rows"] == 2  # the scan still stages

    unversioned = _UnversionedMemory()
    s = _port_session(catalogs={"memory": unversioned})
    unversioned.create_table("db", "u", [("a", T.BIGINT)], [(5,)])
    before = _counters(M)
    assert s.execute("select a from u").rows == [(5,)]
    d = _delta(M, before)
    assert d["hits"] == d["misses"] == 0 and len(DEVICE_CACHE) == 0

    s = _port_session()
    s.catalogs["memory"].create_table("db", "tx", [("a", T.BIGINT)], [(1,), (2,)])
    s.transaction = object()  # an open transaction's overlay is unversioned
    before = _counters(M)
    assert s.execute("select sum(a) from tx").rows == [(3,)]
    d = _delta(M, before)
    assert d["hits"] == d["misses"] == 0 and len(DEVICE_CACHE) == 0
    s.transaction = None
    s.execute("select sum(a) from tx")
    assert len(DEVICE_CACHE) == 1


def test_private_catalogs_never_alias(fresh_caches):
    """Two sessions with private memory catalogs hold same-named tables at
    the same version: the connector's instance token keeps them apart."""
    s1, s2 = _port_session(), _port_session()
    s1.catalogs["memory"].create_table("db", "t", [("a", T.BIGINT)], [(1,)])
    s2.catalogs["memory"].create_table("db", "t", [("a", T.BIGINT)], [(42,)])
    assert s1.execute("select a from t").rows == [(1,)]
    assert s2.execute("select a from t").rows == [(42,)]
    assert len(DEVICE_CACHE) == 2


def test_signature_separates_projection_and_constraint(fresh_caches):
    """A wider projection and a pushed constraint each get their own
    entry, with as many distinct signatures as the reference's."""
    counts = []
    for sess, types_, cache in ((_port_session(), T, DEVICE_CACHE),
                                (_jax_session(), JT, JAX_DEVICE_CACHE)):
        sess.catalogs["memory"].create_table(
            "db", "t", [("a", types_.BIGINT), ("b", types_.BIGINT)],
            [(i, i * 2) for i in range(100)])
        rows = [sess.execute(q).rows for q in (
            "select a from t", "select a, b from t", "select a from t where a < 10")]
        sigs = {(e["table"], e["signature"]) for e in cache.snapshot()}
        assert len(sigs) == len(cache) >= 2
        counts.append((len(cache), rows))
    assert counts[0] == counts[1]


def test_cache_keys_differ_by_device(fresh_caches):
    """Port only: the pool is process-wide, so a key names its device; the
    same scan from a CPU and a CUDA session never shares an entry."""
    from trino_tpu_torch.exec.query import plan_sql
    from trino_tpu_torch.sql.planner import plan as P

    s = _port_session()
    s.catalogs["memory"].create_table("db", "t", [("a", T.BIGINT)], [(1,)])
    node = next(n for n in P.walk_plan(plan_sql(s, "select a from t"))
                if isinstance(n, P.TableScanNode))
    cuda_like = types.SimpleNamespace(properties=s.properties, catalogs=s.catalogs,
                                      transaction=None, device="cuda:0")
    k_cpu = scan_cache_key(s, node, None, {})
    k_cuda = scan_cache_key(cuda_like, node, None, {})
    assert k_cpu is not None and k_cuda is not None
    assert k_cpu != k_cuda and k_cpu.device == "cpu" and k_cuda.device == "cuda:0"
    assert k_cpu.table_id() != k_cuda.table_id()
    assert (k_cpu.signature, k_cpu.data_version) == (k_cuda.signature, k_cuda.data_version)


REPR_CASES = [
    ("timestamp3", lambda t: t.timestamp(3),
     ["2020-02-29 12:34:56.789", None, "1969-12-31 23:59:59.001"]),
    ("timestamp6_tz", lambda t: t.timestamp(6, with_tz=True),
     ["2021-06-01 00:00:00.000001+02:00", "1970-01-01 00:00:00+00:00"]),
    ("date", lambda t: t.DATE, ["1992-01-02", None, "1969-12-31", "2000-02-29"]),
    ("decimal12_2", lambda t: t.decimal(12, 2), ["123.45", "-0.01", None, "0.005", "99"]),
    ("decimal38_4", lambda t: t.decimal(38, 4),
     ["12345678901234567890123456789.1234", "-1.00005", None]),
    ("boolean", lambda t: t.BOOLEAN, [True, False, None]),
    ("double", lambda t: t.DOUBLE, [1.5, None, -0.0, 1e300]),
    ("bigint", lambda t: t.BIGINT, [2**62, None, -7]),
]


@pytest.mark.parametrize("case", [c[0] for c in REPR_CASES])
def test_python_value_conversions_equal_reference(case):
    """The port's Python-value conversions that INSERT, CTAS and query
    results go through (one type dispatch a column) give the reference's
    storage values and Python values, NULLs and long decimals included."""
    import datetime
    import decimal

    import numpy as np

    from trino_tpu.data import page as jax_page
    from trino_tpu_torch.data import page as port_page

    _, make, raw = next(c for c in REPR_CASES if c[0] == case)
    port_t, ref_t = make(T), make(JT)
    if port_t.is_decimal:
        raw = [None if v is None else decimal.Decimal(v) for v in raw]
    elif isinstance(port_t, T.TimestampType):
        raw = [None if v is None else datetime.datetime.fromisoformat(v) for v in raw]
    elif port_t == T.DATE:
        raw = [None if v is None else datetime.date.fromisoformat(v) for v in raw]
    cd = port_page.column_data_from_python(port_t, raw)
    want = [0 if v is None else jax_page._to_repr(ref_t, v) for v in raw]
    vals = np.asarray(cd.values)
    got = ([(int(h) << 64) | int(lo) for h, lo in zip(cd.hi, vals.view(np.uint64))]
           if cd.hi is not None else vals.tolist())
    assert got == want
    col = port_page.Column(port_t, port_page.to_device(vals, "cpu"),
                           None if cd.nulls is None else port_page.to_device(cd.nulls, "cpu"),
                           hi=None if cd.hi is None else port_page.to_device(cd.hi, "cpu"))
    assert col.to_python() == [None if v is None else jax_page._from_repr(ref_t, r)
                               for v, r in zip(raw, want)]


def test_plane_expected_file_matches():
    """The committed expected data carries the SQL the smoke run executes:
    22 queries' cached tiers, Q3 at SF10, the spill queries and the DML
    sequence with its dispositions."""
    with open(PLANE_EXPECTED) as f:
        data = json.load(f)
    assert sorted(data["tiers_cached"], key=int) == [str(q) for q in range(1, 23)]
    for q in ("5", "9"):  # a cached sorted build takes them to the merge tier
        assert data["tiers_cached"][q]["cold"]["merge-sorted"] == 1
    for q in ("2", "17", "18"):
        assert data["tiers_cached"][q]["warm"]["merge-pallas"] >= 1
    assert data["sf10"]["3"]["sql"] == QUERIES[3] and len(data["sf10"]["3"]["rows"]) == 10
    assert [int(q) for q in data["spill"]] == list(SPILL_QUERIES)
    for q in SPILL_QUERIES:
        entry = data["spill"][str(q)]
        assert entry["sql"] == QUERIES[q] and entry["rows_unbudgeted_equal"]
        assert max(sp["partitions"] for sp in entry["spills"]) >= 4
    steps = data["dml"]["steps"]
    assert [(st["kind"], st["disposition"]) for st in steps] == [
        (k, a if k == "read" else None) for k, a in DML_STEPS]


def jsonable_rows(rows):
    """Rows with decimals and dates as strings (chip_smoke.py's form)."""
    return [[v if v is None or isinstance(v, (int, float, str)) else str(v) for v in r]
            for r in rows]


def _tier_counts(metric):
    return {t: metric.value(t) for t in TIERS}


def _cached_props(schema):
    return {"catalog": "tpch", "schema": schema, "fused_join_pallas": True,
            "device_cache_enabled": True}


def _write_tiers(out):
    """Each SF1 query's join tiers with the cache on, cold then warm."""
    session = JaxSession(properties=_cached_props("sf1"))
    tiers = {}
    for q in range(1, 23):
        runs = {}
        for label in ("cold", "warm"):
            t0 = _tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
            session.execute(QUERIES[q])
            t1 = _tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
            runs[label] = {t: t1[t] - t0[t] for t in TIERS}
        tiers[str(q)] = runs
        print(f"tiers Q{q}: {runs}", flush=True)
    out["tiers_cached"] = tiers


def _write_sf10(out):
    session = JaxSession(properties=_cached_props("sf10"))
    res = session.execute(QUERIES[3])
    out["sf10"] = {"3": {"sql": QUERIES[3], "schema": "sf10",
                         "columns": list(res.column_names),
                         "rows": jsonable_rows(res.rows)}}
    print(f"sf10 Q3: {len(res.rows)} rows", flush=True)


def _run_with_memory(props, sql):
    """(MemoryContext, rows, the largest working set handed to the spill
    decision) of one run."""
    from trino_tpu.exec import memory as jax_memory
    from trino_tpu.exec.executor import Executor
    from trino_tpu.exec.query import plan_sql

    seen = [0]
    orig = jax_memory.MemoryContext.spill_partitions

    def spy(self, projected_bytes):
        seen[0] = max(seen[0], int(projected_bytes))
        return orig(self, projected_bytes)

    jax_memory.MemoryContext.spill_partitions = spy
    try:
        s = JaxSession(properties=props)
        ex = Executor(s)
        page = ex.execute_checked(plan_sql(s, sql))
    finally:
        jax_memory.MemoryContext.spill_partitions = orig
    return ex.memory, page.to_pylist(), seen[0]


def _write_spill(out):
    spill = {}
    for q in SPILL_QUERIES:
        mem, rows, projected = _run_with_memory(_cached_props("sf1"), QUERIES[q])
        budget = projected // SPILL_BUDGET_FRACTION
        props = dict(_cached_props("sf1"), query_max_device_memory=budget)
        smem, srows, _ = _run_with_memory(props, QUERIES[q])
        spill[str(q)] = {
            "sql": QUERIES[q], "peak": mem.peak, "peak_projected": projected,
            "budget": budget,
            "rows": jsonable_rows(srows),
            "rows_unbudgeted_equal": srows == rows,
            "spills": [{"kind": e.kind, "partitions": e.partitions,
                        "projected_bytes": e.projected_bytes} for e in smem.spills],
            "shed_bytes": smem.shed_bytes,
        }
        print(f"spill Q{q}: peak {mem.peak} budget {budget} "
              f"spills {spill[str(q)]['spills']} same={srows == rows}", flush=True)
    out["spill"] = spill


def _write_dml(out):
    from trino_tpu.connector.registry import default_catalogs

    session = JaxSession(properties={"catalog": "tpch", "schema": "tiny",
                                     "device_cache_enabled": True},
                         catalogs=default_catalogs())
    steps = []
    for kind, arg in DML_STEPS:
        sql = DML_READ if kind == "read" else arg
        h0, m0 = jax_metrics.DEVICE_CACHE_HITS.value(), jax_metrics.DEVICE_CACHE_MISSES.value()
        res = session.execute(sql)
        disposition = None
        if kind == "read":
            # the one scan's disposition, as the reference observed it
            hits = jax_metrics.DEVICE_CACHE_HITS.value() - h0
            misses = jax_metrics.DEVICE_CACHE_MISSES.value() - m0
            disposition = "hit" if (hits, misses) == (1, 0) else \
                "miss" if (hits, misses) == (0, 1) else f"hits {hits} misses {misses}"
            assert disposition == arg, (sql, disposition, arg)
        steps.append({"kind": kind, "sql": sql, "disposition": disposition,
                      "rows": jsonable_rows(res.rows)})
        print(f"dml {kind}: {sql[:60]} -> {res.rows[:3]}", flush=True)
    out["dml"] = {"read": DML_READ, "steps": steps}


def write_expected(parts):
    out = {}
    if os.path.exists(PLANE_EXPECTED):
        with open(PLANE_EXPECTED) as f:
            out = json.load(f)
    out["writer"] = ("trino_tpu (JAX, CPU) via tests/test_torch_devcache.py "
                     "--write-expected")
    writers = {"tiers": _write_tiers, "sf10": _write_sf10, "spill": _write_spill,
               "dml": _write_dml}
    for part in parts or list(writers):
        writers[part](out)
        with open(PLANE_EXPECTED, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write-expected"]:
        import resource
        import time

        t0 = time.perf_counter()
        write_expected(sys.argv[2:])
        print(f"wrote {sys.argv[2:] or 'all parts'} in {time.perf_counter() - t0:.0f} s, "
              f"peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GiB",
              flush=True)
    else:
        sys.exit("usage: python tests/test_torch_devcache.py --write-expected [PART ...]")
