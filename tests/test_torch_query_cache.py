"""The port's query caching subsystem (trino_tpu_torch/cache/) against the
JAX package's (trino_tpu/cache/), on the CPU.

The cases are those of the reference's tests/test_query_cache.py, each run
through both packages: the unit cases (fingerprints, determinism, the
result cache's TTL, LRU, admission and single flight, the plan cache's
revalidation and user partitions) through each package's own modules, and
the coordinator cases through a port CPU cluster beside a JAX CPU cluster
(a coordinator and two workers each, in this process), comparing rows,
dispositions (HIT / MISS / BYPASS from the ``X-Trino-Tpu-Cache`` header)
and counter deltas. Then the port's own: the optimized plans of the 22
TPC-H queries at tiny canonicalize to the reference's text character for
character, and a cached plan is unchanged after two executions and
pickles without a tensor.

Left out by name: ``test_gencache_lru_eviction_and_counters`` and
``test_gencache_accumulates_columns_per_entry`` (the datagen cache is not
this slice), ``test_niladic_keyword_yields_to_real_columns`` (a planner
case, not a cache one; the planner copy is held by the statement tests)
and ``test_cli_summary_prints_cache_status`` (the CLI, ROADMAP queue 1,
item 8).
"""
import io
import os
import pickle
import sys
import threading
import time
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from tpch_sql import QUERIES  # noqa: E402

TINY = {"catalog": "tpch", "schema": "tiny"}
CLIENT_TIMEOUT = 120.0


def _package(name):
    """Each package's modules as the cases below reach them."""
    import importlib

    root = "trino_tpu" if name == "jax" else "trino_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    session_cls = mod("client.session").Session

    def session(props=None, **kw):
        if name == "torch":
            kw.setdefault("device", "cpu")
        return session_cls(dict(TINY if props is None else props), **kw)

    return types.SimpleNamespace(
        name=name, session=session, M=mod("obs.metrics"), plan_key=mod("cache.plan_key"),
        determinism=mod("cache.determinism"), result_cache=mod("cache.result_cache"),
        security=mod("server.security"), query=mod("exec.query"),
        parser=mod("sql.parser.parser"), ast=mod("sql.parser.ast"), plan=mod("sql.planner.plan"),
        remote=mod("client.remote"), dbapi=mod("client.dbapi"),
        coordinator=mod("server.coordinator"), worker=mod("server.worker"))


JAX = _package("jax")
TORCH = _package("torch")
PACKAGES = pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])


def both(case, *args):
    """Run ``case(pkg, *args)`` on each package; its observations must be
    equal."""
    want = case(JAX, *args)
    got = case(TORCH, *args)
    assert got == want, f"{case.__name__}: the port's {got} != the reference's {want}"
    return got


def _plan(pkg, sql, props=None):
    return pkg.query.plan_sql(pkg.session(props), sql)


# ------------------------------------------------------------ canonical keys
@PACKAGES
def test_fingerprint_stable_across_plantings(pkg):
    sql = """select l_returnflag, sum(l_quantity) from lineitem
             where l_shipdate <= date '1998-09-02' group by l_returnflag"""
    a, b = _plan(pkg, sql), _plan(pkg, sql)
    assert [n.id for n in pkg.plan.walk_plan(a)] != [n.id for n in pkg.plan.walk_plan(b)]
    assert pkg.plan_key.canonicalize_plan(a) == pkg.plan_key.canonicalize_plan(b)
    assert pkg.plan_key.plan_fingerprint(a) == pkg.plan_key.plan_fingerprint(b)


def _fingerprints(pkg):
    fp = pkg.plan_key.plan_fingerprint
    base = _plan(pkg, "select count(*) from orders where o_orderkey < 100")
    v1 = [(("tpch", "tiny", "orders"), "v1")]
    v2 = [(("tpch", "tiny", "orders"), "v2")]
    return [fp(base),
            fp(_plan(pkg, "select count(*) from orders where o_orderkey < 101")),
            fp(_plan(pkg, "select count(*) from lineitem where l_orderkey < 100")),
            fp(base, v1), fp(base, v2), fp(base, list(v1), extra=("user=a",))]


def test_fingerprints_distinguish_literals_tables_versions():
    """Each fingerprint differs from the others, and the port's equal the
    reference's (sha256 over the same canonical text)."""
    fps = both(_fingerprints)
    assert len(set(fps)) == len(fps)


def _capture_versions(pkg):
    s = pkg.session()
    out = [pkg.plan_key.capture_versions(s, _plan(pkg, "select count(*) from orders"))]
    s.execute("create table memory.default.cv (a bigint)")
    root = pkg.query.plan_sql(s, "select a from memory.default.cv")
    before = pkg.plan_key.capture_versions(s, root)
    s.execute("insert into memory.default.cv values (1)")
    after = pkg.plan_key.capture_versions(s, root)
    assert out[0] == [(("tpch", "tiny", "orders"), "immutable")] and before != after
    return out + [before, after]


def test_capture_versions_immutable_and_memory():
    both(_capture_versions)


# --------------------------------------------------------------- determinism
DETERMINISM_SQL = (
    "select count(*) from orders",
    "select 1",
    "select random()",
    "select now()",
    "select * from TABLE(sequence(1, 10))",
    "create table memory.default.dx (a bigint)",
    "select current_date",
    "select * from (select random() r from orders) t where r > 0.5",
)


def _reasons(pkg):
    out = []
    for sql in DETERMINISM_SQL:
        stmt = pkg.parser.parse_statement(sql)
        root = _plan(pkg, sql) if isinstance(stmt, pkg.ast.Query) else None
        out.append(pkg.determinism.uncachable_reason(stmt, root))
    out.append([pkg.determinism.contains_table_function(pkg.parser.parse_statement(sql))
                for sql in DETERMINISM_SQL])
    return out


def test_determinism_analysis():
    reasons = both(_reasons)
    assert reasons[0] is None and reasons[1] is None
    assert "random" in reasons[2] and "now" in reasons[3]
    assert "table function" in reasons[4] and "not a SELECT" in reasons[5]
    assert reasons[6] is not None and "random" in reasons[7]
    assert reasons[8] == [False, False, False, False, True, False, False, False]


# ------------------------------------------------------- result cache (unit)
def _cache(pkg, max_bytes=1 << 20):
    return pkg.result_cache.ResultCache(max_bytes=max_bytes)


def _hit_miss_ttl(pkg):
    c = _cache(pkg)
    out = [c.begin("k1")[0]]
    c.complete("k1", ["a"], [(1,)], ttl_ms=40)
    out.append(c.begin("k1"))
    time.sleep(0.06)
    out.append(c.begin("k1")[0])  # expired: lead again
    c.abandon("k1")
    assert out == ["lead", ("hit", (["a"], [(1,)])), "lead"]
    return out


def _lru_by_bytes(pkg):
    c = _cache(pkg, max_bytes=40_000)
    ev0 = pkg.M.RESULT_CACHE_EVICTIONS.value()
    rows = [("x" * 100,) for _ in range(30)]  # ~6.7 KB an entry
    for i in range(10):
        assert c.begin(f"k{i}")[0] == "lead"
        c.complete(f"k{i}", ["a"], rows, ttl_ms=60_000)
    out = [c.cached_bytes(), len(c), pkg.M.RESULT_CACHE_EVICTIONS.value() - ev0,
           pkg.M.RESULT_CACHE_BYTES.value(), c.begin("k9")[0], c.begin("k0")[0]]
    c.abandon("k0")
    assert out[0] <= 40_000 and out[2] > 0 and out[4:] == ["hit", "lead"]
    return out


def _giant_entry(pkg):
    c = _cache(pkg, max_bytes=10_000)
    out = [c.begin("big")[0]]
    c.complete("big", ["a"], [("y" * 200,) for _ in range(100)], ttl_ms=60_000)
    out.append(c.begin("big")[0])  # never admitted
    c.abandon("big")
    assert out == ["lead", "lead"]
    return out


def _session_budget(pkg):
    c = _cache(pkg, max_bytes=1 << 20)
    c.begin("other")
    c.complete("other", ["a"], [(1,)], ttl_ms=60_000)
    c.begin("tiny-budget")
    c.complete("tiny-budget", ["a"], [("x" * 500,)], ttl_ms=60_000, max_bytes=64)
    out = [c.max_bytes, c.begin("other")[0], c.begin("tiny-budget")[0]]
    c.abandon("tiny-budget")
    assert out == [1 << 20, "hit", "lead"]
    return out


def _single_flight(pkg):
    c = _cache(pkg)
    assert c.begin("sf")[0] == "lead"
    got = []

    def follower():
        kind, flight = c.begin("sf")
        assert kind == "wait"
        assert flight.wait(5.0)
        got.append(flight.value)

    threads = [threading.Thread(target=follower) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    c.complete("sf", ["a"], [(42,)], ttl_ms=60_000)
    for t in threads:
        t.join(5.0)
    assert got == [(["a"], [(42,)])] * 3
    return got


def _abandon(pkg):
    c = _cache(pkg)
    out = [c.begin("ab")[0]]
    kind, flight = c.begin("ab")
    c.abandon("ab")
    out += [kind, flight.wait(5.0), flight.ok]
    assert out == ["lead", "wait", True, False]
    return out


@pytest.mark.parametrize("case", [_hit_miss_ttl, _lru_by_bytes, _giant_entry, _session_budget,
                                  _single_flight, _abandon],
                         ids=["hit_miss_ttl", "lru_by_bytes", "giant_entry", "session_budget",
                              "single_flight", "abandon"])
def test_result_cache_unit(case):
    both(case)


def test_single_flight_32_threads_never_read_before_complete():
    """The port's result cache with 32 threads on one key and a short
    switch interval: one leader, 31 followers; no follower wakes before the
    leader's ``complete`` and each reads exactly the leader's rows."""
    c = TORCH.result_cache.ResultCache()
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    barrier = threading.Barrier(32)
    completed_at = []
    seen = []
    lock = threading.Lock()

    def run():
        barrier.wait()
        kind, flight = c.begin("k")
        if kind == "lead":
            time.sleep(0.05)
            completed_at.append(time.monotonic())
            c.complete("k", ["a"], [(7,)], ttl_ms=60_000)
            return
        if kind == "hit":
            with lock:
                seen.append(("hit", flight, None))
            return
        assert flight.wait(10.0)
        with lock:
            seen.append(("wait", (flight.ok, flight.value), time.monotonic()))

    try:
        threads = [threading.Thread(target=run) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert len(completed_at) == 1 and len(seen) == 31
    for kind, value, woke in seen:
        assert value == ((True, (["a"], [(7,)])) if kind == "wait" else (["a"], [(7,)]))
        if woke is not None:
            assert woke >= completed_at[0]


# --------------------------------------------------------- plan cache (unit)
def _plan_cache_revalidates(pkg):
    s = pkg.session({"catalog": "memory", "schema": "default"})
    s.execute("create table pc (a bigint)")
    s.execute("insert into pc values (1)")
    pc = pkg.result_cache.PlanCache()
    sql = "select a from pc"
    root = pkg.query.plan_sql(s, sql)
    pc.put(s, sql, root)
    hit_root, versions = pc.get(s, sql)
    assert hit_root is root
    s.execute("insert into pc values (2)")  # version bump: the plan is stale
    out = [versions, pc.get(s, sql)]
    assert out == [[(("memory", "default", "pc"), "v2")], None]
    return out


def _plan_cache_partitions_by_user(pkg):
    Identity = pkg.security.Identity
    a = pkg.session(identity=Identity("alice"))
    b = pkg.session(identity=Identity("bob"))
    key = pkg.result_cache.PlanCache.key_for
    out = [key(a, "select 1") != key(b, "select 1"), key(a, "select 1") == key(a, "select 1"),
           key(a, " select 1 ")[:2]]
    assert out == [True, True, ("select 1", "alice")]
    return out


@pytest.mark.parametrize("case", [_plan_cache_revalidates, _plan_cache_partitions_by_user],
                         ids=["revalidates_versions", "partitions_by_user"])
def test_plan_cache_unit(case):
    both(case)


# ----------------------------------------------------- the coordinator cases
def _start(pkg):
    kw = {"device": "cpu"} if pkg.name == "torch" else {}
    coord = pkg.coordinator.CoordinatorServer(**kw)
    coord.start()
    workers = [pkg.worker.WorkerServer(coordinator_url=coord.base_url, node_id=f"qc{i}", **kw)
               for i in range(2)]
    for w in workers:
        w.start()
    return coord, workers


@pytest.fixture(scope="module")
def clusters():
    started = []
    try:
        for pkg in (JAX, TORCH):
            coord, workers = _start(pkg)
            started.append((coord, workers))
            assert coord.registry.wait_for_workers(2, timeout=15.0)
        yield {"jax": started[0][0], "torch": started[1][0]}
    finally:
        for coord, workers in started:
            for w in workers:
                w.stop()
            coord.stop()


class Ctx:
    """One package's cluster as a scenario sees it."""

    def __init__(self, pkg, coord):
        self.pkg, self.coord, self.M = pkg, coord, pkg.M

    def client(self, **props):
        base = {"catalog": "memory", "schema": "default", "result_cache_enabled": "true"}
        return self.pkg.remote.StatementClient(self.coord.base_url, {**base, **props})

    def run(self, client, sql):
        """(rows as tuples, disposition) of one statement."""
        _cols, rows = client.execute(sql, timeout=CLIENT_TIMEOUT)
        return [tuple(r) for r in rows], client.cache_status


def on_clusters(clusters, scenario):
    """The scenario on the JAX cluster, then on the port's: equal
    observations."""
    want = scenario(Ctx(JAX, clusters["jax"]))
    got = scenario(Ctx(TORCH, clusters["torch"]))
    assert got == want, f"{scenario.__name__}: the port's {got} != the reference's {want}"
    return got


def dml_ddl_invalidation_matrix(ctx):
    c = ctx.client()
    sql = "select a, b from minv order by a"
    out = [ctx.run(c, "create table minv (a bigint, b varchar)")[1],
           ctx.run(c, "insert into minv values (1, 'x'), (2, 'y')")[1]]
    out += [ctx.run(c, sql), ctx.run(c, sql)]
    for stmt in ("insert into minv values (3, 'z')", "update minv set b = 'q' where a = 2",
                 "delete from minv where a = 1"):
        ctx.run(c, stmt)
        out += [ctx.run(c, sql), ctx.run(c, sql)[1]]
    ctx.run(c, "drop table minv")
    ctx.run(c, "create table minv as select * from (values (7, 'n')) t(a, b)")
    out += [ctx.run(c, sql), ctx.run(c, sql)[1]]
    assert out[:4] == ["BYPASS", "BYPASS", ([(1, "x"), (2, "y")], "MISS"),
                       ([(1, "x"), (2, "y")], "HIT")]
    assert out[4] == ([(1, "x"), (2, "y"), (3, "z")], "MISS") and out[5] == "HIT"
    assert out[6] == ([(1, "x"), (2, "q"), (3, "z")], "MISS") and out[7] == "HIT"
    assert out[8] == ([(2, "q"), (3, "z")], "MISS") and out[9] == "HIT"
    assert out[10] == ([(7, "n")], "MISS") and out[11] == "HIT"
    return out


def nondeterministic_queries_bypass(ctx):
    c = ctx.client()
    ctx.run(c, "create table ndet (a bigint)")
    ctx.run(c, "insert into ndet values (1)")
    b0 = ctx.M.RESULT_CACHE_BYPASSES.value()
    out = [ctx.run(c, sql)[1] for sql in ("select a from ndet where random() >= 0",
                                           "select a, now() from ndet",
                                           "select * from TABLE(sequence(1, 3))")]
    out.append(ctx.M.RESULT_CACHE_BYPASSES.value() - b0)
    assert out == ["BYPASS", "BYPASS", "BYPASS", 3]
    return out


def cache_disabled_reports_bypass_without_metric(ctx):
    c = ctx.client(result_cache_enabled="false")
    b0 = ctx.M.RESULT_CACHE_BYPASSES.value()
    out = [ctx.run(c, "select 1"), ctx.M.RESULT_CACHE_BYPASSES.value() - b0]
    assert out == [([(1,)], "BYPASS"), 0]
    return out


def concurrent_identical_queries_single_flight(ctx):
    setup = ctx.client()
    ctx.run(setup, "create table sfq (a bigint)")
    ctx.run(setup, "insert into sfq values " + ", ".join(f"({i})" for i in range(500)))
    sql = "select count(*), sum(a), min(a), max(a) from sfq where a % 7 <> 3"
    h0, m0 = ctx.M.RESULT_CACHE_HITS.value(), ctx.M.RESULT_CACHE_MISSES.value()
    results = []

    def run_one():
        results.append(ctx.run(ctx.client(), sql)[0])

    threads = [threading.Thread(target=run_one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    out = [len(results), all(r == results[0] for r in results), results[0],
           ctx.M.RESULT_CACHE_MISSES.value() - m0, ctx.M.RESULT_CACHE_HITS.value() - h0]
    assert out[:2] == [4, True] and out[3:] == [1, 3]
    return out


def table_functions_never_plan_cache(ctx):
    c = ctx.client(catalog="tpch", schema="tiny", result_cache_enabled="false")
    ph0 = ctx.M.PLAN_CACHE_HITS.value()
    out = [ctx.run(c, "select * from TABLE(sequence(4, 6))"),
           ctx.run(c, "select * from TABLE(sequence(4, 6))"),
           ctx.M.PLAN_CACHE_HITS.value() - ph0]
    assert out[2] == 0
    return out


Q1 = """
    select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
           avg(l_extendedprice) as avg_price, count(*) as count_order
    from lineitem
    where l_shipdate <= date '1998-09-02'
    group by l_returnflag, l_linestatus
    order by l_returnflag, l_linestatus
"""


def _last_query(coord):
    return coord.queries[sorted(coord.queries)[-1]]


def repeated_tpch_q1_hits_and_skips_execution(ctx):
    c = ctx.client(catalog="tpch", schema="tiny")
    first = ctx.run(c, Q1)
    names1 = {s["name"] for s in _last_query(ctx.coord).tracer.to_dicts()}
    tasks0 = ctx.M.TASKS_TOTAL.value()
    second = ctx.run(c, Q1)
    q2 = _last_query(ctx.coord)
    names2 = {s["name"] for s in q2.tracer.to_dicts()}
    out = [first, second, ctx.M.TASKS_TOTAL.value() - tasks0, q2.info()["cacheStatus"],
           {"schedule", "execute/root-fragment", "cache/lookup"} <= names1,
           # the reference's dispatch plane may answer a repeat without
           # planning ("dispatch/serve"); the port's has no dispatch plane
           "cache/lookup" in names2 or "dispatch/serve" in names2,
           sorted(names2 & {"schedule", "fragment", "execute/root-fragment", "optimize"})]
    assert first[1] == "MISS" and second == (first[0], "HIT")
    assert out[2:] == [0, "HIT", True, True, []]
    return out


def dbapi_cursor_exposes_cache_status(ctx):
    conn = ctx.pkg.dbapi.connect(coordinator_url=ctx.coord.base_url, catalog="memory",
                                 schema="default", result_cache_enabled="true")
    cur = conn.cursor()
    out = []
    for sql in ("create table dbc (a bigint)", "insert into dbc values (5)",
                "select a from dbc", "select a from dbc"):
        cur.execute(sql)
        out.append(cur.cache_status)
    out.append(cur.fetchall())
    conn.close()
    assert out == ["BYPASS", "BYPASS", "MISS", "HIT", [(5,)]]
    return out


def udf_redefinition_invalidates_cached_plan(ctx):
    c = ctx.client()
    ctx.run(c, "create table udfc (a bigint)")
    ctx.run(c, "insert into udfc values (10)")
    ctx.run(c, "create function cadd(x bigint) returns bigint return x + 1")
    out = [ctx.run(c, "select cadd(a) from udfc")]
    ctx.run(c, "create or replace function cadd(x bigint) returns bigint return x + 5")
    out.append(ctx.run(c, "select cadd(a) from udfc"))
    assert out == [([(11,)], "MISS"), ([(15,)], "MISS")]
    return out


def ttl_expiry_end_to_end(ctx):
    c = ctx.client(result_cache_ttl_ms="150")
    ctx.run(c, "create table ttlq (a bigint)")
    ctx.run(c, "insert into ttlq values (1)")
    out = [ctx.run(c, "select a from ttlq")[1], ctx.run(c, "select a from ttlq")[1]]
    time.sleep(0.25)
    out.append(ctx.run(c, "select a from ttlq")[1])
    assert out == ["MISS", "HIT", "MISS"]
    return out


def plan_cache_repeat_hits(ctx):
    """A repeated SELECT reuses its plan by default (no
    ``result_cache_enabled``): one plan-cache hit, no optimize span."""
    c = ctx.client(catalog="tpch", schema="tiny", result_cache_enabled="false")
    sql = "select n_name from nation where n_regionkey = 3 order by n_name"
    h0, m0 = ctx.M.PLAN_CACHE_HITS.value(), ctx.M.PLAN_CACHE_MISSES.value()
    out = [ctx.run(c, sql), ctx.run(c, sql),
           ctx.M.PLAN_CACHE_HITS.value() - h0, ctx.M.PLAN_CACHE_MISSES.value() - m0,
           "optimize" in {s["name"] for s in _last_query(ctx.coord).tracer.to_dicts()}]
    assert out[2:] == [1, 1, False]
    return out


@pytest.mark.parametrize("scenario", [
    dml_ddl_invalidation_matrix, nondeterministic_queries_bypass,
    cache_disabled_reports_bypass_without_metric, concurrent_identical_queries_single_flight,
    table_functions_never_plan_cache, repeated_tpch_q1_hits_and_skips_execution,
    dbapi_cursor_exposes_cache_status, udf_redefinition_invalidates_cached_plan,
    ttl_expiry_end_to_end, plan_cache_repeat_hits], ids=lambda f: f.__name__)
def test_coordinator_cache(clusters, scenario):
    on_clusters(clusters, scenario)


# ----------------------------------------------- the port's plans and trees
def test_canonical_plans_equal_the_reference_tpch():
    """The port's optimized plans of the 22 TPC-H queries at tiny
    canonicalize to the reference's text, character for character (the
    canonical text is built from ``repr`` of every plan field)."""
    js, ts = JAX.session(), TORCH.session()
    for q in sorted(QUERIES):
        want = JAX.plan_key.canonicalize_plan(JAX.query.plan_sql(js, QUERIES[q]))
        got = TORCH.plan_key.canonicalize_plan(TORCH.query.plan_sql(ts, QUERIES[q]))
        assert got == want, f"Q{q}: the canonical plans differ"


class _RefuseTensors(pickle.Pickler):
    """A pickler that raises on a torch tensor anywhere in the object."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            raise AssertionError("a tensor reached the pickled plan")
        return NotImplemented


def test_cached_plans_survive_execution_unchanged():
    """Each TPC-H query twice through a port coordinator with two workers:
    the second run is a plan-cache hit, the cached root's canonical text
    is the same before and after both runs, and the root pickles with no
    tensor in it."""
    coord, workers = _start(TORCH)
    try:
        assert coord.registry.wait_for_workers(2, timeout=15.0)
        client = TORCH.remote.StatementClient(coord.base_url, dict(TINY))
        cache = coord.query_cache.plans
        for q in sorted(QUERIES):
            h0 = TORCH.M.PLAN_CACHE_HITS.value()
            _c, rows1 = client.execute(QUERIES[q], timeout=CLIENT_TIMEOUT)
            session = TORCH.session()
            root, _versions = cache.get(session, QUERIES[q])
            before = TORCH.plan_key.canonicalize_plan(root)
            _c, rows2 = client.execute(QUERIES[q], timeout=CLIENT_TIMEOUT)
            assert TORCH.M.PLAN_CACHE_HITS.value() - h0 == 1, f"Q{q}: no plan-cache hit"
            assert rows2 == rows1, f"Q{q}"
            again, _ = cache.get(session, QUERIES[q])
            assert again is root
            assert TORCH.plan_key.canonicalize_plan(root) == before, f"Q{q}: plan written"
            _RefuseTensors(io.BytesIO()).dump(root)
    finally:
        for w in workers:
            w.stop()
        coord.stop()
