"""The compiled tier's modules in the port against the JAX package's on the
same inputs, on the CPU: ``flatten_page``/``unflatten_page``
(exec/page_tree.py), the dense membership table and probe (ops/join.py),
the in-body dynamic-filter mask (``_traced_domain_mask``), phase 1's
``resolve_dynamic_filters`` (exec/host_eval.py), ``CompiledQuery.build``'s
decisions with and without ``adaptive_capacity_reseed``
(adaptive/reseed.py), the recompile loop, the deferred query errors, the
warm cached build that stages nothing (TPC-DS q95 and q64 at ``tiny`` are
in test_torch_compiled_more.py), the
repaired ``grow_overflowed_hints`` over tensor flags, the executor's
compiled-tier seams and the tier's metrics and spans.

Tolerance: exact everywhere (integer keys and masks; rows as in the other
port tests).
"""
import os
import sys
from decimal import Decimal

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
import jax.numpy as jnp  # noqa: E402
from trino_tpu import types as JT  # noqa: E402
from trino_tpu.client.session import Session as JaxSession  # noqa: E402
from trino_tpu.data.page import Column as JaxColumn  # noqa: E402
from trino_tpu.data.page import Page as JaxPage  # noqa: E402
from trino_tpu.exec import compiled as j_compiled  # noqa: E402
from trino_tpu.exec import host_eval as j_host_eval  # noqa: E402
from trino_tpu.exec import page_tree as j_tree  # noqa: E402
from trino_tpu.exec.executor import QueryError as JaxQueryError  # noqa: E402
from trino_tpu.exec.query import plan_sql as jax_plan_sql  # noqa: E402
from trino_tpu.ops import join as j_join  # noqa: E402
from trino_tpu.sql.planner import plan as JP  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402
from test_torch_compiled_tpch import build_profile, norm_hints, positions  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch import types as TT  # noqa: E402
from trino_tpu_torch.data.page import page_from_numpy  # noqa: E402
from trino_tpu_torch.exec import compiled as t_compiled  # noqa: E402
from trino_tpu_torch.exec import host_eval as t_host_eval  # noqa: E402
from trino_tpu_torch.exec import page_tree as t_tree  # noqa: E402
from trino_tpu_torch.exec.compiled import CompiledQuery  # noqa: E402
from trino_tpu_torch.exec.executor import Executor, QueryError  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql  # noqa: E402
from trino_tpu_torch.obs import metrics as M  # noqa: E402
from trino_tpu_torch.obs import trace as tracing  # noqa: E402
from trino_tpu_torch.ops import join as t_join  # noqa: E402
from trino_tpu_torch.sql.planner import plan as TP  # noqa: E402
from trino_tpu_torch.sql.planner import stats as t_stats  # noqa: E402


def eq(t, j, what=""):
    """Exact equality of a port tensor and a JAX array, dtypes included."""
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def sessions(props, **port_kw):
    return JaxSession(properties=dict(props)), TorchSession(properties=dict(props),
                                                            device="cpu", **port_kw)


TPCH = {"catalog": "tpch", "schema": "tiny", "fused_join_pallas": True}
TPCDS = {"catalog": "tpcds", "schema": "tiny", "fused_join_pallas": True}


# ------------------------------------------------------------ page_tree
def _jax_page(kind, rng):
    n = 40
    if kind == "flat":
        cols = [JaxColumn.from_python(JT.BIGINT, [int(v) for v in rng.integers(-50, 50, n)]),
                JaxColumn.from_python(JT.VARCHAR, [None if i % 7 == 0 else f"s{i % 5}"
                                                    for i in range(n)]),
                JaxColumn.from_python(JT.DOUBLE, [float(v) for v in rng.random(n)])]
        return JaxPage(cols)
    if kind == "nested":
        arr = [None if i % 9 == 0 else [int(v) for v in rng.integers(0, 9, i % 4)]
               for i in range(n)]
        mp = [{f"k{j}": j for j in range(i % 3)} for i in range(n)]
        row = [(i, f"r{i % 4}") for i in range(n)]
        return JaxPage([
            JaxColumn.from_python(JT.parse_type("array(bigint)"), arr),
            JaxColumn.from_python(JT.parse_type("map(varchar, bigint)"), mp),
            JaxColumn.from_python(JT.parse_type("row(a bigint, b varchar)"), row)])
    if kind == "two_limb":
        big = [Decimal(int(v)) * Decimal(10) ** 20 + Decimal(i) for i, v in
               enumerate(rng.integers(-9, 9, n))]
        return JaxPage([JaxColumn.from_python(JT.parse_type("decimal(38,0)"), big),
                        JaxColumn.from_python(JT.INTEGER, list(range(n)))])
    # "selected": a selection mask over a flat page
    page = _jax_page("flat", rng)
    return JaxPage(page.columns, jnp.asarray(rng.random(n) < 0.5), live_prefix=False)


def _same_spec(ts, js):
    assert str(ts.type) == str(js.type)
    assert (ts.dictionary is None) == (js.dictionary is None)
    if ts.dictionary is not None:
        assert list(ts.dictionary.values) == list(js.dictionary.values)
    assert ts.has_nulls == js.has_nulls and ts.has_hi == js.has_hi
    assert ts.ascending == js.ascending
    assert (tuple(ts.vrange) if ts.vrange is not None else None) == \
        (tuple(js.vrange) if js.vrange is not None else None)
    assert (ts.children is None) == (js.children is None)
    for a, b in zip(ts.children or (), js.children or ()):
        _same_spec(a, b)
    assert ts.count() == js.count()


@pytest.mark.parametrize("kind", ["flat", "nested", "two_limb", "selected"])
def test_flatten_round_trip_equals_reference(kind):
    jp = _jax_page(kind, np.random.default_rng(5))
    tp = page_from_numpy(jp.columns, jp.sel, live_prefix=jp.live_prefix, device="cpu")
    if kind == "two_limb":
        assert tp.columns[0].hi is not None
    j_arrays, j_spec = j_tree.flatten_page(jp)
    t_arrays, t_spec = t_tree.flatten_page(tp)
    assert len(t_arrays) == len(j_arrays) == t_spec.array_count() == j_spec.array_count()
    assert t_spec.has_sel == j_spec.has_sel and t_spec.live_prefix == j_spec.live_prefix
    for ts, js in zip(t_spec.col_specs, j_spec.col_specs):
        _same_spec(ts, js)
    for i, (t, j) in enumerate(zip(t_arrays, j_arrays)):
        eq(t, j, f"array {i}")
    back = t_tree.unflatten_page(t_spec, t_arrays)
    assert back.to_pylist() == tp.to_pylist() == \
        j_tree.unflatten_page(j_spec, j_arrays).to_pylist()


# ------------------------------------------------- dense membership, masks
def _keys(rng, n, lo, hi, null_frac=0.1, dead_frac=0.2):
    vals = rng.integers(lo, hi, n).astype(np.int64)
    valid = rng.random(n) >= null_frac
    sel = rng.random(n) >= dead_frac
    return vals, valid, sel


@pytest.mark.parametrize("case", ["random", "empty_build", "all_dead", "outside_span"])
def test_dense_membership_table_probe_equals_reference(case):
    rng = np.random.default_rng(11)
    lo, span = 100, 500
    nb = 0 if case == "empty_build" else 300
    bv, bvalid, bsel = _keys(rng, nb, lo - 50 if case == "outside_span" else lo, lo + span + 50)
    if case == "all_dead":
        bsel[:] = False
    pv, pvalid, _ = _keys(rng, 1000, lo - 20, lo + span + 20)
    t_lut = t_join.dense_membership_table((torch.from_numpy(bv), torch.from_numpy(bvalid)),
                                          torch.from_numpy(bsel), lo, span)
    j_lut = j_join.dense_membership_table((jnp.asarray(bv), jnp.asarray(bvalid)),
                                          jnp.asarray(bsel), lo, span)
    live = bsel & bvalid
    exact = np.zeros(span, bool)
    inside = live & (bv >= lo) & (bv < lo + span)
    exact[bv[inside] - lo] = True
    eq(t_lut, exact, "table against numpy")
    if case == "outside_span":
        # the reference's scatter wraps a negative index (a key below lo)
        # round to span + (key - lo) even in drop mode: a latent fault of
        # the JAX package that adds false positives to an in-body dynamic
        # filter, which the join then drops; the port drops such keys
        wrapped = exact.copy()
        below = live & (bv < lo) & (bv >= lo - span)
        wrapped[span + bv[below] - lo] = True
        assert below.any() and (wrapped != exact).any()
        eq(torch.from_numpy(wrapped), j_lut, "the reference's wrapped table")
        return
    eq(t_lut, j_lut, "table")
    t_hit = t_join.dense_membership_probe(t_lut, (torch.from_numpy(pv), torch.from_numpy(pvalid)),
                                          lo)
    j_hit = j_join.dense_membership_probe(j_lut, (jnp.asarray(pv), jnp.asarray(pvalid)), lo)
    eq(t_hit, j_hit, "probe")
    eq(t_join.dense_membership((torch.from_numpy(bv), None), torch.from_numpy(bsel),
                               (torch.from_numpy(pv), None), lo, span),
       j_join.dense_membership((jnp.asarray(bv), None), jnp.asarray(bsel),
                               (jnp.asarray(pv), None), lo, span), "membership")


@pytest.mark.parametrize("spec", [("lut", 100, 500), ("range",)])
@pytest.mark.parametrize("case", ["random", "all_dead", "empty_build", "int32_probe"])
def test_traced_domain_mask_equals_reference(spec, case):
    rng = np.random.default_rng(12)
    nb = 0 if case == "empty_build" else 200
    bv, _, blive = _keys(rng, nb, 150, 400)
    if case == "all_dead":
        blive[:] = False
    pv = rng.integers(50, 700, 2000).astype(np.int32 if case == "int32_probe" else np.int64)
    got = t_compiled._traced_domain_mask(
        torch.from_numpy(pv), (torch.from_numpy(bv), torch.from_numpy(blive)), spec)
    if case == "empty_build" and spec[0] == "range":
        # the reference's min over no key raises; the port admits nothing
        assert not got.any()
        return
    want = j_compiled._traced_domain_mask(jnp.asarray(pv), (jnp.asarray(bv),
                                                            jnp.asarray(blive)), spec)
    eq(got, want, "mask")
    if case in ("all_dead", "empty_build"):
        assert not got.any()


# -------------------------------------------------------------- phase 1
def _domain_key(dom):
    return (None if dom.values is None else frozenset(int(v) for v in dom.values),
            dom.low, dom.high, dom.low_inclusive, dom.high_inclusive, dom.null_allowed)


@pytest.mark.parametrize("q", [3, 5, 18, 21])
def test_resolve_dynamic_filters_equal_reference(q):
    js, ts = sessions(TPCH)
    jroot, troot = jax_plan_sql(js, QUERIES[q]), plan_sql(ts, QUERIES[q])
    jd = j_host_eval.resolve_dynamic_filters(js, jroot)
    td = t_host_eval.resolve_dynamic_filters(ts, troot)
    jpos, tpos = positions(jroot, JP.walk_plan), positions(troot, TP.walk_plan)
    assert jd, "the reference resolved no domain"
    assert {(tpos[j], k): _domain_key(d) for (j, k), d in td.items()} == \
        {(jpos[j], k): _domain_key(d) for (j, k), d in jd.items()}
    # an exact in-set domain marks its join for the match-fraction estimate
    assert [n.df_exact for n in TP.walk_plan(troot) if isinstance(n, TP.JoinNode)] == \
        [n.df_exact for n in JP.walk_plan(jroot) if isinstance(n, JP.JoinNode)]


def test_host_evaluator_refuses_inexact_filter():
    """A filter over a float sum makes the build Unsupported in both (the
    dynamic filter is skipped, never wrong)."""
    sql = ("select count(*) from orders where o_custkey in (select o_custkey from orders "
           "group by o_custkey having sum(o_totalprice) > 1e6)")
    js, ts = sessions(TPCH)
    jd = j_host_eval.resolve_dynamic_filters(js, jax_plan_sql(js, sql))
    td = t_host_eval.resolve_dynamic_filters(ts, plan_sql(ts, sql))
    assert len(td) == len(jd)
    assert ts.execute(sql).rows == js.execute(sql).rows


@pytest.mark.parametrize("reseed", [False, True])
@pytest.mark.parametrize("q", list(range(1, 23)))
def test_build_decisions_equal_reference(q, reseed):
    """Staged rows per scan, capacity hints and in-body dynamic filters of
    the build (no run), with and without adaptive capacity reseeding."""
    props = {**TPCH, "adaptive_capacity_reseed": reseed}
    js, ts = sessions(props)
    jcq = j_compiled.CompiledQuery.build(js, jax_plan_sql(js, QUERIES[q]))
    tcq = CompiledQuery.build(ts, plan_sql(ts, QUERIES[q]))
    assert build_profile(tcq, TP.walk_plan) == build_profile(jcq, JP.walk_plan)
    assert tcq.fresh_staged_rows == jcq.fresh_staged_rows
    if reseed and q == 21:
        assert any(k.startswith("jtile:") for k in tcq.capacity_hints)


def test_staged_pages_from_arrays_equals_reference():
    """Sharded staging arrays back to pages: the reference's arrays carry a
    leading device axis, the port's are a list a rank (its shards may sit
    on different devices)."""
    from trino_tpu.adaptive.reseed import staged_pages_from_arrays as j_from_arrays
    from trino_tpu_torch.adaptive.reseed import staged_pages_from_arrays

    jp = _jax_page("selected", np.random.default_rng(6))
    j_arrays, j_spec = j_tree.flatten_page(jp)
    tp = page_from_numpy(jp.columns, jp.sel, device="cpu")
    t_arrays, t_spec = t_tree.flatten_page(tp)
    sharded_j = [np.asarray(a).reshape((2, -1) + np.asarray(a).shape[1:]) for a in j_arrays]
    sharded_t = [[a.reshape((2, -1) + tuple(a.shape[1:]))[r] for a in t_arrays]
                 for r in range(2)]
    got = staged_pages_from_arrays({7: sharded_t}, {7: t_spec})[7]
    want = j_from_arrays({7: sharded_j}, {7: j_spec})[7]
    assert got.to_pylist() == want.to_pylist() == tp.to_pylist()


def test_reseed_refuses_several_devices(monkeypatch):
    """Reseeding for several devices, once refused, prices the exchange
    half as the reference does: over Q3's staged shards at 4 devices with
    every exchange hashed, the same expansion and send-block hints (node
    ids as plan positions)."""
    from trino_tpu.adaptive import reseed as j_reseed
    from trino_tpu.parallel import spmd as j_spmd
    from trino_tpu.sql.planner import stats as j_stats
    from trino_tpu_torch.adaptive import reseed as t_reseed
    from trino_tpu_torch.parallel import spmd as t_spmd
    from trino_tpu_torch.parallel.mesh import Mesh

    for mod in (j_stats, t_stats):
        monkeypatch.setattr(mod, "GATHER_AGG_MAX_ROWS_PER_DEVICE", 8)
        monkeypatch.setattr(mod, "BROADCAST_BUILD_MAX", 8)
    js, ts = sessions(TPCH)
    jroot, troot = jax_plan_sql(js, QUERIES[3]), plan_sql(ts, QUERIES[3])
    j_arrays, j_specs = j_spmd.stage_sharded_scans(js, jroot, 4)
    mesh = Mesh.threads(4, "cpu")
    t_arrays, t_specs = t_spmd.stage_sharded_scans(ts, troot, mesh)
    mesh.close()
    want = j_reseed.reseed_capacity_hints(
        js, jroot, j_reseed.staged_pages_from_arrays(j_arrays, j_specs), 4)
    got = t_reseed.reseed_capacity_hints(
        ts, troot, t_reseed.staged_pages_from_arrays(t_arrays, t_specs), 4)
    assert any(k.startswith("xchgl:") for k in got)
    assert norm_hints(got, positions(troot, TP.walk_plan)) == \
        norm_hints(want, positions(jroot, JP.walk_plan))


# -------------------------------------------------- recompile and errors
def _hot_key_tables(session, TYPES):
    mem = session.catalogs["memory"]
    # 64 x 64 rows on one hot key: output 4096 > initial MIN_CAPACITY bucket
    mem.create_table("t", "a", [("k", TYPES.BIGINT), ("v", TYPES.BIGINT)],
                     [(1, i) for i in range(64)])
    mem.create_table("t", "b", [("k", TYPES.BIGINT), ("w", TYPES.BIGINT)],
                     [(1, i) for i in range(64)])


def test_bucketed_recompile_on_capacity_overflow():
    """The reference's test_bucketed_recompile_on_capacity_overflow in both
    packages: the M:N join overflows its estimated bucket and completes
    through the doubling loop, with the same grown hints."""
    sql = "select count(*) from memory.t.a a, memory.t.b b where a.k = b.k"
    js, ts = sessions({})
    _hot_key_tables(js, JT)
    _hot_key_tables(ts, TT)
    out = []
    for s, cls, plan in ((js, j_compiled.CompiledQuery, jax_plan_sql),
                         (ts, CompiledQuery, plan_sql)):
        cq = cls.build(s, plan(s, sql))
        initial = dict(cq.capacity_hints)
        assert all(cap <= 2048 for cap in initial.values()), initial
        assert cq.run().to_pylist() == [(4096,)]
        assert cq.capacity_hints != initial and cq.recompiles >= 1
        out.append((sorted(initial.values()), sorted(cq.capacity_hints.values()),
                    cq.recompiles))
    assert out[0] == out[1]


def test_forced_overflow_recaptures_with_same_rows():
    """A join hint cut to a quarter (TPC-H Q13's left join) overflows,
    grows and gives the rows of the uncut build, in both packages."""
    js, ts = sessions(TPCH)
    out = []
    for s, cls, plan in ((js, j_compiled.CompiledQuery, jax_plan_sql),
                         (ts, CompiledQuery, plan_sql)):
        cq = cls.build(s, plan(s, QUERIES[13]))
        cq.capacity_hints = {k: v // 4 if k.startswith("join:") else v
                             for k, v in cq.capacity_hints.items()}
        if cls is j_compiled.CompiledQuery:
            cq._jit()
        rows = cq.run().to_pylist()
        out.append((rows, cq.recompiles))
    assert out[1] == out[0]
    assert out[1][1] >= 1
    assert out[1][0] == ts.execute(QUERIES[13]).rows


def test_compiled_division_by_zero_raises_reference_message():
    sql = "select n_nationkey/(n_nationkey - n_nationkey) from nation"
    js, ts = sessions(TPCH)
    with pytest.raises(JaxQueryError) as jerr:
        j_compiled.CompiledQuery.build(js, jax_plan_sql(js, sql)).run()
    with pytest.raises(QueryError, match="Division by zero") as terr:
        CompiledQuery.build(ts, plan_sql(ts, sql)).run()
    assert str(terr.value) == str(jerr.value)


def test_compiled_scalar_subquery_errors_match_reference():
    sql = "select n_name from nation where n_regionkey = (select r_regionkey from region)"
    js, ts = sessions(TPCH)
    with pytest.raises(JaxQueryError) as jerr:
        j_compiled.CompiledQuery.build(js, jax_plan_sql(js, sql)).run()
    with pytest.raises(QueryError) as terr:
        CompiledQuery.build(ts, plan_sql(ts, sql)).run()
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------- warm builds
Q3_MEM = ("select l_orderkey, sum(l_price) rev, o_pri "
          "from customer, orders, lineitem "
          "where c_seg = 'BUILDING' and c_custkey = o_custkey "
          "and l_orderkey = o_orderkey group by l_orderkey, o_pri "
          "order by rev desc limit 10")


def _q3_tables(session, TYPES):
    rng = np.random.default_rng(3)
    n_cust, n_ord = 100, 600
    mem = session.catalogs["memory"]
    mem.create_table("db", "customer", [("c_custkey", TYPES.BIGINT), ("c_seg", TYPES.VARCHAR)],
                     [(i, "BUILDING" if i % 5 == 0 else "AUTO") for i in range(n_cust)])
    mem.create_table("db", "orders", [("o_orderkey", TYPES.BIGINT),
                                      ("o_custkey", TYPES.BIGINT), ("o_pri", TYPES.BIGINT)],
                     [(i, int(rng.integers(0, n_cust)), i % 3) for i in range(n_ord)])
    mem.create_table("db", "lineitem", [("l_orderkey", TYPES.BIGINT), ("l_price", TYPES.BIGINT)],
                     [(int(rng.integers(0, n_ord)), int(rng.integers(1, 100)))
                      for _ in range(1500)])


def test_warm_compiled_build_stages_nothing_then_dml_restages():
    """The reference's test_warm_compiled_build_zero_transfer_then_dml_restages
    on the port: the warm build of the same query stages 0 rows (stats and
    the device/staging span agree) and gives the cold rows; an INSERT
    restages the mutated table only."""
    from trino_tpu_torch.devcache import DEVICE_CACHE

    DEVICE_CACHE.invalidate_all()
    s = TorchSession(properties={"catalog": "memory", "schema": "db",
                                 "device_cache_enabled": True}, device="cpu")
    js = JaxSession({"catalog": "memory", "schema": "db"})
    _q3_tables(s, TT)
    _q3_tables(js, JT)
    tracer = tracing.Tracer()
    with tracing.activate(tracer):
        cold = CompiledQuery.build(s, plan_sql(s, Q3_MEM))
        assert cold.cache_hits == 0 and cold.fresh_staged_rows > 0
        r_cold = cold.run().to_pylist()
        assert r_cold == j_compiled.CompiledQuery.build(js, jax_plan_sql(js, Q3_MEM)).run() \
            .to_pylist()
        rows0 = M.STAGED_ROWS.value()
        warm = CompiledQuery.build(s, plan_sql(s, Q3_MEM))
    assert warm.fresh_staged_rows == 0 and warm.cache_hits == 3
    assert M.STAGED_ROWS.value() == rows0
    staging = [sp for sp in tracer.spans() if sp.name == "device/staging"]
    assert len(staging) == 2 and staging[-1].attributes["staged_rows"] == 0
    assert staging[-1].attributes["cache_hits"] == 3
    assert warm.run().to_pylist() == r_cold
    s.execute("insert into lineitem values (0, 7)")
    third = CompiledQuery.build(s, plan_sql(s, Q3_MEM))
    assert third.fresh_staged_rows > 0 and third.cache_hits == 2


# ----------------------------------------------- grow_overflowed_hints
def test_grow_overflowed_hints_reads_tensor_flags():
    hints = {"join:1": 1024, "cmp:2": 2048, "dfc:3": 4096}
    codes = ["CAPACITY_EXCEEDED:join:1", "DIVISION_BY_ZERO", "CAPACITY_EXCEEDED:cmp:2"]
    none = [torch.tensor(False), torch.tensor([True, True]), torch.zeros(3, dtype=torch.bool)]
    assert t_stats.grow_overflowed_hints(hints, codes, none) is None
    one = [torch.tensor(False), torch.tensor(True), torch.tensor([False, True, False])]
    grown = t_stats.grow_overflowed_hints(hints, codes, one)
    assert grown == {"join:1": 1024, "cmp:2": 4096, "dfc:3": 4096}
    assert hints["cmp:2"] == 2048  # a new dict
    # a key without a hint doubles the minimum capacity; host booleans too
    assert t_stats.grow_overflowed_hints({}, ["CAPACITY_EXCEEDED:join:9"], [True]) == \
        {"join:9": 2 * t_stats.MIN_CAPACITY}
    assert t_stats.grow_overflowed_hints(hints, ["DIVISION_BY_ZERO"], [torch.tensor(True)]) \
        is None


# ------------------------------------------------------- tier seams
def test_compiled_tier_refusals():
    ts = TorchSession(properties=TPCH, device="cpu")
    js = JaxSession(properties=TPCH)
    mr = """select * from (values (1, 1), (2, 3), (3, 2)) as t(i, v)
            match_recognize (order by i measures last(up.v) as top
                             pattern (up+) define up as v > 0)"""
    with pytest.raises(NotImplementedError, match="host tier"):
        CompiledQuery.build(ts, plan_sql(ts, mr)).run()
    with pytest.raises(NotImplementedError, match="host tier"):
        j_compiled.CompiledQuery.build(js, jax_plan_sql(js, mr)).run()
    with pytest.raises(NotImplementedError, match="random"):
        CompiledQuery.build(ts, plan_sql(ts, "select random() from nation")).run()
    nested_sort = ("select n_regionkey, array_agg(n_nationkey) from nation "
                   "group by n_regionkey order by n_regionkey")
    with pytest.raises(NotImplementedError, match="array/map"):
        CompiledQuery.build(ts, plan_sql(ts, nested_sort)).run()
    assert ts.execute(nested_sort).rows == js.execute(nested_sort).rows  # eager keeps it


def test_preloaded_executor_needs_capacity_hints():
    ts = TorchSession(properties=TPCH, device="cpu")
    ex = t_compiled.PreloadedExecutor(ts, {})
    with pytest.raises(RuntimeError, match="no capacity hint"):
        ex.hint_capacity("join:1", torch.ones(3, dtype=torch.int32))
    assert ex.eager_tier is False and ex.collect_stats is False
    eager = Executor(ts)
    assert eager.hint_capacity("join:1", torch.ones(3, dtype=torch.int32)) == 16


def test_apply_dynamic_domains_allow_matches_reference():
    from trino_tpu.connector.predicate import Domain as JDomain
    from trino_tpu.connector.spi import ColumnData as JColumnData
    from trino_tpu.exec.executor import apply_dynamic_domains as j_apply
    from trino_tpu_torch.connector.predicate import Domain
    from trino_tpu_torch.connector.spi import ColumnData
    from trino_tpu_torch.exec.executor import apply_dynamic_domains

    class Scan:
        dynamic_filters = [(1, 0, "a"), (2, 0, "b")]

    a = np.arange(20, dtype=np.int64)
    b = np.arange(20, dtype=np.int64) % 5

    def allow(node, column, dom):
        return column == "a"

    got = apply_dynamic_domains(Scan, {(1, 0): Domain.from_values([1, 2, 3]),
                                       (2, 0): Domain.from_values([0])},
                                [{"a": ColumnData(TT.BIGINT, a), "b": ColumnData(TT.BIGINT, b)}],
                                allow=allow)
    want = j_apply(Scan, {(1, 0): JDomain.from_values([1, 2, 3]),
                          (2, 0): JDomain.from_values([0])},
                   [{"a": JColumnData(JT.BIGINT, a), "b": JColumnData(JT.BIGINT, b)}],
                   allow=allow)
    for col in ("a", "b"):
        np.testing.assert_array_equal(np.asarray(got[0][col].values),
                                      np.asarray(want[0][col].values))
    np.testing.assert_array_equal(np.asarray(got[0]["a"].values), [1, 2, 3])


# ------------------------------------------------------ metrics, spans
def test_compiled_metrics_spans_and_close():
    ts = TorchSession(properties=TPCH, device="cpu")
    before = {m: m.value() for m in (M.COMPILE_CACHE_MISSES, M.COMPILE_CACHE_HITS)}
    tracer = tracing.Tracer()
    with tracing.activate(tracer):
        cq = CompiledQuery.build(ts, plan_sql(ts, QUERIES[3]))
        rows = cq.run().to_pylist()
        assert cq.run().to_pylist() == rows
    assert M.COMPILE_CACHE_MISSES.value() - before[M.COMPILE_CACHE_MISSES] == 1
    assert M.COMPILE_CACHE_HITS.value() - before[M.COMPILE_CACHE_HITS] == 1
    names = [sp.name for sp in tracer.spans()]
    for name in ("staging/dynamic-filters", "device/staging", "device/compile",
                 "device/execute"):
        assert name in names, name
    cq.close()  # a closed query captures again on its next run
    assert cq.run().to_pylist() == rows
    assert M.COMPILE_CACHE_MISSES.value() - before[M.COMPILE_CACHE_MISSES] == 2
