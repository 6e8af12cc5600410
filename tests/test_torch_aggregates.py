"""The statistical and sketch aggregates: trino_tpu_torch/ops/aggregate.py
and ops/hll.py against trino_tpu/ops/aggregate.py and ops/hll.py on the
same numpy inputs (made from a seed), and the SQL of
tests/test_aggregate_breadth.py, test_functions.py and
test_sketch_aggregates.py through both Sessions on the CPU.

Left out of the SQL: ``test_histogram`` and ``test_map_agg`` (map
results), which run in tests/test_torch_nested_sql.py, and for the
distributed runner ``test_two_arg_aggs_distributed_gather``,
``test_variance_distributed``,
the distributed half of ``test_variance_large_offset`` and
``test_distributed_approx_percentile_within_1pct``.
"""
import os
import sys
from decimal import Decimal

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp  # noqa: E402

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from trino_tpu.ops import aggregate as jagg  # noqa: E402
from trino_tpu.ops import groupby as jgb  # noqa: E402
from trino_tpu.ops import hll as jhll  # noqa: E402
from trino_tpu.ops import segments as jseg  # noqa: E402
from trino_tpu.parallel import exchange as jexchange  # noqa: E402
from test_torch_sql_both import BothSessions  # noqa: E402
from test_torch_window import assert_lowered, assert_same  # noqa: E402

from trino_tpu_torch.ops import aggregate as tagg  # noqa: E402
from trino_tpu_torch.ops import groupby as tgb  # noqa: E402
from trino_tpu_torch.ops import hll as thll  # noqa: E402
from trino_tpu_torch.ops import segments as tseg  # noqa: E402

N = 301


def _group_inputs(seed, direct):
    """(jax layout, port layout, payload arrays as numpy in layout space,
    sel in layout space) for N rows of random groups."""
    rng = np.random.default_rng(seed)
    sel = rng.random(N) > 0.15
    if direct:
        gids = rng.integers(0, 5, N).astype(np.int32)
        jl = jseg.direct_layout(jnp.asarray(gids), 5, jnp.asarray(sel))
        tl = tseg.direct_layout(torch.from_numpy(gids), 5, torch.from_numpy(sel))
        return jl, tl, (lambda a: a), sel
    keys = rng.integers(0, 23, N).astype(np.int64)
    iota = np.arange(N, dtype=np.int32)
    jo, jg, jn, _ = jgb.group_plan([(jnp.asarray(keys), None)], jnp.asarray(sel))
    to, tg, tn, _ = tgb.group_plan([(torch.from_numpy(keys), None)], torch.from_numpy(sel))
    assert_same(to, jo, "group order")
    jl = jseg.sorted_layout(jo, jg, jn)
    tl = tseg.sorted_layout(to, tg, tn)
    order = np.asarray(jo)
    n_live = int(sel.sum())
    return jl, tl, (lambda a: a[order]), iota < n_live


def _arg(x, valid, to_layout):
    xl = to_layout(x)
    vl = None if valid is None else to_layout(valid)
    return ((jnp.asarray(xl), None if vl is None else jnp.asarray(vl)),
            (torch.from_numpy(np.ascontiguousarray(xl)),
             None if vl is None else torch.from_numpy(np.ascontiguousarray(vl))))


def _sel(s):
    return jnp.asarray(s), torch.from_numpy(np.ascontiguousarray(s))


@pytest.mark.parametrize("direct", [False, True])
def test_first_and_minmax_by_equal_reference(direct):
    jl, tl, to_layout, sel_l = _group_inputs(21, direct)
    rng = np.random.default_rng(22)
    x = rng.integers(-50, 50, N).astype(np.int64)
    xv = rng.random(N) > 0.2
    y = rng.integers(0, 7, N).astype(np.int32)  # ties in the key
    yv = rng.random(N) > 0.1
    (jx, tx), (jy, ty) = _arg(x, xv, to_layout), _arg(y, yv, to_layout)
    js, ts = _sel(sel_l)
    assert_lowered(tagg.agg_first(tl, tx, ts), jagg.agg_first(jl, jx, js), "first")
    for is_min in (True, False):
        assert_lowered(tagg.agg_minmax_by(tl, tx, ty, ts, is_min),
                       jagg.agg_minmax_by(jl, jx, jy, js, is_min), f"minmax_by {is_min}")


@pytest.mark.parametrize("fn", ["corr", "covar_samp", "covar_pop", "regr_slope",
                                "regr_intercept"])
@pytest.mark.parametrize("direct", [False, True])
def test_bivariate_equal_reference(fn, direct):
    jl, tl, to_layout, sel_l = _group_inputs(31, direct)
    rng = np.random.default_rng(32)
    x = rng.integers(-5000, 5000, N).astype(np.int64)  # a decimal(.., 2)
    y = 3.0 * x / 100 + rng.normal(0.0, 4.0, N)
    yv = rng.random(N) > 0.1
    (jy, ty), (jx, tx) = _arg(y, yv, to_layout), _arg(x, None, to_layout)
    js, ts = _sel(sel_l)
    assert_lowered(tagg.agg_bivariate(tl, ty, tx, ts, fn, 0, 2),
                   jagg.agg_bivariate(jl, jy, jx, js, fn, 0, 2), fn)


@pytest.mark.parametrize("kind", ["variance", "var_samp", "var_pop", "stddev",
                                  "stddev_samp", "stddev_pop"])
@pytest.mark.parametrize("direct", [False, True])
def test_variance_family_equal_reference(kind, direct):
    jl, tl, to_layout, sel_l = _group_inputs(41, direct)
    rng = np.random.default_rng(42)
    x = (1e6 + rng.normal(0.0, 3.0, N) * 100).astype(np.int64)  # decimal, scale 2
    xv = rng.random(N) > 0.1
    jx, tx = _arg(x, xv, to_layout)
    js, ts = _sel(sel_l)
    assert_lowered(tagg.agg_var(tl, tx, ts, kind, 2), jagg.agg_var(jl, jx, js, kind, 2), kind)
    for a, b in zip(tagg.var_states(tl, tx, ts, 2), jagg.var_states(jl, jx, js, 2)):
        assert_same(a, b, "var_states " + kind)


def test_combine_var_states_equal_reference():
    jl, tl, to_layout, sel_l = _group_inputs(51, False)
    rng = np.random.default_rng(52)
    cnt = rng.integers(0, 40, N).astype(np.int64)
    mean = rng.normal(10.0, 2.0, N)
    m2 = rng.random(N) * 50.0
    m = rng.random(N) > 0.2
    j = [jnp.asarray(to_layout(a)) for a in (cnt, mean, m2, m)]
    t = [torch.from_numpy(np.ascontiguousarray(to_layout(a))) for a in (cnt, mean, m2, m)]
    for a, b in zip(tagg.combine_var_states(tl, *t), jagg.combine_var_states(jl, *j)):
        assert_same(a, b, "combine_var_states")
    assert_lowered(tagg.finish_var(*tagg.combine_var_states(tl, *t), "stddev_pop"),
                   jagg.finish_var(*jagg.combine_var_states(jl, *j), "stddev_pop"), "finish")


def test_grouped_pairs_equal_reference():
    jl, tl, _, _ = _group_inputs(61, False)
    rng = np.random.default_rng(62)
    k = rng.integers(0, 6, N).astype(np.int64)
    kv = rng.random(N) > 0.1
    sel = rng.random(N) > 0.1
    got = tagg.grouped_pairs(tl, (torch.from_numpy(k), torch.from_numpy(kv)),
                             torch.from_numpy(sel))
    want = jagg.grouped_pairs(jl, (jnp.asarray(k), jnp.asarray(kv)), jnp.asarray(sel))
    live = np.asarray(want[3])
    assert_same(got[0], want[0], "entry counts")
    assert_same(got[3], want[3], "entry live")
    # rep and run counts past the live entries are padding
    assert_same(got[1].numpy()[live], np.asarray(want[1])[live], "rep")
    assert_same(got[2].numpy()[live], np.asarray(want[2])[live], "run counts")


# ---------------------------------------------------------------- ops/hll.py
ADVERSARIAL = [0, 1, 2, 3, 2**11 - 1, 2**11, 2**31 - 1, 2**32, 2**53 - 1, 2**53,
               2**62, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1,
               0x8000_0000_0000_0800, 0xFFFF_FFFF_0000_0000, 0x0000_0001_FFFF_FFFF]


def _words():
    rng = np.random.default_rng(71)
    rand = rng.integers(0, 2**64 - 1, 500, dtype=np.uint64, endpoint=True)
    return np.concatenate([np.array(ADVERSARIAL, dtype=np.uint64), rand])


def test_mix64_bit_exact_on_adversarial_words():
    u = _words()
    want = np.asarray(jhll._mix64(jnp.asarray(u)))
    got = thll._mix64(torch.from_numpy(u.view(np.int64))).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    # the exchange's splitmix64 finalizer (checksum's hash) is the same function
    np.testing.assert_array_equal(np.asarray(jexchange._mix64(jnp.asarray(u))), want)


@pytest.mark.parametrize("width", [53, 64])
def test_rho_bit_exact_on_adversarial_words(width):
    u = _words()
    if width == 53:
        u = u >> np.uint64(11)
    want = np.asarray(jhll._rho(jnp.asarray(u), width))
    got = thll._rho(torch.from_numpy(u.view(np.int64)), width).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
@pytest.mark.parametrize("direct", [False, True])
def test_approx_distinct_equal_reference(dtype, direct):
    jl, tl, _, _ = _group_inputs(81, direct)
    rng = np.random.default_rng(82)
    x = rng.integers(0, 4000, 4 * N)[:N].astype(dtype)
    if dtype is np.float64:
        x = x / 3.0
    xv = rng.random(N) > 0.1
    sel = rng.random(N) > 0.1
    got = thll.approx_distinct(tl, (torch.from_numpy(x), torch.from_numpy(xv)),
                               torch.from_numpy(sel))
    want = jhll.approx_distinct(jl, (jnp.asarray(x), jnp.asarray(xv)), jnp.asarray(sel))
    assert_lowered(got, want, "approx_distinct")


def test_approx_distinct_large_cardinality_equal_reference():
    """The raw estimator (past linear counting at 2.5 m = 5120): 20000
    distinct keys in one group."""
    rng = np.random.default_rng(83)
    x = rng.permutation(20000).astype(np.int64)
    g = np.zeros(20000, np.int32)
    jl = jseg.direct_layout(jnp.asarray(g), 1, None)
    tl = tseg.direct_layout(torch.from_numpy(g), 1, None)
    got = thll.approx_distinct(tl, (torch.from_numpy(x), None), None)
    want = jhll.approx_distinct(jl, (jnp.asarray(x), None), None)
    assert_lowered(got, want, "approx_distinct 20000")
    assert abs(int(got[0][0]) - 20000) < 0.05 * 20000


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("direct", [False, True])
def test_approx_percentile_equal_reference(p, dtype, direct):
    jl, tl, to_layout, sel_l = _group_inputs(91, direct)
    rng = np.random.default_rng(92)
    x = rng.integers(-900, 900, N).astype(dtype)
    xv = rng.random(N) > 0.2
    m = to_layout(xv) & sel_l
    xl = np.ascontiguousarray(to_layout(x))
    got = thll.approx_percentile(tl, torch.from_numpy(xl), torch.from_numpy(m), p)
    want = jhll.approx_percentile(jl, jnp.asarray(xl), jnp.asarray(m), p)
    live = np.asarray(want[1])
    assert_same(got[1], want[1], "percentile valid")
    assert_same(got[0].numpy()[live], np.asarray(want[0])[live], f"percentile {p}")


# ---------------------------------------------------------------- the SQL
def _breadth_rows():
    rng = np.random.default_rng(7)
    rows = []
    for i in range(300):
        g = int(rng.integers(0, 3))
        x = float(rng.normal(10.0, 2.0))
        y = 2.5 * x + float(rng.normal(0.0, 0.5))
        b = bool(rng.integers(0, 2))
        name = f"n{int(rng.integers(0, 5))}"
        rows.append((i, g, b, x, y, name))
    return rows


def _sample_rows():
    rng = np.random.default_rng(13)
    rows = []
    for i in range(500):
        g = int(rng.integers(0, 4))
        x = float(rng.normal(100.0, 15.0))
        rows.append((i, g, x, int(rng.integers(0, 40))))
    return rows


def _bigoff_rows():
    rng = np.random.default_rng(7)
    xs = [float(1e9 + v) for v in rng.normal(0.0, 1.0, 400)]
    return [(i, i % 3, x) for i, x in enumerate(xs)]


@pytest.fixture(scope="module")
def both():
    b = BothSessions({"catalog": "tpch", "schema": "tiny"})
    b.create_table("t", "w", [("id", "bigint"), ("g", "bigint"), ("b", "boolean"),
                              ("x", "double"), ("y", "double"), ("name", "varchar")],
                   _breadth_rows())
    b.create_table("t", "samples", [("id", "bigint"), ("g", "bigint"), ("x", "double"),
                                    ("k", "bigint")], _sample_rows())
    b.create_table("t", "bigoff", [("id", "bigint"), ("g", "bigint"), ("x", "double")],
                   _bigoff_rows())
    b.create_table("t", "d", [("v", "decimal(10,2)")],
                   [(Decimal("12.34"),), (Decimal("-12.56"),), (Decimal("2.50"),)])
    b.create_table("t", "big", [("a", "decimal(17,2)"), ("b", "decimal(12,6)")],
                   [(Decimal("123456789012345.12"), Decimal("1234.567890"))])
    b.create_table("t", "gl", [("a", "bigint"), ("b", "bigint")], [(1, 2), (3, None)])
    b.create_table("t", "dv", [("v", "decimal(10,2)")],
                   [(Decimal("10.00"),), (Decimal("20.00"),), (Decimal("40.00"),)])
    b.create_table("t", "one", [("x", "bigint")], [(1,)])
    b.create_table("t", "sv", [("a", "varchar"), ("b", "varchar")],
                   [("apple", "zebra"), ("pear", "banana"), ("kiwi", "kiwi")])
    b.create_table("t", "px", [("g", "bigint"), ("v", "bigint")],
                   [(1, 10), (1, None), (1, 30), (2, None)])
    return b


AGG_SQL = {
    # tests/test_aggregate_breadth.py
    "bool_and_or_count_if": "select g, bool_and(b), bool_or(b), every(b), count_if(b)"
                            " from memory.t.w group by g order by g",
    "arbitrary_any_value": "select g, arbitrary(name), any_value(x) from memory.t.w "
                           "group by g order by g",
    "min_by_max_by": "select g, min_by(name, x), max_by(id, y) from memory.t.w "
                     "group by g order by g",
    "bivariate_family": "select g, corr(y, x), covar_pop(y, x), covar_samp(y, x),"
                        "       regr_slope(y, x), regr_intercept(y, x)"
                        " from memory.t.w group by g order by g",
    "geometric_mean": "select geometric_mean(x) from memory.t.w",
    "checksum": "select checksum(name) from memory.t.w",
    "checksum_reordered": "select checksum(name) from (select name from memory.t.w order by x)",
    # tests/test_functions.py
    "variance_family": """select g, var_samp(x), var_pop(x), stddev_samp(x), stddev_pop(x),
                  variance(x), stddev(x)
           from memory.t.samples group by g order by g""",
    "variance_large_offset": "select g, stddev(x), var_samp(x) from memory.t.bigoff "
                             "group by g order by g",
    "approx_distinct_exact": "select g, approx_distinct(k) from memory.t.samples "
                             "group by g order by g",
    "scalar_math": """select sqrt(2.25e0), ln(exp(2e0)), log10(1000e0), power(2e0, 10),
                  sign(-5), sign(0.0), ceil(2.1e0), floor(-2.1e0),
                  round(2.5e0), round(-2.5e0), round(3.14159e0, 2),
                  greatest(1, 7, 3), least(4, 2, 9)
           from memory.t.samples limit 1""",
    "decimal_round_ceil_floor": "select v, round(v), round(v, 1), ceil(v), floor(v) "
                                "from memory.t.d order by v",
    "long_decimal_quotient": "select a / b from memory.t.big",
    "long_decimal_product": "select b * b from memory.t.big",
    "greatest_least_nulls": "select a, greatest(a, b), least(a, b) from memory.t.gl order by a",
    "variance_on_decimal": "select stddev_pop(v), var_pop(v) from memory.t.dv",
    "log_two_arg_round_negative": "select log(2.0e0, 64.0e0), round(1234, -2), "
                                  "round(-1250, -2) from memory.t.one",
    "greatest_least_varchar": "select a, greatest(a, b), least(a, b) from memory.t.sv order by a",
    # tests/test_sketch_aggregates.py
    "approx_distinct_within_error": "select count(distinct l_orderkey), "
                                    "approx_distinct(l_orderkey) from lineitem",
    "approx_distinct_grouped": """select l_returnflag, count(distinct l_orderkey),
            approx_distinct(l_orderkey)
        from lineitem group by l_returnflag order by l_returnflag""",
    "approx_distinct_small_groups": "select approx_distinct(n_regionkey), "
                                    "approx_distinct(n_nationkey) from nation",
    "approx_percentile_median": "select approx_percentile(l_quantity, 0.5), "
                                "approx_percentile(l_quantity, 1.0), "
                                "approx_percentile(l_quantity, 0.0) from lineitem",
    "approx_percentile_grouped": """select o_orderpriority, approx_percentile(o_totalprice, 0.5)
        from orders group by o_orderpriority order by o_orderpriority""",
    "approx_percentile_nulls": "select g, approx_percentile(v, 0.5) from memory.t.px "
                               "group by g order by g",
    # beyond the reference's tests: DISTINCT, decimals and NULL arguments
    "approx_distinct_distinct": "select l_linestatus, approx_distinct(DISTINCT l_suppkey), "
                                "approx_distinct(l_extendedprice) from lineitem "
                                "group by l_linestatus order by l_linestatus",
    "decimal_statistics": """select l_returnflag, stddev(l_extendedprice), var_pop(l_discount),
            corr(l_quantity, l_extendedprice), geometric_mean(l_quantity),
            max_by(l_orderkey, l_extendedprice), min_by(l_shipmode, l_extendedprice),
            arbitrary(l_shipinstruct), checksum(l_comment), checksum(l_extendedprice)
        from lineitem where l_orderkey < 3000 group by l_returnflag order by l_returnflag""",
    "null_arguments": "select g, checksum(v), count_if(v > 10), bool_or(v > 10), "
                      "min_by(g, v), arbitrary(v), variance(v) from memory.t.px "
                      "group by g order by g",
}


@pytest.mark.parametrize("name", sorted(AGG_SQL))
def test_aggregate_sql_equals_reference(both, name):
    assert both.check(AGG_SQL[name])


def test_decimal_overflow_raises_in_both(both):
    both.create_table("t", "ovf", [("a", "decimal(20,0)"), ("b", "decimal(20,0)")],
                      [(Decimal("9" * 20), Decimal("9" * 20))])
    ref, got = both.check_raises("select a * b from memory.t.ovf")
    assert "overflow" in ref.lower() and "overflow" in got.lower()


def test_approx_percentile_splits_partial_final_in_port_planner():
    """The copied planner keeps the reference's split rule and state count
    (the states themselves: tests/test_torch_fragments.py)."""
    from trino_tpu_torch.sql.planner import plan as P

    call = P.AggregateCall("approx_percentile", 0, None, param=0.5)
    assert P.can_split_aggs([call])
    assert P._acc_state_count(call) == 66  # QUANTILE_SAMPLES + count
