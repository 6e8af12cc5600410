"""Nested types, UNNEST, MATCH_RECOGNIZE and lambdas through both Sessions
on the CPU: every case of the reference's tests/test_arrays.py but
``test_nested_serde_roundtrip`` (it waits for the port of data/serde.py),
the nine cases of tests/test_match_recognize.py, the three lambda cases of
tests/test_sql_surface.py, ``test_histogram`` and ``test_map_agg`` of
tests/test_aggregate_breadth.py, the refusals both packages keep, and the
queries of chip_smoke.py's phase nested at tiny.

Rows must match under ``values_match`` of tests/test_torch_sql_both.py
(arrays and maps compare element by element, exactly, and so in order);
where the JAX package raises, the port raises the same exception class.

Also the writer of the rows phase nested compares against at SF1, on a
machine without JAX:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_nested_sql.py --write-expected
"""
import datetime
import json
import os
import sys
import time
from decimal import Decimal

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from test_torch_sql_both import BothSessions, assert_rows_match  # noqa: E402

EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "trino_tpu_torch", "testdata", "nested_sf1_expected.json")


@pytest.fixture(scope="module")
def both():
    b = BothSessions({"catalog": "tpch", "schema": "tiny"})
    b.create_table("t", "docs", [("id", "bigint"), ("tags", "array(varchar)"),
                                 ("nums", "array(bigint)")], [
        (1, ["red", "blue"], [3, 1]), (2, [], []), (3, ["green", "red"], [7]),
        (4, None, None), (5, ["blue"], [2, 2, 9])])
    b.create_table("t", "j", [("id", "bigint"), ("xs", "array(varchar)")], [
        (1, ["a", "b"]), (2, ["b"]), (3, ["a", "c", "b"]), (4, []), (5, None)])
    b.create_table("t", "e", [("g", "bigint"), ("v", "bigint")],
                   [(1, 10), (2, 20), (1, 11), (2, 21), (1, 12), (3, None)])
    b.create_table("t", "sv", [("g", "bigint"), ("name", "varchar")],
                   [(1, "x"), (1, "y"), (2, "z")])
    b.create_table("t", "arr", [("id", "bigint"), ("xs", "array(bigint)")],
                   [(1, [1, 2, 3]), (2, []), (3, None), (4, [5, None])])
    rng = np.random.default_rng(7)
    rows = []
    for i in range(300):
        g = int(rng.integers(0, 3))
        x = float(rng.normal(10.0, 2.0))
        y = 2.5 * x + float(rng.normal(0.0, 0.5))
        flag = bool(rng.integers(0, 2))
        rows.append((i, g, flag, x, y, f"n{int(rng.integers(0, 5))}"))
    b.create_table("t", "w", [("id", "bigint"), ("g", "bigint"), ("b", "boolean"),
                              ("x", "double"), ("y", "double"), ("name", "varchar")], rows)
    b.create_table("t", "kv", [("g", "bigint"), ("k", "varchar"), ("v", "bigint")],
                   [(1, "a", 10), (1, "b", 20), (2, "c", 30), (2, None, 40), (3, None, None)])
    b.create_table("t", "rows", [("id", "bigint"), ("r", "row(a bigint, b varchar)"),
                                 ("m", "map(varchar, double)")], [
        (1, (5, "x"), {"p": 1.5, "q": -2.0}), (2, None, {}), (3, (None, "y"), None),
        (4, (7, None), {"z": 0.25})])
    return b


def _raises_alike(both, sql):
    ref = got = None
    try:
        both.jax.execute(sql)
    except Exception as e:  # noqa: BLE001 — the class is what is compared
        ref = e
    try:
        both.torch.execute(sql)
    except Exception as e:  # noqa: BLE001
        got = e
    assert ref is not None and got is not None, (ref, got)
    assert type(got).__name__ == type(ref).__name__, (repr(got), repr(ref))
    return ref, got


# ------------------------------------------------- tests/test_arrays.py
ARRAYS_SQL = {
    "array_constructor_and_subscript":
        "select array[1,2,3][2], array[1,2,3][-1], cardinality(array[1,2,3])",
    "element_at_null_semantics":
        "select element_at(array[1,2], 5), element_at(map(array['a'], array[1]), 'b')",
    "contains_null_semantics":
        "select contains(array[1,2], 2), contains(array[1,2], 9),"
        "       contains(array[1,null], 1), contains(array[1,null], 9)",
    "array_position_min_max_sum":
        "select array_position(array[5,6,7], 7), array_position(array[5], 9),"
        "       array_min(array[4,1,9]), array_max(array[4,1,9]), array_sum(array[4,1,9])",
    "map_functions":
        "select map(array['a','b'], array[1,2])['b'],"
        "       cardinality(map(array['a'], array[9])),"
        "       map_keys(map(array['a','b'], array[1,2])),"
        "       map_values(map(array['a','b'], array[1,2]))",
    "cardinality_over_table": "select id, cardinality(tags) from memory.t.docs order by id",
    "unnest_standalone": "select * from unnest(array[5,6,7])",
    "unnest_with_ordinality":
        "select x, n from unnest(array['a','b']) with ordinality as t(x, n)",
    "unnest_lateral":
        "select id, tag from memory.t.docs cross join unnest(tags) as u(tag) order by id, tag",
    "unnest_empty_and_null_produce_no_rows":
        "select id from memory.t.docs cross join unnest(nums) as u(v) where id in (2, 4) ",
    "unnest_map":
        "select k, v from unnest(map(array[1,2], array[10,20])) as u(k, v) order by k",
    "unnest_zip_two_arrays":
        "select a, b from unnest(array[1,2,3], array['x','y']) as t(a, b) order by a",
    "unnest_aggregation_matches_sqlite":
        "select x, count(*), min(id), max(id) from memory.t.j"
        " cross join unnest(xs) as u(x) group by x order by x",
    "array_agg_grouped": "select g, array_agg(v) from memory.t.e group by g order by g",
    "array_agg_global_filtered": "select array_agg(v) from memory.t.e where v > 11",
    "array_equality_semantics":
        "select array[1,2] = array[3,4], array[1,2] = array[1,2],"
        "       array[1,2] <> array[1,3], array[1,2] = array[1,2,3],"
        "       array[1,null] = array[1,2], array[1,null] = array[2,2]",
    "array_constructor_with_null_varchar": "select array['a', null][2]",
    "join_unnest_applies_on_predicate":
        "select id, v from memory.t.docs join unnest(nums) as u(v) on id = 1 order by v",
    "array_sum_narrow_dtype_widens":
        "select array_sum(array[cast(100 as tinyint), cast(100 as tinyint)])",
    "array_agg_varchar_roundtrips_through_unnest":
        "select g, n from (select g, array_agg(name) as ns from memory.t.sv group by g)"
        " cross join unnest(ns) as u(n) order by g, n",
    # beyond the reference's cases: row and map columns of a table, a NULL
    # row's field, a map of doubles, mixed element dtypes
    "row_and_map_columns":
        "select id, r, r[1], r[2], m, cardinality(m), element_at(m, 'p') "
        "from memory.t.rows order by id",
    "array_of_mixed_dtypes":
        "select array[n_nationkey, 2.5e0, n_regionkey], array[true, n_nationkey > 3] "
        "from nation order by n_nationkey",
    "array_agg_of_varchar_by_region":
        "select r_name, array_agg(n_name), cardinality(array_agg(n_name)) "
        "from nation, region where n_regionkey = r_regionkey group by r_name order by r_name",
}

ARRAYS_RAISES = {
    "subscript_out_of_bounds_raises": "select array[1,2][5]",
    "array_ordering_comparison_rejected": "select array[1] < array[2]",
    "array_agg_distinct_unsupported": "select array_agg(distinct id) from memory.t.docs",
}


@pytest.mark.parametrize("name", sorted(ARRAYS_SQL))
def test_arrays_sql_equals_reference(both, name):
    rows = both.check(ARRAYS_SQL[name])
    if name != "unnest_empty_and_null_produce_no_rows":
        assert rows, name


@pytest.mark.parametrize("name", sorted(ARRAYS_RAISES))
def test_arrays_refusal_raises_alike(both, name):
    _raises_alike(both, ARRAYS_RAISES[name])


def test_subscript_out_of_bounds_names_its_code(both):
    ref, got = _raises_alike(both, ARRAYS_RAISES["subscript_out_of_bounds_raises"])
    assert ref.code == got.code == "INVALID_FUNCTION_ARGUMENT"


def test_nested_column_roundtrip():
    """test_nested_column_roundtrip: Python values through a column and
    back, the port's host data staged to the device against the
    reference's device column."""
    from trino_tpu import types as JT
    from trino_tpu.data.page import Column as JaxColumn

    from trino_tpu_torch import types as TT
    from trino_tpu_torch.data.page import column_data_from_python, column_to_device

    for tname, data in (("array(bigint)", [[1, 2], [], None, [5]]),
                        ("map(varchar, bigint)", [{"a": 1}, None, {}, {"b": 2, "a": None}]),
                        ("row(a bigint, b varchar)", [(1, "x"), None, (None, None)]),
                        ("array(decimal(10,2))", [[Decimal("1.25")], None, []]),
                        ("array(date)", [[datetime.date(1995, 3, 1)], [None]])):
        want = JaxColumn.from_python(JT.parse_type(tname), data).to_python()
        got = column_to_device(column_data_from_python(TT.parse_type(tname), data),
                               "cpu").to_python()
        assert got == want, tname


def test_nested_type_parsing():
    from trino_tpu import types as JT

    from trino_tpu_torch import types as TT

    for name in ("array(bigint)", "map(varchar, bigint)", "row(a bigint, b varchar)",
                 "array(decimal(10,2))", "array(array(bigint))"):
        t, j = TT.parse_type(name), JT.parse_type(name)
        assert (str(t), type(t).__name__, t.is_nested) == (str(j), type(j).__name__, j.is_nested)
    r = TT.parse_type("row(a bigint, b varchar)")
    assert r.field_names == ("a", "b")


def test_nested_concat_and_compact():
    from trino_tpu import types as JT
    from trino_tpu.data.page import Column as JaxColumn
    from trino_tpu.data.page import Page as JaxPage

    from trino_tpu_torch import types as TT
    from trino_tpu_torch.data.page import Page, column_data_from_python, column_to_device

    parts = ([[1], [2, 3]], [None, [4]])
    jp = JaxPage.concat_pages(*[JaxPage([JaxColumn.from_python(JT.array_of(JT.BIGINT), p)])
                                for p in parts])
    tp = Page.concat_pages(*[Page([column_to_device(
        column_data_from_python(TT.array_of(TT.BIGINT), p), "cpu")]) for p in parts])
    assert tp.to_pylist() == jp.to_pylist() == [([1],), ([2, 3],), (None,), ([4],)]


# ------------------------------------------- tests/test_match_recognize.py
STOCK = """
(values
  ('ACME', 1, 100), ('ACME', 2, 90), ('ACME', 3, 80), ('ACME', 4, 85),
  ('ACME', 5, 95), ('ACME', 6, 94), ('ACME', 7, 90), ('ACME', 8, 98),
  ('BETA', 1, 50), ('BETA', 2, 60), ('BETA', 3, 55), ('BETA', 4, 70)
) as t(sym, day, price)
"""

MATCH_RECOGNIZE_SQL = {
    "v_shape_falling_then_rising": f"""
      select * from {STOCK}
      match_recognize (
        partition by sym order by day
        measures first(strt.day) as start_day, last(down.day) as bottom_day,
                 last(up.price) as top_price, match_number() as mn
        after match skip past last row
        pattern (strt down+ up+)
        define down as price < prev(price), up as price > prev(price)
      ) order by sym, mn""",
    "quantifier_backtracking": """
      select * from (values (1, 1), (2, 2), (3, 3), (4, 4)) as t(i, v)
      match_recognize (
        order by i
        measures first(a.v) as a_v, classifier() as last_var
        pattern (a b* c)
        define b as v > prev(v), c as v > prev(v)
      )""",
    "skip_to_next_row_overlapping": """
      select * from (values (1, 10), (2, 20), (3, 30)) as t(i, v)
      match_recognize (
        order by i
        measures first(a.i) as s, last(b.i) as e
        after match skip to next row
        pattern (a b)
        define b as v > prev(v)
      ) order by s""",
    "optional_and_undefined_variables": """
      select * from (values (1, 5), (2, 50), (3, 6)) as t(i, v)
      match_recognize (
        order by i
        measures first(a.i) as s, coalesce(last(spike.v), -1) as spike_v,
                 last(e.i) as e
        pattern (a spike? e)
        define spike as v > 40
      ) order by s""",
    "partition_isolation_and_prev_boundary": """
      select * from (values ('a', 1, 10), ('a', 2, 20), ('b', 1, 100),
                            ('b', 2, 50)) as t(p, i, v)
      match_recognize (
        partition by p order by i
        measures last(up.v) as topv
        pattern (up)
        define up as v > prev(v)
      ) order by p""",
    "match_recognize_over_real_table": """
      select * from (
        select o_custkey, o_orderkey, o_totalprice from orders
        where o_custkey < 20
      ) match_recognize (
        partition by o_custkey order by o_orderkey
        measures match_number() as mn, first(a.o_orderkey) as k0,
                 last(b.o_orderkey) as k1
        pattern (a b+)
        define b as o_totalprice > prev(o_totalprice)
      )""",
    "secondary_order_key_breaks_ties": """
      select * from (values (1, 2, 2), (1, 3, 3), (1, 1, 1)) as t(g, seq, v)
      match_recognize (
        order by g, seq
        measures first(a.v) as lo, last(b.v) as hi
        pattern (a b+)
        define b as v > prev(v)
      )""",
    "no_match_result_joins_cleanly": """
      select * from (
        select * from (values (1, 5), (2, 4)) as t(g, v)
        match_recognize (order by g measures last(up.v) as w
                         pattern (up) define up as v > prev(v))
      ) m join (values (1)) u(x) on m.w = u.x""",
}

PLAN_TIME_INVALID = (
    """select * from (values (1)) as t(v)
       match_recognize (order by v measures 1 as x
         pattern (a) define a as no_such_col > 1)""",
    """select * from (values (1)) as t(v)
       match_recognize (order by v measures 1 as x
         pattern (a) define zz as v > 1)""",
)


@pytest.mark.parametrize("name", sorted(MATCH_RECOGNIZE_SQL))
def test_match_recognize_equals_reference(both, name):
    rows = both.check(MATCH_RECOGNIZE_SQL[name])
    if name != "no_match_result_joins_cleanly":
        assert rows, name


def test_match_recognize_plan_time_validation(both):
    for sql in PLAN_TIME_INVALID:
        _raises_alike(both, sql)


def test_match_recognize_explain_equals_reference(both):
    """The restored planner copy plans MATCH_RECOGNIZE as the reference
    does: EXPLAIN's text is equal."""
    for name in ("match_recognize_over_real_table", "no_match_result_joins_cleanly"):
        sql = MATCH_RECOGNIZE_SQL[name]
        assert both.torch.explain(sql) == both.jax.explain(sql), name


# ---------------------------------- tests/test_sql_surface.py, lambdas
LAMBDA_SQL = {
    "lambda_transform":
        "select id, transform(xs, x -> x * 2 + 1) from memory.t.arr order by id",
    "lambda_matches_three_valued":
        "select id, any_match(xs, x -> x > 2), all_match(xs, x -> x > 0),"
        "       none_match(xs, x -> x > 9) from memory.t.arr order by id",
    "lambda_over_varchar": "select transform(array['a','bb'], s -> length(s))",
}


@pytest.mark.parametrize("name", sorted(LAMBDA_SQL))
def test_lambda_equals_reference(both, name):
    assert both.check(LAMBDA_SQL[name])


# ------------------------------- tests/test_aggregate_breadth.py, maps
MAP_AGGREGATES_SQL = {
    "histogram": "select g, histogram(name) from memory.t.w group by g order by g",
    "map_agg": "select g, map_agg(k, v) from memory.t.kv group by g order by g",
}


@pytest.mark.parametrize("name", sorted(MAP_AGGREGATES_SQL))
def test_map_aggregate_equals_reference(both, name):
    assert both.check(MAP_AGGREGATES_SQL[name])


def test_union_all_of_map_aggregates_gives_the_sql_answer(both):
    """A reference fault the port repairs: a map aggregate's flat children
    hold dead entries past its rows' ranges, and the reference's
    ``_concat_col`` concatenates them as they are, so UNION ALL reads the
    second branch's maps shifted: here (1, {None: None}) for
    (11, {'a': 10, 'b': 20}) and (12, {'a': 10}) for (12, {'c': 30})."""
    sql = ("select g, map_agg(k, v) from memory.t.kv group by g union all "
           "select g + 10, map_agg(k, v) from memory.t.kv group by g")
    branch = [(1, {"a": 10, "b": 20}), (2, {"c": 30}), (3, None)]
    want = sorted(branch + [(g + 10, m) for g, m in branch], key=repr)
    assert sorted(both.torch.execute(sql).rows, key=repr) == want
    ref = sorted(both.jax.execute(sql).rows, key=repr)
    assert ref != want and (12, {"a": 10}) in ref


# -------------------------------------------- the refusals both packages keep
REFUSALS = {
    "array_agg_distinct": "select o_orderstatus, array_agg(distinct o_custkey) "
                          "from orders group by 1",
    "order_by_an_array": "select id, nums from memory.t.docs order by nums",
    "nested_build_payload": "select o.o_orderkey, d.tags from orders o "
                            "left join memory.t.docs d on o.o_orderkey = d.id",
    "nested_expansion_payload": "select d.tags, o.o_orderkey from memory.t.docs d, orders o "
                                "where o.o_custkey = d.id",
    "nested_probe_payload": "select d.tags, e.v from memory.t.docs d join memory.t.e e "
                            "on d.id = e.g",
    "array_ordering_comparison": "select array[n_nationkey] < array[1] from nation",
    "unnest_replicates_a_nested_column":
        "select id, tags, v from memory.t.docs cross join unnest(nums) as u(v)",
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusal_raises_alike(both, name):
    _raises_alike(both, REFUSALS[name])


# ------------------------------------------------- phase nested's queries
# ``{s}`` is the TPC-H schema: tiny here, sf1 on the card
_CUST_ORDERS = ("select o_custkey, array_agg(o_orderkey) as ks from tpch.{s}.orders "
                "group by o_custkey")
_ORDER_LINES = ("select l_orderkey, map_agg(l_linenumber, l_quantity) as m "
                "from tpch.{s}.lineitem group by l_orderkey")
NESTED = {
    "n_array_agg": f"""
select count(*), sum(cardinality(ks)), sum(ks[1]), sum(element_at(ks, -1)),
       sum(array_sum(ks)), max(array_max(ks)), min(array_min(ks))
from ({_CUST_ORDERS})""",
    "n_array_agg_rows": """
select o_custkey, array_agg(o_totalprice) from tpch.{s}.orders where o_custkey <= 300
group by o_custkey order by o_custkey""",
    "n_unnest": f"""
select count(*), sum(k), count(distinct k) from ({_CUST_ORDERS}) cross join unnest(ks) as u(k)""",
    "n_unnest_ordinality": f"""
select count(*), sum(k), sum(n), sum(k * n)
from ({_CUST_ORDERS}) cross join unnest(ks) with ordinality as u(k, n) where n <= 3""",
    "n_histogram": """
select count(*), sum(cardinality(h)), sum(element_at(h, '1-URGENT'))
from (select o_custkey, histogram(o_orderpriority) as h from tpch.{s}.orders
      group by o_custkey)""",
    "n_map_agg": f"""
select count(*), sum(m[1]), sum(element_at(m, 7)), sum(cardinality(map_keys(m))),
       sum(array_sum(map_values(m)))
from ({_ORDER_LINES})""",
    "n_unnest_map": f"""
select k, count(*), sum(v) from ({_ORDER_LINES}) cross join unnest(m) as u(k, v)
group by k order by k""",
    "n_lambdas": f"""
select sum(array_sum(transform(ks, x -> x % 7))), count_if(any_match(ks, x -> x % 1000 = 7)),
       count_if(all_match(ks, x -> x > 100)), count_if(none_match(ks, x -> x < 1000)),
       count_if(contains(ks, 1)), sum(array_position(ks, element_at(ks, -1)))
from ({_CUST_ORDERS})""",
    "n_rows_eq": """
select sum(row(l_orderkey, l_partkey)[2]),
       count_if(array[l_linenumber, l_suppkey] = array[1, l_suppkey]),
       count_if(array[l_linenumber, l_suppkey] <> array[l_linenumber, l_partkey])
from tpch.{s}.lineitem""",
    "n_match_recognize": """
select l_shipmode, count(*), min(start_day), max(bottom_day), sum(top_rev), max(mn),
       count_if(cls = 'UP')
from (select l_shipmode, l_shipdate, sum(l_extendedprice) as rev from tpch.{s}.lineitem
      group by l_shipmode, l_shipdate)
match_recognize (
  partition by l_shipmode order by l_shipdate
  measures first(strt.l_shipdate) as start_day, last(down.l_shipdate) as bottom_day,
           last(up.rev) as top_rev, match_number() as mn, classifier() as cls
  after match skip past last row
  pattern (strt down+ up+)
  define down as rev < prev(rev), up as rev > prev(rev))
group by l_shipmode order by l_shipmode""",
}
# n_ctas_cached: a memory table of arrays, then one aggregate read twice
# through a cached session (a miss, then a hit)
CTAS = "create table memory.{m}.cust_orders as " + _CUST_ORDERS
CTAS_READ = ("select count(*), sum(cardinality(ks)), sum(array_sum(ks)), max(ks[1]), "
             "min(element_at(ks, -1)) from memory.{m}.cust_orders")


def nested_sql(name, scale):
    return NESTED[name].format(s=scale).strip()


def jsonable(v):
    """A result value in chip_smoke.py's JSON form: decimals and dates as
    strings, arrays as lists, maps as {"map": [[key, value], ...]} in key
    order, rows as lists."""
    if v is None or isinstance(v, (int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, dict):
        return {"map": [[jsonable(k), jsonable(x)]
                        for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))]}
    return str(v)


def jsonable_rows(rows):
    return [[jsonable(v) for v in r] for r in rows]


@pytest.mark.parametrize("name", list(NESTED))
def test_nested_phase_query_at_tiny(both, name):
    assert both.check(nested_sql(name, "tiny")), name


def test_ctas_of_arrays_misses_then_hits_the_device_cache():
    """n_ctas_cached at tiny: the table of arrays written through the
    Python-row sink reads back the reference's rows, the first cached
    read misses and the second hits, staging no row; an INSERT of arrays
    makes the next read miss again."""
    from trino_tpu_torch.obs import metrics as M

    b = BothSessions({"catalog": "tpch", "schema": "tiny", "device_cache_enabled": True})
    for s in (b.jax, b.torch):
        s.execute(CTAS.format(m="nest", s="tiny"))
    read = CTAS_READ.format(m="nest")
    ref = b.jax.execute(read).rows
    seen = []
    for _ in range(2):
        h0, m0, r0 = (M.DEVICE_CACHE_HITS.value(), M.DEVICE_CACHE_MISSES.value(),
                      M.STAGED_ROWS.value())
        assert_rows_match(b.torch.execute(read).rows, ref, "n_ctas_cached")
        seen.append((M.DEVICE_CACHE_HITS.value() - h0, M.DEVICE_CACHE_MISSES.value() - m0,
                     M.STAGED_ROWS.value() - r0))
    assert seen[0][1] == 1 and seen[0][2] > 0
    assert seen[1] == (1, 0, 0)
    # an INSERT of more arrays invalidates the cached table
    insert = ("insert into memory.nest.cust_orders select o_custkey + 100000, "
              "array_agg(o_orderkey) from tpch.tiny.orders where o_custkey < 50 group by o_custkey")
    for s in (b.jax, b.torch):
        s.execute(insert)
    m0 = M.DEVICE_CACHE_MISSES.value()
    assert_rows_match(b.torch.execute(read).rows, b.jax.execute(read).rows, "after INSERT")
    assert M.DEVICE_CACHE_MISSES.value() - m0 == 1


def test_expected_file_matches_queries():
    """The committed SF1 rows carry the SQL the smoke run executes."""
    with open(EXPECTED) as f:
        data = json.load(f)
    assert data["scale"] == "sf1" and data["properties"] == {"catalog": "tpch", "schema": "sf1"}
    assert list(data["queries"]) == list(NESTED)
    for name, entry in data["queries"].items():
        assert entry["sql"] == nested_sql(name, "sf1")
        assert entry["rows"] and all(len(r) == len(entry["columns"]) for r in entry["rows"])
    ctas = data["ctas"]
    assert ctas["sql"] == CTAS.format(m="nest", s="sf1")
    assert ctas["read_sql"] == CTAS_READ.format(m="nest") and ctas["rows"]


def write_expected():
    from trino_tpu.client.session import Session as JaxSession

    props = {"catalog": "tpch", "schema": "sf1"}
    session = JaxSession(properties=dict(props))
    out = {"scale": "sf1", "properties": props,
           "writer": "trino_tpu (JAX, CPU) via tests/test_torch_nested_sql.py --write-expected",
           "queries": {}}

    def dump():
        with open(EXPECTED, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")

    for name in NESTED:
        w0 = time.perf_counter()
        res = session.execute(nested_sql(name, "sf1"))
        out["queries"][name] = {"sql": nested_sql(name, "sf1"),
                                "columns": list(res.column_names),
                                "rows": jsonable_rows(res.rows)}
        print(f"{name}: {len(res.rows)} rows in {time.perf_counter() - w0:.1f} s", flush=True)
        dump()
    session.execute(CTAS.format(m="nest", s="sf1"))
    read = CTAS_READ.format(m="nest")
    out["ctas"] = {"sql": CTAS.format(m="nest", s="sf1"), "read_sql": read,
                   "rows": jsonable_rows(session.execute(read).rows)}
    dump()


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-expected"]:
        write_expected()
    else:
        sys.exit("usage: python tests/test_torch_nested_sql.py --write-expected")
