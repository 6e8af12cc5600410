"""The scalar function families through both Sessions on the CPU: the SQL of
the reference's tests/test_scalar_breadth.py, test_scalar_more.py and
test_type_breadth.py (all but its row, array and serde cases: the nested
types run in tests/test_torch_nested_sql.py, and serde is not SQL), four
nested functions over nation, the faults the port repairs, the refusals
both packages share, and the queries of chip_smoke.py's phase scalar at
tiny.
The SQL of tests/test_functions.py runs in tests/test_torch_aggregates.py.

Rows must match under ``values_match`` (doubles within the tolerance of
tests/test_torch_sql_both.py); where the JAX package raises, the port
raises the same exception class.

Also the writer of the rows phase scalar compares against at SF1, on a
machine without JAX:

    JAX_PLATFORMS=cpu python tests/test_torch_scalar_sql.py --write-expected

(a few minutes of one CPU and several GiB of host memory for the SF1
tables).
"""
import datetime
import json
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from test_torch_sql_both import BothSessions, assert_rows_match  # noqa: E402

EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "trino_tpu_torch", "testdata", "scalar_sf1_expected.json")


@pytest.fixture(scope="module")
def both():
    b = BothSessions({"catalog": "tpch", "schema": "tiny"})
    b.create_table("t", "s", [("id", "bigint"), ("v", "varchar"), ("d", "date"),
                              ("x", "double"), ("j", "varchar")], [
        (1, "hello world", "2024-02-15", 1.5, '{"a": {"b": [1, 2, 3]}, "s": "txt"}'),
        (2, "foo42bar", "2023-12-31", float("nan"), "[10, 20]"),
        (3, None, None, None, None),
    ])
    b.create_table("t", "f", [("x", "double")],
                   [(0.0,), (-0.0,), (1.0,), (float("nan"),), (None,)])
    return b


# ---------------------------------------------------- the reference's SQL
REFERENCE_SQL = {
    # tests/test_scalar_breadth.py
    "trig_and_constants": "select sin(1.0), cos(0.5), atan2(1.0, 2.0), tanh(0.3), "
                          "degrees(pi()), radians(180.0), pi(), e(), mod(17, 5), "
                          "truncate(-2.7), truncate(12.345, 1) from tpch.tiny.region limit 1",
    "truncate_decimal_scale": """select l_extendedprice, truncate(l_extendedprice, 1)
        from lineitem order by l_orderkey, l_linenumber limit 10""",
    "string_functions": """select n_name, replace(n_name, 'A', '_'), reverse(n_name),
               strpos(n_name, 'AN'), starts_with(n_name, 'UNITED')
        from nation order by n_nationkey limit 4""",
    "date_functions": """select o_orderdate, day_of_week(o_orderdate), day_of_year(o_orderdate),
               week(o_orderdate),
               date_trunc('month', o_orderdate), date_trunc('year', o_orderdate),
               date_trunc('week', o_orderdate), date_trunc('quarter', o_orderdate)
        from orders order by o_orderkey limit 25""",
    "strings_in_where": "select count(*) from nation where starts_with(n_name, 'I')",
    "strings_in_where_rows": "select n_name from nation where starts_with(n_name, 'I') "
                             "order by n_name",
    "order_by_hidden_column": "select n_name from nation order by n_nationkey desc limit 3",
    "order_by_hidden_decimal": "select o_orderkey from orders order by o_totalprice desc limit 2",
    "concat_typed_constants": "select concat('x=', 1.25), concat('d=', date '1995-03-15')",
    "cast_double_to_decimal": "select cast(1.5e0 as decimal(3,1)), cast(-2.45e0 as decimal(3,1))",
    # tests/test_scalar_more.py
    "regexp_family": "select regexp_like(v, '[0-9]+'), regexp_extract(v, '([0-9]+)', 1),"
                     "       regexp_replace(v, 'o', '0'), regexp_count(v, 'o')"
                     " from memory.t.s order by id",
    "pads_split_translate": "select lpad(v, 14, '*'), rpad(v, 5), split_part(v, ' ', 2),"
                            "       split_part(v, ' ', 9), translate(v, 'lo', 'LO')"
                            " from memory.t.s where id = 1",
    "chr_codepoint_repeat": "select codepoint(chr(65)), repeat(v, 2) from memory.t.s where id = 2",
    "string_distances": "select hamming_distance(v, 'hello xorld'),"
                        "       levenshtein_distance(v, 'hello') from memory.t.s where id = 1",
    "json_path": "select json_extract_scalar(j, '$.a.b[2]'), json_extract_scalar(j, '$.s'),"
                 "       json_array_length(j) from memory.t.s order by id",
    "date_format_and_names": "select date_format(d, '%Y/%m/%d'), day_name(d), month_name(d),"
                             "       last_day_of_month(d) from memory.t.s order by id",
    "date_parse": "select date_parse('2020-03-04', '%Y-%m-%d')",
    "bitwise": "select bitwise_and(12, 10), bitwise_or(12, 10), bitwise_xor(12, 10),"
               "       bitwise_not(0), bitwise_left_shift(1, 4),"
               "       bitwise_right_shift(16, 2), bit_count(255)",
    "float_classification_and_if": "select is_nan(x), is_finite(x), if(x > 1, 9, 0) "
                                   "from memory.t.s order by id",
    "nan_and_infinity": "select is_nan(nan()), is_infinite(infinity())",
    "typeof": "select typeof(x), typeof(v), typeof(d) from memory.t.s where id = 1",
    "to_unixtime_of_date": "select to_unixtime(d) from memory.t.s where id = 2",
    # tests/test_type_breadth.py
    "timestamp_literal_precisions": "select timestamp '2024-03-15 10:30:45', "
                                    "timestamp '2024-03-15 10:30:45.123', "
                                    "timestamp '2024-03-15 10:30:45.123456'",
    "timestamp_interval_arithmetic": "select timestamp '2024-03-15 23:30:00' + interval '45' minute, "
                                     "timestamp '2024-03-15 00:10:00' - interval '1' day, "
                                     "timestamp '2024-01-31 12:00:00' + interval '1' month",
    "timestamp_extract": "select extract(year from timestamp '2024-03-15 10:30:45'), "
                         "extract(hour from timestamp '2024-03-15 10:30:45'), "
                         "extract(minute from timestamp '2024-03-15 10:30:45'), "
                         "extract(second from timestamp '2024-03-15 10:30:45')",
    "timestamp_comparisons": "select timestamp '2024-03-15 10:00:00' > "
                             "timestamp '2024-03-15 09:59:59.999999', "
                             "date '2024-03-16' > timestamp '2024-03-15 23:59:59', "
                             "date '2024-03-15' = timestamp '2024-03-15 00:00:00'",
    "timestamp_casts_round_half_up": "select cast(timestamp '2024-03-15 10:30:45.5' as timestamp(0)), "
                                     "cast(timestamp '2024-03-15 10:30:45.4999' as timestamp(0)), "
                                     "cast(date '2024-03-15' as timestamp(3)), "
                                     "cast(timestamp '2024-03-15 23:59:59' as date)",
    "at_time_zone_fixed_offsets": "select timestamp '2024-03-15 10:00:00' at time zone '+05:30', "
                                  "timestamp '2024-03-15 10:00:00' at time zone 'UTC'",
    "timestamp_tz_literal": "select timestamp '2024-03-15 10:00:00+02:00'",
    "timestamp_group_and_sort": "select t, count(*) from (values "
                                "(timestamp '2024-01-01 10:00:00'), (timestamp '2024-01-01 10:00:00'), "
                                "(timestamp '2024-01-02 09:00:00')) as v(t) "
                                "group by t order by t desc",
    "tpcds_timestamp_arithmetic": "select count(*) from tpcds.tiny.date_dim "
                                  "where cast(d_date as timestamp(3)) + interval '12' hour "
                                  "      < timestamp '1999-06-01 11:00:00' and d_year = 1999",
    "tpcds_timestamp_arithmetic_want": "select count(*) from tpcds.tiny.date_dim "
                                       "where d_date < date '1999-06-01' and d_year = 1999",
    "varbinary_literals_and_functions": "select X'DEADBEEF', length(X'DEADBEEF'), to_hex(X'0a1b'), "
                                        "from_hex('0A1B'), to_utf8('hi'), from_utf8(X'6869')",
    "md5": "select md5(to_utf8('abc'))",
    "varbinary_comparison": "select X'01' < X'02', X'ff' > X'0102', X'AB' = X'ab'",
    "varbinary_grouping": "select b, count(*) from (values (X'01'), (X'01'), (X'02')) as v(b) "
                          "group by b order by b",
    "varchar_varbinary_casts": "select cast('abc' as varbinary), cast(X'616263' as varchar)",
    "from_hex_bad_entry_filtered": "select from_hex(h) from (values ('6869'), ('zz')) as v(h) "
                                   "where h != 'zz'",
    "date_diff": "select date_diff('day', date '2024-01-01', date '2024-03-01'), "
                 "date_diff('week', date '2024-01-01', date '2024-03-01'), "
                 "date_diff('hour', timestamp '2024-01-01 00:00:00', "
                 "          timestamp '2024-01-02 06:30:00'), "
                 "date_diff('month', date '2024-01-31', date '2024-03-30'), "
                 "date_diff('year', date '2020-06-01', date '2024-05-31')",
    "date_add": "select date_add('day', 5, date '2024-02-27'), "
                "date_add('hour', -2, timestamp '2024-01-01 01:00:00'), "
                "date_add('month', 1, date '2024-01-31')",
    "unixtime_round_trip": "select to_unixtime(timestamp '1970-01-02 00:00:00'), "
                           "from_unixtime(86400.5)",
}

# statements the reference's tests expect to fail
REFERENCE_RAISES = {
    "unknown_time_zone": "select timestamp '2024-03-15 10:00:00' at time zone 'Mars/Olympus'",
    "from_hex_live_bad_entry": "select from_hex(h) from (values ('zz')) as v(h)",
}

# refusals the port keeps: the JAX package raises NotImplementedError
REFUSED = {
    "cast_bigint_to_varchar": "select cast(o_orderkey as varchar) from orders limit 1",
    "cast_decimal_to_varchar": "select cast(o_totalprice as varchar) from orders limit 1",
    "cast_date_to_varchar": "select cast(o_orderdate as varchar) from orders limit 1",
    "cast_varchar_to_date": "select cast(o_orderstatus as date) from orders limit 1",
    "concat_two_columns": "select n_name || n_comment from nation limit 1",
    "concat_two_columns_fn": "select concat(n_name, n_comment) from nation limit 1",
    "chr_of_a_column": "select chr(n_nationkey + 65) from nation",
}

# beyond the reference's tests: NULLs, edges and the families over tpch.tiny
MORE_SQL = {
    "mod_edges": "select mod(-7, 2), mod(7, -2), -7 % 3, mod(-9223372036854775807 - 1, 1), "
                 "mod(5.5, 2), mod(-5.5e0, 2e0), mod(5e0, 0e0)",
    "abs_truncate_edges": "select abs(-9223372036854775807), abs(-2.50), abs(-0.0e0), "
                          "truncate(-2.75, 1), truncate(1234.5, -2), truncate(-1e0 / 3e0, 3)",
    "float_classes_signed_zero": "select x, is_nan(x), is_finite(x), is_infinite(x / 0e0), "
                                 "sign(x) from memory.t.f",
    "trig_family": "select sum(sin(l_discount)), sum(cos(l_tax)), sum(tan(l_discount)), "
                   "sum(asin(l_discount)), sum(acos(l_tax)), sum(atan(l_quantity)), "
                   "sum(sinh(l_discount)), sum(cosh(l_tax)), sum(tanh(l_discount * 10)), "
                   "sum(cbrt(l_quantity)), sum(log2(l_quantity)), sum(log10(l_quantity)), "
                   "sum(degrees(l_tax)), sum(radians(l_quantity)) from lineitem",
    "log10_powers": "select log10(1000e0), log10(1e-5), log10(1e22), log10(0e0), log10(-1e0), "
                    "log10(1e300)",
    "bitwise_columns": "select sum(bitwise_and(l_orderkey, 255)), sum(bitwise_or(l_suppkey, 8)),"
                       " sum(bit_count(l_partkey)), sum(bitwise_xor(l_suppkey, l_linenumber)),"
                       " sum(bitwise_right_shift(l_orderkey, 3)),"
                       " sum(bitwise_left_shift(l_linenumber, 60)), max(bitwise_not(l_suppkey)),"
                       " bit_count(-1), bitwise_right_shift(-1, 1), bitwise_right_shift(-1, 64),"
                       " bitwise_left_shift(1, 63), bitwise_left_shift(1, 64) from lineitem",
    "negative_shift_raises": "select bitwise_right_shift(l_orderkey, -1) from lineitem",
    "coalesce_nullif_numeric": "select n_nationkey, coalesce(nullif(n_regionkey, 2), -1), "
                               "nullif(n_nationkey, n_regionkey), nullif(n_name, 'PERU'), "
                               "coalesce(nullif(n_name, 'PERU'), n_name) from nation order by n_nationkey",
    "extract_timestamps_before_1970": "select extract(hour from timestamp '1969-12-31 23:59:59.999'), "
                                      "extract(minute from timestamp '1969-12-31 23:59:59.999'), "
                                      "extract(second from timestamp '1969-12-31 23:59:59.999'), "
                                      "extract(day from timestamp '1969-12-31 23:59:59.999'), "
                                      "cast(timestamp '1969-12-31 23:59:59.999' as date), "
                                      "cast(timestamp '1969-12-31 23:59:59.5' as timestamp(0))",
    "month_diff_clamps": "select date_diff('month', date '2024-01-31', date '2024-02-29'), "
                         "date_diff('month', date '2024-03-31', date '2024-02-29'), "
                         "date_diff('year', date '2024-02-29', date '2023-02-28'), "
                         "date_diff('day', date '1995-01-15', date '1969-07-14')",
    "timestamp_columns": "select o_orderpriority, count(*), "
                         "max(cast(cast(o_orderdate as timestamp(6)) + interval '36' hour as date)), "
                         "min(extract(hour from cast(o_orderdate as timestamp(3)) + interval '5' hour)), "
                         "max(to_unixtime(cast(o_orderdate as timestamp(3)))) "
                         "from orders group by o_orderpriority order by o_orderpriority",
    "date_names_grouped": "select day_name(o_orderdate), count(*), min(month_name(o_orderdate)) "
                          "from orders group by 1 order by 1",
    "date_parse_bad_raises": "select date_parse(o_orderstatus, '%Y') from orders",
    "hamming_lengths_raises": "select hamming_distance(n_name, 'PERU') from nation",
    "upper_lower_trim": "select upper(n_name), lower(n_name), trim(concat('  ', n_name, ' ')), "
                        "ltrim(concat('  ', n_name)), rtrim(concat(n_name, '  ')), length(n_comment) "
                        "from nation order by n_nationkey",
    "regexp_group_missing": "select regexp_extract(n_name, 'A(N)?', 1), regexp_count(n_comment, 'e') "
                            "from nation order by n_nationkey",
    "json_scalars": "select json_extract_scalar('{\"a\": [true, 1.5, \"s\", null]}', '$.a[0]'), "
                    "json_extract_scalar('{\"a\": [true, 1.5]}', '$.a[1]'), "
                    "json_extract_scalar('{\"a\": {\"b\": 1}}', '$.a'), "
                    "json_extract_scalar('not json', '$.a'), "
                    "json_array_length('[1, [2, 3]]'), json_array_length('{\"a\": 1}')",
    "varbinary_hashes": "select c_mktsegment, min(to_hex(md5(to_utf8(c_name)))), "
                        "max(to_hex(sha256(to_utf8(c_name)))), sum(length(to_utf8(c_name))) "
                        "from customer group by 1 order by 1",
}


@pytest.mark.parametrize("name", sorted(REFERENCE_SQL) + sorted(
    n for n in MORE_SQL if not n.endswith("_raises")))
def test_sql_equals_reference(both, name):
    sql = REFERENCE_SQL.get(name) or MORE_SQL[name]
    rows = both.check(sql)
    assert rows, f"{name}: no rows"


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


@pytest.mark.parametrize("name", sorted(REFERENCE_RAISES) + sorted(
    n for n in MORE_SQL if n.endswith("_raises")))
def test_failure_raises_the_same_class(both, name):
    _raises_alike(both, REFERENCE_RAISES.get(name) or MORE_SQL[name])


def test_deferred_errors_name_their_code(both):
    for sql, code in ((REFERENCE_RAISES["from_hex_live_bad_entry"], "INVALID_FUNCTION_ARGUMENT"),
                      (MORE_SQL["negative_shift_raises"], "INVALID_FUNCTION_ARGUMENT"),
                      ("select mod(n_nationkey, n_regionkey) from nation", "DIVISION_BY_ZERO")):
        ref, got = _raises_alike(both, sql)
        assert ref.code == got.code == code


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_are_kept(both, name):
    ref, got = _raises_alike(both, REFUSED[name])
    assert isinstance(got, NotImplementedError)


@pytest.mark.parametrize("sql", [
    "select cardinality(array[1, 2]) from nation",
    "select element_at(array[n_nationkey], 1) from nation",
    "select row(n_nationkey, n_name)[1] from nation",
    "select transform(array[1, 2], x -> x + 1) from nation",
])
def test_nested_functions_match_reference(both, sql):
    assert both.check(sql)


# ------------------------------------------------------ the repaired faults
COALESCE_FAULT = {
    # (the SQL, the same with CASE WHEN ... IS NULL, which the reference gets right)
    "coalesce_literal": (
        "select coalesce(case when n_nationkey = 18 then null else n_name end, 'ZZZ') "
        "from nation where n_nationkey between 17 and 19 order by n_nationkey",
        "select case when (case when n_nationkey = 18 then null else n_name end) is null "
        "then 'ZZZ' else (case when n_nationkey = 18 then null else n_name end) end "
        "from nation where n_nationkey between 17 and 19 order by n_nationkey"),
    "coalesce_two_columns": (
        "select coalesce(case when r_regionkey = 1 then null else r_name end, n_name) "
        "from region, nation where r_regionkey = n_regionkey and n_regionkey = 1 "
        "order by n_nationkey limit 3",
        "select case when (case when r_regionkey = 1 then null else r_name end) is null "
        "then n_name else (case when r_regionkey = 1 then null else r_name end) end "
        "from region, nation where r_regionkey = n_regionkey and n_regionkey = 1 "
        "order by n_nationkey limit 3"),
    "coalesce_nullif": (
        "select coalesce(nullif(n_comment, n_comment), n_name) from nation order by n_nationkey",
        "select case when nullif(n_comment, n_comment) is null then n_name "
        "else nullif(n_comment, n_comment) end from nation order by n_nationkey"),
}


@pytest.mark.parametrize("name", sorted(COALESCE_FAULT))
def test_varchar_coalesce_unifies_dictionaries(both, name):
    """The reference keeps the first argument's dictionary and decodes the
    other arguments' codes against it (PERU, CHINA, ROMANIA for the first
    statement, region names for nation names in the second, comments for
    names in the third); the port merges the dictionaries first, as CASE
    does. Expected: the reference's rows for the CASE form."""
    sql, case_sql = COALESCE_FAULT[name]
    want = both.jax.execute(case_sql).rows
    got = both.torch.execute(sql).rows
    assert_rows_match(got, want, name)
    assert both.torch.execute(case_sql).rows == want
    if name == "coalesce_literal":
        assert got == [("PERU",), ("ZZZ",), ("ROMANIA",)]
    if name == "coalesce_two_columns":
        assert got == [("ARGENTINA",), ("BRAZIL",), ("CANADA",)]


def test_varchar_max_over_no_rows_is_null(both):
    """The reference raises IndexError: it decodes an empty group's code
    before it applies the NULL mask."""
    assert both.torch.execute(
        "select count(*), max(n_name) from nation where n_nationkey < 0").rows == [(0, None)]
    assert both.torch.execute(
        "select count(*), min(n_name), max(n_comment) from nation where n_nationkey > 99"
    ).rows == [(0, None, None)]


def test_grouped_varchar_max_over_all_null_group_is_null(both):
    """The reference raises IndexError here too."""
    got = both.torch.execute(
        "select n_regionkey, max(case when n_nationkey > 100 then n_name end), "
        "min(case when n_regionkey = 1 then n_name end) from nation "
        "group by n_regionkey order by n_regionkey").rows
    assert got == [(0, None, None), (1, None, "ARGENTINA"), (2, None, None),
                   (3, None, None), (4, None, None)]


def test_double_join_key_with_nan_returns_the_sql_rows():
    """0.0 = -0.0, NaN equals nothing: the self-join of 0.0, -0.0, 1.0,
    NaN, NULL gives the four signed-zero pairs and (1.0, 1.0). The
    reference raises ValueError in its dynamic filter (int() of NaN); the
    same table without the NaN gives both packages these rows."""
    b = BothSessions({"catalog": "tpch", "schema": "tiny"})
    vals = [(0.0,), (-0.0,), (1.0,), (float("nan"),), (None,)]
    b.create_table("t", "dn", [("x", "double")], vals)
    b.create_table("t", "dz", [("x", "double")], [v for v in vals if v[0] == v[0]])
    sql = "select a.x, b.x from memory.t.{} a join memory.t.{} b on a.x = b.x order by a.x, b.x"
    got = b.torch.execute(sql.format("dn", "dn")).rows
    assert sorted(got) == sorted([(0.0, 0.0), (0.0, -0.0), (-0.0, 0.0), (-0.0, -0.0), (1.0, 1.0)])
    assert sorted(b.jax.execute(sql.format("dz", "dz")).rows) == sorted(got)
    with pytest.raises(ValueError):
        b.jax.execute(sql.format("dn", "dn"))


# ------------------------------------------------------ nondeterministic
def test_random_rows_range_and_device(both):
    gen = both.torch.generator
    before = gen.get_state().clone()
    rows = both.torch.execute("select random(), l_orderkey from lineitem").rows
    assert len(rows) == both.jax.execute("select count(*) from lineitem").rows[0][0]
    draws = [r[0] for r in rows]
    assert all(0.0 <= v < 1.0 for v in draws) and len(set(draws)) > 0.99 * len(draws)
    assert abs(sum(draws) / len(draws) - 0.5) < 0.01
    assert gen.device == both.torch.device and not torch.equal(gen.get_state(), before)


def test_now_and_current_date_against_the_host_clock(both):
    utc_now = lambda: datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)  # noqa: E731
    t0 = utc_now()
    (row,) = both.torch.execute("select now(), current_date").rows
    t1 = utc_now()
    assert t0 - datetime.timedelta(seconds=2) <= row[0] <= t1 + datetime.timedelta(seconds=2)
    assert row[1] in (t0.date(), t1.date())
    (ref,) = both.jax.execute("select now(), current_date").rows
    assert abs((ref[0] - row[0]).total_seconds()) < 5 and ref[1] == row[1]


def test_default_session_needs_cuda():
    """No fallback: without a GPU the port's default session raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from trino_tpu_torch import Session

    with pytest.raises(RuntimeError, match="CUDA"):
        Session()


# ------------------------------------------------------- phase scalar's SQL
# ``{s}`` is the TPC-H and TPC-DS schema: tiny here, sf1 on the card.
SCALAR = {
    "s_dates": """
select extract(year from l_shipdate) as y, extract(quarter from l_shipdate) as q, count(*),
       sum(extract(month from l_shipdate)), sum(day(l_shipdate)), sum(day_of_week(l_shipdate)),
       sum(day_of_year(l_receiptdate)), sum(week(l_receiptdate)),
       sum(date_diff('day', l_shipdate, l_receiptdate)),
       sum(date_diff('month', l_commitdate, l_receiptdate)),
       sum(date_diff('week', l_receiptdate, l_shipdate)),
       sum(date_diff('year', l_commitdate, date '1998-06-30')),
       min(date_trunc('month', l_shipdate)), max(date_trunc('week', l_receiptdate)),
       min(date_trunc('quarter', l_commitdate)), max(last_day_of_month(l_shipdate))
from tpch.{s}.lineitem group by 1, 2 order by 1, 2""",
    "s_date_strings": """
select date_format(o_orderdate, '%Y-%m') as ym, count(*), min(day_name(o_orderdate)),
       max(month_name(o_orderdate)),
       count_if(date_parse(date_format(o_orderdate, '%Y%m%d'), '%Y%m%d') = o_orderdate)
from tpch.{s}.orders group by 1 order by 1""",
    "s_timestamps": """
select o_orderpriority, count(*),
       sum(date_diff('hour', cast(o_orderdate as timestamp(3)),
                     cast(o_orderdate as timestamp(3)) + interval '90' minute)),
       max(cast(cast(o_orderdate as timestamp(6)) + interval '36' hour as date)),
       min(extract(hour from cast(o_orderdate as timestamp(3)) + interval '5' hour)),
       max(to_unixtime(cast(o_orderdate as timestamp(3)))),
       count_if(cast(o_orderdate as timestamp(3)) < timestamp '1995-06-17 12:00:00'),
       min(cast(cast(o_orderdate as timestamp(3)) + interval '1' month as timestamp(0)))
from tpch.{s}.orders group by 1 order by 1""",
    "s_part_strings": """
select upper(split_part(p_type, ' ', 1)) as t1, count(*), sum(length(p_name)),
       max(reverse(lower(p_brand))), min(replace(p_name, ' ', '_')),
       sum(strpos(p_name, 'green')), count_if(starts_with(p_type, 'PROMO')),
       max(concat('<', trim(p_container), '>')), min(lpad(p_brand, 12, '*')),
       max(rpad(p_mfgr, 20, '.')), min(translate(p_type, 'AEIOU', 'aeiou')),
       max(repeat(substr(p_container, 1, 2), 3))
from tpch.{s}.part group by 1 order by 1""",
    "s_phone_regexp": """
select regexp_extract(c_phone, '^([0-9]+)-', 1) as cc, count(*),
       sum(regexp_count(c_phone, '[0-9]')), count_if(regexp_like(c_phone, '-1[0-9]{{2}}-')),
       max(regexp_replace(c_phone, '([0-9]+)-([0-9]+)', '$2+$1')),
       sum(levenshtein_distance(substr(c_phone, 4, 3), '989')),
       sum(hamming_distance(substr(c_phone, 1, 2), '25')), sum(codepoint(c_mktsegment)),
       max(ltrim(rtrim(concat('  ', c_mktsegment, '  '))))
from tpch.{s}.customer group by 1 order by 1""",
    "s_clerk_json": """
select o_orderstatus, count(*), max(split_part(o_clerk, '#', 2)),
       min(json_extract_scalar(concat('{{"c": "', o_clerk, '"}}'), '$.c')),
       sum(json_array_length(concat('["', o_orderstatus, '", 2]'))),
       count(json_extract_scalar(concat('{{"p": "', o_orderpriority, '"}}'), '$.q')),
       min(lower(o_clerk))
from tpch.{s}.orders group by 1 order by 1""",
    "s_varbinary": """
select c_mktsegment, count(*), min(to_hex(md5(to_utf8(c_name)))),
       max(to_hex(sha256(to_utf8(c_name)))), sum(length(to_utf8(c_name))),
       max(from_utf8(to_utf8(c_address))), min(to_hex(cast(c_phone as varbinary))),
       max(cast(from_hex(to_hex(to_utf8(c_mktsegment))) as varchar))
from tpch.{s}.customer group by 1 order by 1""",
    "s_comment": """
select l_linestatus, count(*), sum(length(l_comment)), count_if(regexp_like(l_comment, 'furious')),
       sum(strpos(l_comment, 'the'))
from tpch.{s}.lineitem group by 1 order by 1""",
    "s_math": """
select l_returnflag, l_linestatus, count(*),
       sum(mod(l_orderkey, 7)), sum(l_partkey % 13), sum(abs(l_quantity - 25)),
       sum(truncate(l_extendedprice, -2)), sum(truncate(l_discount * 100)),
       sum(mod(l_extendedprice, 7.5)), sum(abs(l_orderkey - 3000000)),
       sum(bitwise_and(l_orderkey, 255)), sum(bit_count(l_partkey)),
       sum(bitwise_xor(l_suppkey, l_linenumber)), sum(bitwise_right_shift(l_orderkey, 3)),
       sum(bitwise_left_shift(l_linenumber, 4)), max(bitwise_not(l_suppkey)),
       sum(sin(l_discount)), sum(cos(l_tax)), sum(atan2(l_quantity, l_extendedprice)),
       sum(tanh(l_discount * 10)), sum(cbrt(l_quantity)), sum(log2(l_quantity)),
       sum(degrees(l_tax)), sum(mod(cast(l_extendedprice as double), 7.5e0)),
       sum(log10(l_quantity)), sum(asin(l_discount)), sum(cosh(l_tax))
from tpch.{s}.lineitem group by 1, 2 order by 1, 2""",
    # the repo's TPC-DS generator writes no NULL: an outer join and nullif
    # make them
    "s_ds_nulls": """
select a.ca_state, count(*), count(nullif(c.c_first_name, 'John')),
       sum(coalesce(a.ca_address_sk, -1) % 97), count(a.ca_city),
       max(nullif(c.c_last_name, 'Smith')), sum(abs(coalesce(a.ca_address_sk, 0) - 250)),
       count(coalesce(nullif(c.c_current_hdemo_sk, 5), a.ca_address_sk)),
       count_if(a.ca_zip is null)
from tpcds.{s}.customer c left join (
  select ca_address_sk, ca_city, ca_state, ca_zip from tpcds.{s}.customer_address
  where ca_state < 'M') a on c.c_current_addr_sk = a.ca_address_sk
group by 1 order by 1""",
    # varchar coalesce across two dictionaries; its expected rows are the
    # reference's for the CASE form (REFERENCE_FORM)
    "s_ds_coalesce_dicts": """
select coalesce(a.ca_state, 'none') as st, count(*),
       min(coalesce(a.ca_city, c.c_last_name)),
       max(coalesce(nullif(c.c_first_name, 'John'), c.c_last_name)),
       min(coalesce(a.ca_street_name, 'nowhere'))
from tpcds.{s}.customer c left join (
  select ca_address_sk, ca_city, ca_state, ca_street_name from tpcds.{s}.customer_address
  where ca_state < 'M') a on c.c_current_addr_sk = a.ca_address_sk
group by 1 order by 1""",
}


def _case_form(x, y):
    return f"case when {x} is null then {y} else {x} end"


REFERENCE_FORM = {"s_ds_coalesce_dicts": SCALAR["s_ds_coalesce_dicts"]
                  .replace("coalesce(a.ca_state, 'none')", _case_form("a.ca_state", "'none'"))
                  .replace("coalesce(a.ca_city, c.c_last_name)",
                           _case_form("a.ca_city", "c.c_last_name"))
                  .replace("coalesce(nullif(c.c_first_name, 'John'), c.c_last_name)",
                           _case_form("nullif(c.c_first_name, 'John')", "c.c_last_name"))
                  .replace("coalesce(a.ca_street_name, 'nowhere')",
                           _case_form("a.ca_street_name", "'nowhere'"))}


def scalar_sql(name, scale, reference=False):
    sql = REFERENCE_FORM.get(name, SCALAR[name]) if reference else SCALAR[name]
    return sql.format(s=scale)


@pytest.mark.parametrize("name", list(SCALAR))
def test_scalar_phase_query_at_tiny(both, name):
    ref = both.jax.execute(scalar_sql(name, "tiny", reference=True)).rows
    got = both.torch.execute(scalar_sql(name, "tiny")).rows
    assert ref, name
    assert_rows_match(got, ref, name)


def test_expected_file_matches_queries():
    """The committed SF1 rows carry the SQL the smoke run executes, the
    SQL the reference ran for them, and the session properties."""
    with open(EXPECTED) as f:
        data = json.load(f)
    assert data["scale"] == "sf1" and data["properties"] == {"catalog": "tpch", "schema": "sf1"}
    assert list(data["queries"]) == list(SCALAR)
    for name, entry in data["queries"].items():
        assert entry["sql"] == scalar_sql(name, "sf1")
        assert entry["reference_sql"] == scalar_sql(name, "sf1", reference=True)
        assert entry["rows"] and all(len(r) == len(entry["columns"]) for r in entry["rows"])


def write_expected():
    from trino_tpu.client.session import Session as JaxSession
    from test_torch_tpch import jsonable_rows

    props = {"catalog": "tpch", "schema": "sf1"}
    session = JaxSession(properties=dict(props))
    out = {"scale": "sf1", "properties": props,
           "writer": "trino_tpu (JAX, CPU) via tests/test_torch_scalar_sql.py --write-expected",
           "queries": {}}
    for name in SCALAR:
        ref_sql = scalar_sql(name, "sf1", reference=True)
        w0 = time.perf_counter()
        res = session.execute(ref_sql)
        wall = time.perf_counter() - w0
        out["queries"][name] = {"sql": scalar_sql(name, "sf1"), "reference_sql": ref_sql,
                                "columns": list(res.column_names),
                                "rows": jsonable_rows(res.rows)}
        print(f"{name}: {len(res.rows)} rows in {wall:.1f} s", flush=True)
        with open(EXPECTED, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-expected"]:
        write_expected()
    else:
        sys.exit("usage: python tests/test_torch_scalar_sql.py --write-expected")
