"""The TPC-DS catalog and the analytics queries: q95, q64, their wide
variants, and eight queries over TPC-DS and TPC-H tables that run window
functions, set operations and the statistical and sketch aggregates. This
file runs q95, q95 wide and the four set and aggregate queries through both
Sessions on the CPU at ``tiny``; tests/test_torch_tpcds_q64.py runs q64 and
its wide variant, tests/test_torch_analytics.py the four window queries
(three files, so the xdist ``loadfile`` workers split them). Rows must
match (doubles within the tolerance of tests/test_torch_sql_both.py) and so
must the join tiers each query selects.

Also the writer of the expected rows the GPU smoke run (chip_smoke.py,
phase analytics) compares against at SF1, on a machine without JAX:

    JAX_PLATFORMS=cpu python tests/test_torch_tpcds.py --write-expected

(about five minutes of one CPU, q95 most of it, and several GiB of host
memory for the SF1 tables).
"""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from tpcds_sql import Q64, Q64_WIDE, Q95  # noqa: E402
from test_torch_sql_both import TIERS, BothSessions, assert_rows_match  # noqa: E402

EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "trino_tpu_torch", "testdata", "analytics_sf1_expected.json")

# q95 with the state and company filters dropped, as tests/test_tpcds.py has it
Q95_WIDE = Q95.replace("AND ca_state = 'IL'\n  ", "").replace(
    "AND web_company_name = 'pri'\n  ", "")

# the analytics queries; ``{s}`` is the schema (tiny here, sf1 on the card)
ANALYTICS = {
    # TPC-DS q98's shape: a window over an aggregate
    "w_ds_revenue_share": """
SELECT i_category, i_item_id, sum(ss_list_price * ss_quantity) AS revenue,
       sum(ss_list_price * ss_quantity) * 100
         / sum(sum(ss_list_price * ss_quantity)) OVER (PARTITION BY i_category) AS ratio
FROM tpcds.{s}.store_sales, tpcds.{s}.item, tpcds.{s}.date_dim
WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk AND d_year = 2000
  AND i_category IN ('Sports', 'Books', 'Home')
GROUP BY i_category, i_item_id
ORDER BY i_category, revenue DESC, i_item_id
LIMIT 100""",
    # q70's shape: rank, the top 3 of each partition
    "w_ds_rank_stores": """
SELECT * FROM (
  SELECT s_state, s_store_name, i_category, sum(ss_net_profit) AS profit,
         rank() OVER (PARTITION BY s_state ORDER BY sum(ss_net_profit) DESC) AS rk
  FROM tpcds.{s}.store_sales, tpcds.{s}.store, tpcds.{s}.item
  WHERE ss_store_sk = s_store_sk AND ss_item_sk = i_item_sk
  GROUP BY s_state, s_store_name, i_category) t
WHERE rk <= 3 ORDER BY s_state, rk, s_store_name, i_category""",
    # every lineitem row, one partition an order: running, offset and lag/lead frames
    "w_h_line_running": """
SELECT l_returnflag, count(*) AS n, sum(rn) AS s_rn, sum(run_qty) AS s_run,
       sum(prev_qty) AS s_prev, sum(next_qty) AS s_next, max(roll3) AS m_roll
FROM (SELECT l_returnflag,
        row_number() OVER (PARTITION BY l_orderkey ORDER BY l_linenumber) AS rn,
        sum(l_quantity) OVER (PARTITION BY l_orderkey ORDER BY l_linenumber
          ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS run_qty,
        lag(l_quantity) OVER (PARTITION BY l_orderkey ORDER BY l_linenumber) AS prev_qty,
        lead(l_quantity, 2) OVER (PARTITION BY l_orderkey ORDER BY l_linenumber) AS next_qty,
        sum(l_extendedprice) OVER (PARTITION BY l_orderkey ORDER BY l_linenumber
          ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS roll3
      FROM tpch.{s}.lineitem) t
GROUP BY l_returnflag ORDER BY l_returnflag""",
    # every order: rank, dense_rank, ntile, first_value, percent_rank, cume_dist
    "w_h_order_ranks": """
SELECT o_orderpriority, count(*) AS n, sum(rk) AS s_rk, sum(drk) AS s_drk, sum(tile) AS s_tile,
       max(first_price) AS m_first, min(pr) AS min_pr, max(cd) AS max_cd
FROM (SELECT o_orderpriority,
        rank() OVER (PARTITION BY o_custkey ORDER BY o_totalprice DESC) AS rk,
        dense_rank() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS drk,
        ntile(4) OVER (PARTITION BY o_orderpriority ORDER BY o_totalprice, o_orderkey) AS tile,
        first_value(o_totalprice) OVER (PARTITION BY o_custkey
          ORDER BY o_orderdate, o_orderkey) AS first_price,
        percent_rank() OVER (PARTITION BY o_orderstatus ORDER BY o_totalprice) AS pr,
        cume_dist() OVER (PARTITION BY o_orderstatus ORDER BY o_totalprice) AS cd
      FROM tpch.{s}.orders) t
GROUP BY o_orderpriority ORDER BY o_orderpriority""",
    "s_h_except_intersect": """
SELECT 'air_and_mail' AS k, count(*) AS n
FROM (SELECT l_orderkey FROM tpch.{s}.lineitem WHERE l_shipmode = 'AIR'
      INTERSECT SELECT l_orderkey FROM tpch.{s}.lineitem WHERE l_shipmode = 'MAIL') b
UNION ALL
SELECT 'no_orders', count(*)
FROM (SELECT c_custkey FROM tpch.{s}.customer EXCEPT SELECT o_custkey FROM tpch.{s}.orders) a
ORDER BY k""",
    # q5/q77's shape: UNION ALL of the three sales channels
    "s_ds_channels": """
SELECT channel, count(*) AS n, sum(profit) AS profit
FROM (SELECT 'store' AS channel, ss_net_profit AS profit, ss_sold_date_sk AS dk
      FROM tpcds.{s}.store_sales
      UNION ALL SELECT 'web', ws_net_profit, ws_sold_date_sk FROM tpcds.{s}.web_sales
      UNION ALL SELECT 'catalog', cs_ext_list_price, cs_sold_date_sk
      FROM tpcds.{s}.catalog_sales) x,
     tpcds.{s}.date_dim
WHERE dk = d_date_sk AND d_year = 2000 GROUP BY channel ORDER BY channel""",
    "s_ds_union_distinct": """
SELECT count(*) FROM (SELECT ss_item_sk AS item FROM tpcds.{s}.store_sales
                      UNION SELECT ws_item_sk FROM tpcds.{s}.web_sales
                      UNION SELECT cs_item_sk FROM tpcds.{s}.catalog_sales) u""",
    # every lineitem row: the statistical and sketch aggregates
    "a_h_stats": """
SELECT l_returnflag, l_linestatus,
       stddev(l_extendedprice) AS sd, variance(l_quantity) AS var_q, var_pop(l_discount) AS vp,
       corr(l_quantity, l_extendedprice) AS c, covar_samp(l_quantity, l_extendedprice) AS cv,
       regr_slope(l_extendedprice, l_quantity) AS slope,
       approx_distinct(l_partkey) AS nd, approx_percentile(l_extendedprice, 0.5) AS med,
       max_by(l_orderkey, l_extendedprice) AS mx_o,
       bool_or(l_discount > 0.09) AS any_hi, count_if(l_tax = 0) AS no_tax,
       geometric_mean(l_quantity) AS gm
FROM tpch.{s}.lineitem GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus""",
}

# q95 and q64 run unqualified in a session whose catalog is tpcds
TPCDS_QUERIES = {"q95": Q95, "q95_wide": Q95_WIDE, "q64": Q64, "q64_wide": Q64_WIDE}

# the ORDER BY's columns of queries whose rows can tie on it: a tie group
# is compared as a multiset (q64 orders by some of its columns only)
SORT_KEYS = {"q64": [0, 1, 20, 13, 14, 15, 16, 17],
             "q64_wide": [0, 1, 20, 13, 14, 15, 16, 17]}


def query_sql(name: str, schema: str) -> str:
    if name in TPCDS_QUERIES:
        return TPCDS_QUERIES[name]
    return ANALYTICS[name].format(s=schema).strip()


ALL = list(TPCDS_QUERIES) + list(ANALYTICS)


def props(schema):
    return {"catalog": "tpcds", "schema": schema, "fused_join_pallas": True}


@pytest.fixture(scope="module")
def both():
    return BothSessions(props("tiny"))


def _tie_groups_sorted(rows, keys):
    """Rows in ORDER BY order with each tie group in one canonical order."""
    return sorted(rows, key=lambda r: ([r[k] for k in keys], repr(r)))


def check_tiny(both, name):
    """``name`` at tiny through both Sessions: rows (tie groups of a partial
    ORDER BY as multisets) and join tiers."""
    sql = query_sql(name, "tiny")
    ref, got, jt, tt = both.run(sql)
    if name in SORT_KEYS:
        keys = SORT_KEYS[name]
        assert [[r[k] for k in keys] for r in got] == [[r[k] for k in keys] for r in ref]
        got, ref = _tie_groups_sorted(got, keys), _tie_groups_sorted(ref, keys)
    assert_rows_match(got, ref, name)
    assert tt == jt, f"{name}: join tiers {tt} != the reference's {jt}"
    if name not in ("q95", "q64"):  # the exact filters select no row at tiny
        assert ref, f"{name}: the reference returned no rows at tiny"


@pytest.mark.parametrize("name", ["q95", "q95_wide"] + [
    n for n in ANALYTICS if not n.startswith("w_")])
def test_query_tiny_equals_reference(both, name):
    check_tiny(both, name)


def test_catalog_lists_the_reference_tables():
    from trino_tpu.connector.tpcds import TpcdsConnector as JaxTpcds

    from trino_tpu_torch.connector.registry import default_catalogs

    port = default_catalogs()["tpcds"]
    ref = JaxTpcds()
    assert port.list_schemas() == ref.list_schemas()
    assert port.list_tables("sf1") == ref.list_tables("sf1")
    for table in ref.list_tables("tiny"):
        assert port.table_row_count("sf1", table) == ref.table_row_count("sf1", table)
        assert [(c.name, str(c.type)) for c in port.get_table("tiny", table).columns] == \
            [(c.name, str(c.type)) for c in ref.get_table("tiny", table).columns]


def test_expected_file_matches_queries():
    """The committed SF1 rows carry the SQL and the session the smoke run
    uses, for every query, with the reference's join tiers."""
    with open(EXPECTED) as f:
        data = json.load(f)
    assert data["scale"] == "sf1" and data["properties"] == props("sf1")
    assert list(data["queries"]) == ALL
    for name in ALL:
        entry = data["queries"][name]
        assert entry["sql"] == query_sql(name, "sf1")
        assert entry["sort_keys"] == SORT_KEYS.get(name)
        assert all(len(r) == len(entry["columns"]) for r in entry["rows"])
        assert set(entry["tiers"]) == set(TIERS)
    assert data["queries"]["q95"]["rows"] == [[26, "6304.26", "11925.97"]]


def write_expected():
    import time

    from trino_tpu.client.session import Session as JaxSession
    from trino_tpu.obs import metrics as jax_metrics
    from test_torch_tpch import jsonable_rows

    session = JaxSession(properties=props("sf1"))
    out = {"scale": "sf1", "properties": props("sf1"),
           "writer": "trino_tpu (JAX, CPU) via tests/test_torch_tpcds.py --write-expected",
           "queries": {}}
    for name in ALL:
        sql = query_sql(name, "sf1")
        t0 = {t: jax_metrics.FUSED_JOIN_SELECTIONS.value(t) for t in TIERS}
        w0 = time.perf_counter()
        res = session.execute(sql)
        wall = time.perf_counter() - w0
        tiers = {t: jax_metrics.FUSED_JOIN_SELECTIONS.value(t) - t0[t] for t in TIERS}
        out["queries"][name] = {"sql": sql, "columns": list(res.column_names),
                                "rows": jsonable_rows(res.rows), "tiers": tiers,
                                "sort_keys": SORT_KEYS.get(name)}
        print(f"{name}: {len(res.rows)} rows in {wall:.1f} s, tiers {tiers}", flush=True)
        with open(EXPECTED, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-expected"]:
        write_expected()
    else:
        sys.exit("usage: python tests/test_torch_tpcds.py --write-expected")
