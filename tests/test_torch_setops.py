"""UNION [ALL], INTERSECT and EXCEPT through both Sessions on the CPU: the
SQL of tests/test_set_operations.py, and the two semantics that need care
in the port: varchar branches with different dictionaries merge, and NULLs
compare equal in set membership.

Left out: ``test_union_distributed_matches_local`` and
``test_intersect_distributed_matches_local`` (the 8-device SPMD runner is
not ported).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_sql_both import BothSessions  # noqa: E402


@pytest.fixture(scope="module")
def both():
    b = BothSessions({"catalog": "tpch", "schema": "tiny"})
    b.create_table("t", "a", [("k", "bigint"), ("s", "varchar"), ("d", "decimal(12,2)"),
                              ("dt", "date")],
                   [(1, "x", None, None), (2, "y", None, None), (None, "x", None, None),
                    (None, None, None, None), (3, None, None, None), (2, "y", None, None)])
    b.create_table("t", "b", [("k", "bigint"), ("s", "varchar")],
                   [(2, "y"), (None, None), (None, "x"), (4, "zz"), (3, "w")])
    return b


SETOP_SQL = {
    # tests/test_set_operations.py
    "union_all": """select n_name from nation where n_regionkey = 0
        union all
        select n_name from nation where n_regionkey = 0""",
    "union_distinct": """select n_regionkey from nation
        union
        select r_regionkey from region
        order by n_regionkey""",
    "union_type_unification": "select * from (values (1) union all values (2.5)) t(x) order by x",
    "intersect": """select n_nationkey from nation where n_regionkey in (0, 1)
        intersect
        select n_nationkey from nation where n_regionkey in (1, 2)
        order by n_nationkey""",
    "except": """select n_regionkey from nation
        except
        select r_regionkey from region where r_regionkey < 3
        order by n_regionkey""",
    "null_semantics_intersect": "values (1), (null) intersect values (null), (2)",
    "null_semantics_except": "values (1), (null), (null) except values (null)",
    "union_in_subquery": """select count(*) from (
            select n_nationkey as k from nation
            union all
            select r_regionkey as k from region
        ) t""",
    "chained": "select * from (values (1), (2), (3) union values (3), (4) except values (2)) "
               "t(x) order by x",
    # varchar branches with different dictionaries
    "union_all_string_constants": """select channel, count(*), sum(k) from (
            select 'store' as channel, n_nationkey as k from nation
            union all select 'web', r_regionkey from region
            union all select 'catalog', n_regionkey from nation where n_nationkey < 7) x
        group by channel order by channel""",
    "union_varchar_columns": """select n_name from nation where n_regionkey = 1
        union select r_name from region union select c_mktsegment from customer
        order by n_name""",
    "intersect_varchar_dictionaries": """select s from memory.t.a
        intersect select s from memory.t.b order by s""",
    "except_multi_column_nulls": """select k, s from memory.t.a
        except select k, s from memory.t.b order by k, s""",
    "intersect_multi_column_nulls": """select k, s from memory.t.a
        intersect select k, s from memory.t.b order by k, s""",
    "union_distinct_nulls": "select k, s from memory.t.a union select k, s from memory.t.b "
                            "order by k, s",
    "union_decimals_dates": """select o_orderdate, o_totalprice from orders where o_orderkey < 40
        union select o_orderdate, o_totalprice from orders where o_orderkey between 20 and 70
        order by o_orderdate, o_totalprice""",
    "except_tpch_keys": """select count(*) from (select c_custkey from customer
        except select o_custkey from orders) a""",
    "intersect_lineitem_modes": """select count(*) from (
        select l_orderkey from lineitem where l_shipmode = 'AIR'
        intersect select l_orderkey from lineitem where l_shipmode = 'MAIL') b""",
}


@pytest.mark.parametrize("name", sorted(SETOP_SQL))
def test_set_operation_sql_equals_reference(both, name):
    both.check(SETOP_SQL[name])


def test_reference_answers(both):
    """The answers tests/test_set_operations.py asserts, from the port."""
    assert len(both.check(SETOP_SQL["union_all"])) == 10
    assert both.check(SETOP_SQL["union_distinct"]) == [(i,) for i in range(5)]
    assert both.check(SETOP_SQL["except"]) == [(3,), (4,)]
    assert both.check(SETOP_SQL["null_semantics_intersect"]) == [(None,)]
    assert both.check(SETOP_SQL["null_semantics_except"]) == [(1,)]
    assert both.check(SETOP_SQL["union_in_subquery"]) == [(30,)]
    assert both.check(SETOP_SQL["chained"]) == [(1,), (3,), (4,)]
    assert [r[0] for r in both.check(SETOP_SQL["union_all_string_constants"])] == [
        "catalog", "store", "web"]
