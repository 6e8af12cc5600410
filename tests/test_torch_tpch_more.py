"""TPC-H Q10-Q16 and Q19-Q22 through both Sessions (the rest are in
test_torch_tpch.py), and the executor paths those queries reach: for each
new join or aggregate path of the port, a spy proves that a TPC-H query
runs through it.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_tpch import QUERIES, TorchSession, _props, check_query, run_both  # noqa: E402

from trino_tpu_torch.exec import executor as torch_exec  # noqa: E402
from trino_tpu_torch.ops import aggregate as torch_agg  # noqa: E402
from trino_tpu_torch.ops import expr_lower as torch_expr  # noqa: E402


@pytest.mark.parametrize("q", [10, 11, 12, 13, 14, 15, 16, 19, 20, 21, 22])
def test_tpch_tiny_rows_equal_more(q):
    check_query(q)


# (query, executor path, join type, whether the join carries a residual filter)
PATHS = [
    (13, "expand_join", "left", False),
    (21, "semi_join_filtered", "semi", True),
    (21, "semi_join_filtered", "anti", True),
    (11, "singleton_cross", "inner", True),
    (15, "singleton_cross", "inner", True),
    (22, "singleton_cross", "inner", True),
    (16, "agg_count_distinct", None, None),
]


@pytest.mark.parametrize("q,path,join_type,has_filter", PATHS)
def test_tpch_tiny_reaches_path(monkeypatch, q, path, join_type, has_filter):
    seen = []
    if path == "agg_count_distinct":
        orig = torch_agg.agg_count_distinct

        def spy(*args, **kwargs):
            seen.append((None, None))
            return orig(*args, **kwargs)

        monkeypatch.setattr(torch_agg, path, spy)
    else:
        orig = getattr(torch_exec.Executor, path)

        def spy(self, node, left, right):
            seen.append((node.join_type, node.filter is not None))
            return orig(self, node, left, right)

        monkeypatch.setattr(torch_exec.Executor, path, spy)
    TorchSession(properties=_props(), device="cpu").execute(QUERIES[q])
    assert (join_type, has_filter) in seen


def test_q22_vocabulary_passes(monkeypatch):
    """Q22 lowers ``substring(c_phone, 1, 2)`` in three places (the outer
    filter, the subquery's filter and the projection); each is one host
    pass over the phone vocabulary, whatever the length of its IN list."""
    calls = []
    orig = torch_expr._substring_table

    def spy(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(torch_expr, "_substring_table", spy)
    TorchSession(properties=_props(), device="cpu").execute(QUERIES[22])
    assert len(calls) == 3


# joins no TPC-H query has: (sql, join type, residual filter, rows, rows
# with a NULL build side)
EXPAND_JOINS = [
    # a left M:N join whose residual filter reads both sides: the passing
    # matches plus one null-build row for each probe row without one
    ("select c_custkey, o_orderkey, o_totalprice from customer "
     "left join orders on c_custkey = o_custkey and o_totalprice < c_acctbal * 20 "
     "where c_custkey < 60 order by c_custkey, o_orderkey", "left", True, 248, 25),
    # joins without keys whose build is not a scalar subquery: every probe
    # row by every build row
    ("select n_name, r_name from nation, region order by 1, 2", "inner", False, 125, 0),
    ("select n_name, r_name from nation cross join region "
     "where n_regionkey < r_regionkey order by 1, 2", "inner", True, 50, 0),
]


@pytest.mark.parametrize("sql,join_type,has_filter,rows,null_build", EXPAND_JOINS)
def test_expand_join_rows_equal(monkeypatch, sql, join_type, has_filter, rows, null_build):
    seen = []
    orig = torch_exec.Executor.expand_join

    def spy(self, node, left, right):
        seen.append((node.join_type, node.filter is not None))
        return orig(self, node, left, right)

    monkeypatch.setattr(torch_exec.Executor, "expand_join", spy)
    ref, got, jt, tt = run_both(sql)
    assert seen == [(join_type, has_filter)]
    assert len(ref) == rows
    assert sum(r[1] is None for r in ref) == null_build
    assert got == ref
    assert tt == jt
