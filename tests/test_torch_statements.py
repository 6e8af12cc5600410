"""The statement surface of the port against the JAX package, on the CPU:
EXPLAIN and EXPLAIN ANALYZE, PREPARE/EXECUTE/DEALLOCATE, transactions,
SQL routines, table functions, CALL, SET/RESET/SHOW SESSION and SHOW
TABLES/SCHEMAS/COLUMNS, through both Sessions on the same statements.

The cases are those of the reference's tests/test_transactions.py,
test_routines_tvf.py (the local ones), test_prepared_statements.py (the
local ones), test_operator_stats.py (``OperatorStats`` and the local
EXPLAIN ANALYZE header) and test_observability.py (EXPLAIN [ANALYZE] and
the session properties), each run through both packages: rows exact,
plan text exact, ``rows=`` of every plan node exact, and where the
reference raises the port raises the same exception class. Then the
port's own: the two transaction isolation faults of the reference that
the port repairs, the commit conflict check, TPC-H Q17 and Q18 through
EXECUTE and EXPLAIN ANALYZE, EXPLAIN of the 22 TPC-H queries, and the
count of device-to-host reads of a plain query.

Also the writer of the expected data of chip_smoke.py's phase statements,
on a machine without JAX:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_statements.py --write-expected

(several minutes of one CPU and several GiB of host memory: Q17 and Q18
run at SF1).
"""
import json
import os
import re
import sys
import tempfile
import time
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from test_torch_sql_both import assert_rows_match  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402
from trino_tpu import types as JT  # noqa: E402
from trino_tpu.client.session import Session as JaxSession  # noqa: E402
from trino_tpu.exec.executor import Executor as JaxExecutor  # noqa: E402
from trino_tpu.exec.operator_stats import OperatorStats as JaxOperatorStats  # noqa: E402
from trino_tpu.exec.query import plan_sql as jax_plan_sql  # noqa: E402
from trino_tpu.server.prepared import count_parameters as jax_count_parameters  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch import types as TT  # noqa: E402
from trino_tpu_torch.exec.executor import Executor as TorchExecutor  # noqa: E402
from trino_tpu_torch.exec.operator_stats import (  # noqa: E402
    OperatorStats, merge_operator_dicts)
from trino_tpu_torch.exec.query import plan_sql as torch_plan_sql  # noqa: E402
from trino_tpu_torch.exec.transaction import TransactionError  # noqa: E402
from trino_tpu_torch.server.prepared import count_parameters  # noqa: E402
from trino_tpu_torch.sql.parser import ast  # noqa: E402
from trino_tpu_torch.sql.parser.parser import parse_statement  # noqa: E402
from trino_tpu_torch.sql.routines import RoutineError  # noqa: E402

EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "trino_tpu_torch", "testdata", "statements_sf1_expected.json")
TINY = {"catalog": "tpch", "schema": "tiny"}


def jax_session(props=None, **kw):
    return JaxSession(dict(TINY if props is None else props), **kw)


def torch_session(props=None, **kw):
    return TorchSession(dict(TINY if props is None else props), device="cpu", **kw)


# each package as the scenarios below see it
JAX = types.SimpleNamespace(name="jax", session=jax_session, T=JT)
TORCH = types.SimpleNamespace(name="torch", session=torch_session, T=TT)


def observe(session, sql):
    """A statement's rows, or the class name of what it raised."""
    try:
        return session.execute(sql).rows
    except Exception as e:  # noqa: BLE001 — the class is compared
        return type(e).__name__


def plan_lines(text):
    """EXPLAIN ANALYZE text -> (plan lines without the bracketed stats,
    each node's ``rows=``); the header lines (before the first node) are
    dropped."""
    lines = [ln for ln in text.split("\n") if ln.lstrip().startswith("- ")]
    stripped = [ln.split("  [")[0] for ln in lines]
    rows = [int(re.search(r"rows=(\d+)\]", ln).group(1)) for ln in lines]
    return stripped, rows


def explain_text(session, sql):
    return "\n".join(r[0] for r in session.execute(sql).rows)


# ------------------------------------------------------------ transactions
# tests/test_transactions.py, each case a scenario run on both packages


def _acct(pkg, session):
    session.catalogs["memory"].create_table(
        "t", "acct", [("id", pkg.T.BIGINT), ("bal", pkg.T.BIGINT)], [(1, 100), (2, 50)])


def txn_commit_publishes_atomically(pkg, s):
    out = [observe(s, "start transaction"),
           observe(s, "insert into memory.t.acct values (3, 10)"),
           observe(s, "insert into memory.t.acct values (4, 20)"),
           observe(s, "select count(*) from memory.t.acct")]
    # a session over the committed catalogs does not see the writes (the
    # reference's test reaches them through its transaction's saved map,
    # since its overlay sits in the shared one)
    other = pkg.session()
    if pkg.name == "jax":
        other.catalogs["memory"] = s.transaction.saved["memory"]
    else:
        other.catalogs = s.transaction.shared
    out.append(observe(other, "select count(*) from memory.t.acct"))
    out += [observe(s, "commit"), observe(s, "select count(*) from memory.t.acct")]
    assert out[3] == [(4,)] and out[4] == [(2,)] and out[6] == [(4,)]
    return out


def txn_rollback_discards(pkg, s):
    out = [observe(s, sql) for sql in (
        "start transaction", "insert into memory.t.acct values (3, 10)",
        "drop table memory.t.acct", "rollback", "select count(*) from memory.t.acct")]
    assert out[-1] == [(2,)]
    return out


def txn_transactional_ctas_and_drop(pkg, s):
    out = [observe(s, sql) for sql in (
        "start transaction",
        "create table memory.t.big as select id, bal * 2 as b from memory.t.acct",
        "select sum(b) from memory.t.big", "rollback", "select * from memory.t.big")]
    assert out[2] == [(300,)] and isinstance(out[-1], str)
    return out


def txn_nested_transaction_rejected(pkg, s):
    out = [observe(s, sql) for sql in ("start transaction", "start transaction", "rollback")]
    assert isinstance(out[1], str)
    return out


def txn_commit_without_transaction_rejected(pkg, s):
    out = [observe(s, "commit"), observe(s, "rollback")]
    assert out == ["ValueError", "ValueError"]
    return out


def txn_non_transactional_catalog_rejected(pkg, s):
    out = [observe(s, sql) for sql in (
        "start transaction", "create table blackhole.t.x as select 1 as a", "rollback")]
    assert out[1] == "TransactionError"
    return out


def txn_autocommit_insert_is_atomic(pkg, s):
    conn = s.catalogs["memory"]
    before = conn.table_row_count("t", "acct")
    out = [observe(s, "insert into memory.t.acct values (5, 1), (6, 'oops')")]
    _meta, cols = conn._tables[("t", "acct")]
    out += [conn.table_row_count("t", "acct") == before,
            len({len(cd.values) for cd in cols.values()})]
    assert isinstance(out[0], str) and out[1:] == [True, 1]
    return out


def txn_insert_after_drop_in_transaction_errors(pkg, s):
    out = [observe(s, sql) for sql in (
        "start transaction", "drop table memory.t.acct",
        "insert into memory.t.acct values (7, 7)", "rollback",
        "select count(*) from memory.t.acct")]
    assert isinstance(out[2], str) and out[-1] == [(2,)]
    return out


def txn_begin_alias(pkg, s):
    out = [observe(s, sql) for sql in (
        "begin", "insert into memory.t.acct values (9, 9)", "commit",
        "select count(*) from memory.t.acct")]
    assert out[-1] == [(3,)]
    return out


TXN_SCENARIOS = [txn_commit_publishes_atomically, txn_rollback_discards,
                 txn_transactional_ctas_and_drop, txn_nested_transaction_rejected,
                 txn_commit_without_transaction_rejected,
                 txn_non_transactional_catalog_rejected, txn_autocommit_insert_is_atomic,
                 txn_insert_after_drop_in_transaction_errors, txn_begin_alias]


@pytest.mark.parametrize("scenario", TXN_SCENARIOS, ids=lambda f: f.__name__[4:])
def test_transaction_cases(scenario):
    got = []
    for pkg in (JAX, TORCH):
        s = pkg.session()
        _acct(pkg, s)
        got.append(scenario(pkg, s))
        assert s.transaction is None, "the scenario left a transaction open"
    assert got[1] == got[0]


def _shared_pair(pkg):
    """Two sessions over one catalogs map (server mode) and a memory table
    holding one row."""
    a = pkg.session()
    b = pkg.session(catalogs=a.catalogs)
    a.execute("create table memory.t.v (x bigint)")
    a.execute("insert into memory.t.v values (1)")
    return a, b


def test_isolation_no_dirty_read():
    """Session B must not read session A's uncommitted insert. The SQL
    answer is 1; the reference (trino_tpu/exec/transaction.py:193-206
    enters A's overlay into the catalogs map both sessions share) reads 2."""
    answers = {}
    for pkg in (JAX, TORCH):
        a, b = _shared_pair(pkg)
        a.execute("start transaction")
        a.execute("insert into memory.t.v values (2)")
        answers[pkg.name] = (b.execute("select count(*) from memory.t.v").rows,
                             a.execute("select count(*) from memory.t.v").rows)
        a.execute("rollback")
    assert answers["torch"] == ([(1,)], [(2,)])
    assert answers["jax"] == ([(2,)], [(2,)])  # the reference's dirty read


def test_isolation_rollback_keeps_other_sessions_commit():
    """B's autocommit insert during A's transaction survives A's rollback:
    B then reads [1, 3]. The reference puts B's insert into A's overlay
    and loses it on rollback (``_restore``, transaction.py:216-219): [1]."""
    answers = {}
    for pkg in (JAX, TORCH):
        a, b = _shared_pair(pkg)
        a.execute("start transaction")
        a.execute("insert into memory.t.v values (2)")
        b.execute("insert into memory.t.v values (3)")
        a.execute("rollback")
        answers[pkg.name] = b.execute("select x from memory.t.v order by x").rows
    assert answers["torch"] == [(1,), (3,)]
    assert answers["jax"] == [(1,)]  # the reference loses B's committed row


def test_commit_conflict_raises_and_discards():
    """A COMMIT over a table another session changed after this
    transaction first wrote it raises TransactionError and publishes
    nothing (the reference publishes, overwriting B's row)."""
    a, b = _shared_pair(TORCH)
    a.execute("start transaction")
    a.execute("insert into memory.t.v values (2)")
    b.execute("insert into memory.t.v values (3)")
    with pytest.raises(TransactionError, match="memory.t.v"):
        a.execute("commit")
    assert a.transaction is None
    assert a.execute("select x from memory.t.v order by x").rows == [(1,), (3,)]
    # a transaction that does not overlap with another session's write commits
    a.execute("start transaction")
    a.execute("insert into memory.t.v values (4)")
    b.execute("create table memory.t.w (y bigint)")
    a.execute("commit")
    assert b.execute("select x from memory.t.v order by x").rows == [(1,), (3,), (4,)]


def test_transaction_bypasses_the_device_cache():
    """Reads inside a transaction bypass the device cache (an overlay is
    never cached); the read after COMMIT misses and the next one hits."""
    from trino_tpu_torch.obs import metrics as M

    s = torch_session(dict(TINY, device_cache_enabled=True))
    s.execute("create table memory.t.o as select o_orderkey from tpch.tiny.orders "
              "where o_orderkey < 100")
    read = "select count(*) from memory.t.o"

    def disposition():
        h0, m0 = M.DEVICE_CACHE_HITS.value(), M.DEVICE_CACHE_MISSES.value()
        rows = s.execute(read).rows
        return rows, (M.DEVICE_CACHE_HITS.value() - h0, M.DEVICE_CACHE_MISSES.value() - m0)

    [(n,)], _ = disposition()
    s.execute("start transaction")
    s.execute("insert into memory.t.o values (1000000)")
    assert disposition() == ([(n + 1,)], (0, 0))
    s.execute("commit")
    assert disposition() == ([(n + 1,)], (0, 1))
    assert disposition() == ([(n + 1,)], (1, 0))


# ------------------------------------------------------- routines and TVFs
# tests/test_routines_tvf.py, the local cases


ROUTINE_CASES = {
    "udf_inlines_like_handwritten_sql": [
        "create function disc_price(p decimal(12,2), d decimal(12,2)) "
        "returns double return cast(p * (1 - d) as double)",
        "select sum(disc_price(l_extendedprice, l_discount)) from lineitem "
        "where l_orderkey < 100",
        "select sum(cast(l_extendedprice * (1 - l_discount) as double)) from lineitem "
        "where l_orderkey < 100"],
    "udf_nested_and_early_binding": [
        "create function base(x bigint) returns bigint return x + 1",
        "create function outer_fn(x bigint) returns bigint return base(x) * 10",
        "select outer_fn(4)",
        "create or replace function base(x bigint) returns bigint return x + 100",
        "select outer_fn(4)", "select base(4)"],
    "udf_validation_and_lifecycle": [
        "create function bad(x bigint) returns bigint return y + 1",
        "create function f1(x bigint) returns bigint return x",
        "create function f1(x bigint) returns bigint return x",
        "drop function f1", "select f1(1)", "drop function if exists f1",
        "drop function f1"],
    "udf_argument_coercion": [
        "create function halve(x double) returns double return x / 2",
        "select halve(5)"],
    "sequence_table_function": [
        "select count(*), min(sequential_number), max(sequential_number) "
        "from table(sequence(1, 100))",
        "select * from table(sequence(start => 5, stop => 9, step => 2)) as t(n)",
        "select n_name from table(sequence(0, 2)) t join nation "
        "on sequential_number = n_nationkey order by n_name"],
    "sequence_guards": [
        "select * from table(sequence(1, 100000000000))",
        "select * from table(no_such_fn(1))"],
}


def assert_same_observations(got, want):
    """Observations (rows, or the class name of an exception) equal, rows
    under the doubles' tolerance of tests/test_torch_sql_both.py."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, list) and isinstance(g, list):
            assert_rows_match(g, w, f"statement {i}")
        else:
            assert g == w, f"statement {i}: {g} != the reference's {w}"


@pytest.mark.parametrize("case", sorted(ROUTINE_CASES))
def test_routine_and_table_function_cases(case):
    got = {pkg.name: [observe(s, sql) for sql in ROUTINE_CASES[case]]
           for pkg in (JAX, TORCH) for s in [pkg.session()]}
    assert_same_observations(got["torch"], got["jax"])
    out = got["torch"]
    if case == "udf_inlines_like_handwritten_sql":
        assert out[1] == out[2] and isinstance(out[1], list)
    if case == "udf_nested_and_early_binding":
        assert out[2] == out[4] == [(50,)] and out[5] == [(104,)]
    if case == "udf_validation_and_lifecycle":
        assert out[2] == "RoutineError" and out[6] == "ValueError"
    if case == "sequence_table_function":
        assert out[0] == [(100, 1, 100)] and out[1] == [(5,), (7,), (9,)]
    if case == "sequence_guards":
        assert out == ["TableFunctionError", "TableFunctionError"]


def test_routine_error_class_is_the_ports():
    s = torch_session()
    s.execute("create function f1(x bigint) returns bigint return x")
    with pytest.raises(RoutineError):
        s.execute("create function f1(x bigint) returns bigint return x")


def test_connector_table_function_spi():
    """A connector provides catalog-scoped table functions."""
    got = {}
    for pkg in (JAX, TORCH):
        s = pkg.session()
        conn = s.catalogs["tpch"]

        def duplicated(args, named, T=pkg.T):
            return ["v"], [T.BIGINT], [(int(args[0]),), (int(args[0]),)]

        conn.table_function = lambda name, fn=duplicated: fn if name == "dup" else None
        got[pkg.name] = s.execute("select * from table(dup(7))").rows
    assert got["torch"] == got["jax"] == [(7,), (7,)]


def test_udf_q6_is_its_handwritten_form():
    """Q6 with a routine for ``l_extendedprice * l_discount``: the rows of
    Q6, and the plan of the routine's inlined form written by hand."""
    s = torch_session()
    s.execute(Q6_UDF_CREATE)
    assert s.execute(q6_udf_sql()).rows == s.execute(QUERIES[6]).rows
    assert s.explain(q6_udf_sql()) == s.explain(q6_udf_sql(handwritten=True))
    s.execute("drop function rev")
    with pytest.raises(Exception):
        s.execute(q6_udf_sql())


Q6_UDF_CREATE = ("create function rev(p decimal(12,2), d decimal(12,2)) "
                 "returns decimal(24,4) return p * d")


def q6_udf_sql(handwritten=False):
    call = ("cast(cast(l_extendedprice as decimal(12,2)) * cast(l_discount as "
            "decimal(12,2)) as decimal(24,4))" if handwritten
            else "rev(l_extendedprice, l_discount)")
    return QUERIES[6].replace("sum(l_extendedprice * l_discount)", f"sum({call})")


# ------------------------------------------------------ prepared statements
# tests/test_prepared_statements.py, the local cases


def test_parse_prepare_execute_deallocate():
    p = parse_statement("PREPARE q1 FROM select a from t where a = ?")
    assert isinstance(p, ast.Prepare) and p.name == "q1"
    assert isinstance(p.statement, ast.Query)
    e = parse_statement("EXECUTE q1 USING 7, 'x'")
    assert isinstance(e, ast.ExecutePrepared) and e.name == "q1" and len(e.params) == 2
    assert parse_statement("execute q1").params == ()
    d = parse_statement("DEALLOCATE PREPARE q1")
    assert isinstance(d, ast.Deallocate) and d.name == "q1"
    assert isinstance(parse_statement("deallocate q1"), ast.Deallocate)


@pytest.mark.parametrize("sql,n", [
    ("prepare q from select * from t where a = ? and b between ? and ?", 3),
    ("prepare q from select 1", 0),
    ("prepare q from insert into t select ? from u where v in (?, ?, ?)", 4),
])
def test_count_parameters(sql, n):
    from trino_tpu.sql.parser.parser import parse_statement as jax_parse

    assert count_parameters(parse_statement(sql).statement) == n
    assert jax_count_parameters(jax_parse(sql).statement) == n


def test_local_session_bind_arity_both_directions():
    got = {}
    for pkg in (JAX, TORCH):
        s = pkg.session({"catalog": "memory", "schema": "default"})
        out = [observe(s, sql) for sql in (
            "create table pt (a bigint, b varchar)",
            "insert into pt values (1, 'x'), (2, 'y')",
            "prepare p1 from select b from pt where a = ?",
            "execute p1 using 2", "execute p1 using 1", "deallocate prepare p1",
            "execute p1 using 2", "deallocate p1")]
        msgs = []
        s.execute("prepare p1 from select b from pt where a = ?")
        for sql in ("execute p1", "execute p1 using 1, 2"):
            with pytest.raises(ValueError, match="parameter") as e:
                s.execute(sql)
            msgs.append(str(e.value))
        got[pkg.name] = (out, msgs)
    assert got["torch"] == got["jax"]
    assert got["torch"][0][3] == [("y",)]
    assert got["torch"][1] == ["prepared statement expects 1 parameters, got 0",
                               "prepared statement expects 1 parameters, got 2"]


def test_prepared_dml_binds_and_mutates():
    got = {}
    for pkg in (JAX, TORCH):
        s = pkg.session({"catalog": "memory", "schema": "default"})
        out = [observe(s, sql) for sql in (
            "create table pt (a bigint, b varchar)",
            "prepare ins from insert into pt values (?, ?)",
            "execute ins using 1, 'one'", "execute ins using 2, 'two'",
            "prepare upd from update pt set b = ? where a = ?",
            "execute upd using 'uno', 1",
            "select a, b from pt order by a")]
        got[pkg.name] = out
    assert got["torch"] == got["jax"]
    assert got["torch"][-1] == [(1, "uno"), (2, "two")]


# Q17 and Q18 with their constants as parameters, and the spec's bindings
PREPARED_TPCH = {
    17: (QUERIES[17].replace("p_brand = 'Brand#23'", "p_brand = ?")
         .replace("p_container = 'MED BOX'", "p_container = ?"), "'Brand#23', 'MED BOX'"),
    18: (QUERIES[18].replace("having sum(l_quantity) > 300", "having sum(l_quantity) > ?"),
         "300"),
}


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
@pytest.mark.parametrize("q", sorted(PREPARED_TPCH))
def test_tpch_execute_and_explain_analyze_tiny(q, cached):
    """Q17 and Q18 at tiny through PREPARE/EXECUTE and EXPLAIN ANALYZE (cold
    and warm) in both packages: EXECUTE gives the query's rows; EXPLAIN
    ANALYZE gives the reference's plan lines and every node's ``rows=``,
    in the port also with the device cache on (the reference's run is
    uncached)."""
    sql, using = PREPARED_TPCH[q]
    got = {}
    for pkg in (JAX, TORCH):
        props = dict(TINY, fused_join_pallas=True)
        if cached and pkg is TORCH:
            props["device_cache_enabled"] = True
        s = pkg.session(props)
        s.execute(f"prepare p{q} from {sql}")
        executed = s.execute(f"execute p{q} using {using}").rows
        assert executed == s.execute(QUERIES[q]).rows
        got[pkg.name] = (executed, [plan_lines(explain_text(s, "explain analyze " + QUERIES[q]))
                                    for _run in ("cold", "warm")])
    assert_rows_match(got["torch"][0], got["jax"][0], f"Q{q} EXECUTE")
    assert got["torch"][1] == got["jax"][1]


# ------------------------------------------------------------ operator stats
# tests/test_operator_stats.py, the local cases


def test_operator_stats_accumulate_not_overwrite():
    """Re-executing a node adds its rows, bytes and time; both packages'
    stats agree on every count."""
    sql = "select r_regionkey + 1 from region"
    counts = {}
    for name, s, plan, make in (
            ("jax", jax_session(), jax_plan_sql, JaxExecutor),
            ("torch", torch_session(), torch_plan_sql,
             lambda s: TorchExecutor(s, collect_stats=True))):
        root = plan(s, sql)
        ex = make(s)
        ex.execute_checked(root)
        first = {nid: (st.output_rows, st.output_bytes, st.wall_s, st.invocations)
                 for nid, st in ex.node_stats.items()}
        assert first
        ex.execute_checked(root)
        for nid, st in ex.node_stats.items():
            rows0, bytes0, wall0, calls0 = first[nid]
            assert (st.output_rows, st.output_bytes, st.invocations) == \
                (2 * rows0, 2 * bytes0, 2 * calls0)
            assert st.wall_s > wall0
        scan = [st for st in ex.node_stats.values() if st.operator == "TableScan"]
        assert scan and scan[0].input_rows == 10  # 5 region rows x 2 executions
        counts[name] = sorted((st.operator, st.input_rows, st.output_rows, st.output_bytes,
                               st.invocations, st.splits) for st in ex.node_stats.values())
    assert counts["torch"] == counts["jax"]


def test_plain_executor_collects_no_stats():
    """A plain executor collects the per-operator stats the reference's
    does (on by default in both); one made with ``collect_stats=False``,
    the compiled tier's setting, collects none. The kernel ledger holds
    zero-sync rows either way: a launch count and the host wall a node,
    the device time estimated as that wall (test_plain_query_adds_no_host_reads
    counts the reads)."""
    sql = "select count(*) from nation"
    js = jax_session()
    jex = JaxExecutor(js)
    jex.execute_checked(jax_plan_sql(js, sql))
    s = torch_session()
    ex = TorchExecutor(s)
    ex.execute_checked(torch_plan_sql(s, sql))
    assert ex.collect_stats and jex.collect_stats
    assert sorted((st.operator, st.input_rows, st.output_rows, st.invocations)
                  for st in ex.node_stats.values()) == \
        sorted((st.operator, st.input_rows, st.output_rows, st.invocations)
               for st in jex.node_stats.values())
    off = TorchExecutor(s, collect_stats=False)
    off.execute_checked(torch_plan_sql(s, sql))
    assert off.node_stats == {} and not off.collect_stats
    assert ex.kernel_stats and all(
        r["estimated"] and r["deviceS"] == r["wallS"] and r["launches"] == 1
        for r in ex.kernel_stats.values())


def test_kept_executor_holds_no_device_scalar():
    """Once its stats are read, an executor holds its live row counts as
    host ints: one kept after its run (a coordinator query's root or local
    executor) keeps no tensor on the device."""
    s = torch_session()
    ex = TorchExecutor(s)
    ex.execute_checked(torch_plan_sql(s, QUERIES[3]))
    assert ex._row_terms == [] and ex._last_output_rows
    assert all(type(v) is int for v in ex._last_output_rows.values())
    assert sum(st.output_rows for st in ex.node_stats.values()) > 0


def test_operator_stats_add_and_merge():
    fields = dict(input_rows=10, output_rows=4, output_bytes=100, wall_s=0.5,
                  peak_bytes=1000, splits=1, invocations=1)
    other = dict(input_rows=20, output_rows=6, output_bytes=300, wall_s=0.25,
                 peak_bytes=4000, splits=2, invocations=3)
    a, b = OperatorStats(7, "Join", **fields), OperatorStats(7, "Join", **other)
    ja, jb = JaxOperatorStats(7, "Join", **fields), JaxOperatorStats(7, "Join", **other)
    a.add(b)
    ja.add(jb)
    assert (a.input_rows, a.output_rows, a.output_bytes) == (30, 10, 400)
    assert a.wall_s == pytest.approx(0.75)
    assert a.peak_bytes == 4000
    assert (a.splits, a.invocations) == (3, 4)
    assert a.to_dict() == ja.to_dict()
    merged = merge_operator_dicts([[a.to_dict()], [b.to_dict()]])
    assert set(merged) == {7} and merged[7].output_rows == 16
    assert OperatorStats.from_dict(a.to_dict()) == a


HEADER = re.compile(r"Query wall time: ([\d.]+)ms \(planning ([\d.]+)ms, "
                    r"execution ([\d.]+)ms\)")


def test_local_explain_analyze_header_includes_planning():
    for s in (jax_session(), torch_session()):
        first = explain_text(s, "explain analyze select count(*) from region").split("\n")[0]
        m = HEADER.match(first)
        assert m, first
        total, planning, execution = map(float, m.groups())
        assert total == pytest.approx(planning + execution, abs=0.2)


# ------------------------------------------------ EXPLAIN and session props
# tests/test_observability.py


EXPLAIN_CASES = {
    "reports_stats": ("""explain analyze
        select o_orderpriority, count(*) from orders
        where o_orderdate >= date '1995-01-01'
        group by o_orderpriority order by o_orderpriority""", None),
    "shows_spill_and_budget": ("""explain analyze
        select c_custkey, count(o_orderkey) from customer, orders
        where c_custkey = o_custkey group by c_custkey""", 100_000),
    "live_row_counts": ("explain analyze select * from orders where o_orderkey = 7", None),
    "verbose_q3": ("explain analyze verbose " + QUERIES[3], None),
}


@pytest.mark.parametrize("case", sorted(EXPLAIN_CASES))
def test_explain_analyze_cases(case):
    sql, budget = EXPLAIN_CASES[case]
    texts = {}
    for pkg in (JAX, TORCH):
        s = pkg.session()
        if budget is not None:
            s.set_property("query_max_device_memory", budget)
        texts[pkg.name] = explain_text(s, sql)
    text = texts["torch"]
    assert plan_lines(text) == plan_lines(texts["jax"])
    # the header lines and the stats each line carries, with the times cut
    cut = re.compile(r"[\d.]+ms")
    for got, want in zip(text.split("\n"), texts["jax"].split("\n")):
        assert cut.sub("Tms", got) == cut.sub("Tms", want)
    assert "Query wall time:" in text and "wall=" in text
    if case == "reports_stats":
        assert "scanned=" in text and "Aggregation" in text and "TableScan" in text
    if case == "shows_spill_and_budget":
        assert "Device memory budget:" in text and "spilled:" in text and "passes" in text
    if case == "live_row_counts":
        assert "rows=1]" in next(ln for ln in text.split("\n") if "- Filter" in ln)
    if case == "verbose_q3":
        assert "Device detail: staged rows=" in text and "launches=" in text


@pytest.mark.parametrize("q", range(1, 23))
def test_explain_tpch_text_equal(q):
    """EXPLAIN (logical) of each TPC-H query: the reference's text, also
    from a port session with the device cache on."""
    props = dict(TINY, fused_join_pallas=True)
    want = jax_session(props).explain(QUERIES[q])
    assert torch_session(props).explain(QUERIES[q]) == want
    assert torch_session(dict(props, device_cache_enabled=True)).explain(QUERIES[q]) == want


def test_explain_shows_constraint_and_dynamic_filters():
    sql = """explain (type logical)
        select count(*) from lineitem, orders
        where l_orderkey = o_orderkey and o_orderkey < 100"""
    text = explain_text(torch_session(), sql)
    assert text == explain_text(jax_session(), sql)
    assert "constraint=" in text and "dynamic_filters=['l_orderkey']" in text


def test_explain_distributed_and_matviews_not_ported():
    """EXPLAIN (TYPE DISTRIBUTED) is ported since the fragmenter came
    (its text equals the reference's); the materialized-view statements
    used to raise and now run, with the reference's answers
    (tests/test_torch_matview.py holds them in full)."""
    s = torch_session()
    sql = "select n_regionkey, count(*) from nation group by n_regionkey"
    assert s.execute(f"explain (type distributed) {sql}").rows == \
        jax_session().execute(f"explain (type distributed) {sql}").rows
    assert s.explain(sql, mode="distributed") == jax_session().explain(sql, mode="distributed")
    assert "Fragment 0 [source]" in s.explain(sql, mode="distributed")
    js = jax_session()
    for sql in ("create materialized view mv as select 1 a",
                "refresh materialized view mv", "drop materialized view mv"):
        assert s.execute(sql).rows == js.execute(sql).rows
    assert s.matviews.empty() and js.matviews.empty()


SESSION_SQL = ["set session dynamic_filtering_enabled = false", "show session",
               "reset session dynamic_filtering_enabled", "set session no_such_knob = 1",
               "reset session no_such_knob", "set session query_max_device_memory = 1048576",
               "show session", "show schemas", "show schemas from tpcds", "show tables",
               "show tables from tpch.sf1", "show columns from nation",
               "show columns from tpch.tiny.lineitem", "show columns from no_such_table"]


def test_set_show_reset_session():
    got = {}
    for pkg in (JAX, TORCH):
        s = pkg.session()
        got[pkg.name] = [observe(s, sql) for sql in SESSION_SQL]
        if pkg is TORCH:
            s.execute("set session dynamic_filtering_enabled = false")
            assert s.properties["dynamic_filtering_enabled"] is False
            assert TorchExecutor(s).enable_dynamic_filtering is False
            s.execute("reset session dynamic_filtering_enabled")
            assert s.properties["dynamic_filtering_enabled"] is True
    assert got["torch"] == got["jax"]
    by_name = {r[0]: r for r in got["torch"][1]}
    assert by_name["dynamic_filtering_enabled"][1] == "False"
    assert "spill" in by_name["spill_enabled"][4]
    assert got["torch"][3] == "ValueError"


def test_unknown_and_invalid_properties_rejected():
    s = torch_session()
    with pytest.raises(ValueError, match="does not exist"):
        torch_session({"bogus_prop": 1})
    with pytest.raises(ValueError, match="expected integer"):
        s.set_property("query_max_device_memory", "not-a-number")
    with pytest.raises(ValueError, match="positive"):
        s.set_property("target_result_page_rows", 0)


# ----------------------------------------------------------- access control


def test_write_path_checks_access_control():
    """DML and DDL call ``check_can_write`` on the resolved table, in both
    packages: a rule granting only SELECT refuses the write."""
    from trino_tpu.server import security as jax_security

    from trino_tpu_torch.server import security

    got = {}
    for pkg, sec in ((JAX, jax_security), (TORCH, security)):
        rules = [sec.TableRule(users=["reader"], catalog="memory", privileges=("SELECT",)),
                 sec.TableRule(users=["*"])]
        s = pkg.session(identity=sec.Identity("reader"),
                        access_control=sec.RuleBasedAccessControl(rules))
        writer = pkg.session(catalogs=s.catalogs)
        writer.execute("create table memory.t.a (x bigint)")
        got[pkg.name] = [observe(s, sql) for sql in (
            "create table memory.t.b (x bigint)", "insert into memory.t.a values (1)",
            "delete from memory.t.a", "drop table memory.t.a",
            "select count(*) from memory.t.a")]
    assert got["torch"] == got["jax"]
    assert got["torch"] == ["AccessDeniedError"] * 4 + [[(0,)]]


# -------------------------------------------------------------------- CALL


def test_call_procedure():
    got = {}
    for pkg in (JAX, TORCH):
        s = pkg.session()
        calls = []

        def proc(session, *args, calls=calls):
            calls.append(args)
            return f"done {len(args)}"

        conn = s.catalogs["memory"]
        conn.procedure = lambda schema, name, fn=proc: fn if (schema, name) == ("x", "p") else None
        got[pkg.name] = ([observe(s, sql) for sql in (
            "call memory.x.p(1, 'a', 2.5)", "call memory.x.p()",
            "call memory.x.nope(1)", "call nocatalog.x.p(1)",
            "call memory.x.p(n_nationkey)")], calls)
    assert got["torch"] == got["jax"]
    assert got["torch"][0][:2] == [[("done 3",)], [("done 0",)]]
    assert got["torch"][1] == [(1, "a", 2.5), ()]


# ------------------------------------------------- device-to-host reads


def _count_host_reads(monkeypatch):
    """Count the calls that read a tensor back to the host: ``to_numpy``
    of data/page.py (``.cpu()``), ``.item()``, ``.tolist()`` and the
    Python conversions of a tensor."""
    counts = {"n": 0}
    for name in ("item", "tolist", "cpu", "__bool__", "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            counts["n"] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return counts


def test_plain_query_adds_no_host_reads(monkeypatch):
    """Q3 at tiny makes as many device-to-host reads through the port's
    executor with per-operator stats off as through a bare dispatch with no
    stats code at all; the stats, on by default, add one batched read of
    the live counts."""
    from trino_tpu_torch.exec import memory as _mem

    def bare_execute(self, node):
        page = getattr(self, f"_exec_{type(node).__name__}")(node)
        self.memory.observe(_mem.page_bytes(page))
        return page

    s = torch_session(dict(TINY, fused_join_pallas=True))
    root = torch_plan_sql(s, QUERIES[3])
    TorchExecutor(s).execute_checked(root)  # warm the generator caches
    reads = {}
    with monkeypatch.context() as m:
        counts = _count_host_reads(m)
        rows = TorchExecutor(s, collect_stats=False).execute_checked(root).to_pylist()
        reads["plain"] = counts["n"]
        counts["n"] = 0
        stats_ex = TorchExecutor(s)
        assert stats_ex.execute_checked(root).to_pylist() == rows
        reads["stats"] = counts["n"]
        m.setattr(TorchExecutor, "execute", bare_execute)
        counts["n"] = 0
        assert TorchExecutor(s, collect_stats=False).execute_checked(root).to_pylist() == rows
        reads["bare"] = counts["n"]
    assert reads["plain"] == reads["bare"] > 0
    assert reads["stats"] == reads["plain"] + 1
    assert sum(st.output_rows for st in stats_ex.node_stats.values()) > 0


# ---------------------------------------------- phase statements' queries
# The statements chip_smoke.py's phase statements runs, at the scale given.

TXN_CUT = "o_orderdate < date '1992-07-01'"


def txn_sequence(scale):
    """(label, sql) of the transaction steps over a memory copy of a cut of
    ``orders`` (phase statements, step 5)."""
    read = "select count(*), sum(o_totalprice) from memory.stmt.orders"
    return [
        ("ctas", f"create table memory.stmt.orders as select * from tpch.{scale}.orders "
                 f"where {TXN_CUT}"),
        ("read_committed", read),
        ("begin", "start transaction"),
        ("insert", f"insert into memory.stmt.orders select * from tpch.{scale}.orders "
                   "where o_orderdate between date '1998-01-01' and date '1998-01-31'"),
        ("read_in_txn", read),
        ("rollback", "rollback"),
        ("read_after_rollback", read),
        ("begin2", "start transaction"),
        ("insert2", f"insert into memory.stmt.orders select * from tpch.{scale}.orders "
                    "where o_orderdate between date '1998-01-01' and date '1998-01-31'"),
        ("commit", "commit"),
        ("read_after_commit", read),
        ("read_again", read),
    ]


# statements phase step 6 at tiny: (name, sql), every answer the reference's
CONNECTOR_SQL = [
    ("sequence_sum", "select count(*), sum(sequential_number) from table(sequence(1, 1000000))"),
    ("blackhole_create", "create table blackhole.default.sink (k bigint, s varchar)"),
    ("blackhole_ctas", "create table blackhole.default.sink2 as select o_orderkey, o_comment "
                       "from tpch.tiny.orders"),
    ("blackhole_insert", "insert into blackhole.default.sink select o_orderkey, o_clerk "
                         "from tpch.tiny.orders where o_orderkey < 1000"),
    ("blackhole_read", "select count(*) from blackhole.default.sink"),
    ("sqlite_join", "select o.o_orderpriority, count(*), sum(l.l_quantity) "
                    "from sqlite.main.orders o join tpch.tiny.lineitem l "
                    "on l.l_orderkey = o.o_orderkey "
                    "where o.o_orderdate < date '1993-01-01' "
                    "group by o.o_orderpriority order by o.o_orderpriority"),
    ("sqlite_customer_join", "select c.c_mktsegment, count(*) from sqlite.main.customer c "
                             "join sqlite.main.orders o on o.o_custkey = c.c_custkey "
                             "where c.c_nationkey = 7 group by c.c_mktsegment "
                             "order by c.c_mktsegment"),
    ("show_tables", "show tables from sqlite.main"),
    ("show_schemas", "show schemas from tpch"),
    ("show_columns", "show columns from sqlite.main.orders"),
    ("set_session", "set session spill_enabled = false"),
    ("show_session", "show session"),
    ("reset_session", "reset session spill_enabled"),
    ("show_session_after_reset", "show session"),
]
SQLITE_TABLES = ("orders", "customer")


def write_sqlite(path, session, types_mod):
    """Copy tpch.tiny.orders and customer into a sqlite database at
    ``path`` through the sqlite connector's own write path (stdlib
    sqlite3). ``session`` is a Session of either package."""
    from importlib import import_module

    pkg = types_mod.__name__.split(".")[0]
    SqliteConnector = import_module(f"{pkg}.connector.sqlite").SqliteConnector
    conn = SqliteConnector(path)
    for table in SQLITE_TABLES:
        meta = session.catalogs["tpch"].get_table("tiny", table)
        rows = session.execute(f"select * from tpch.tiny.{table}").rows
        conn.create_table("main", table, [(c.name, c.type) for c in meta.columns], rows)
    return conn


def sqlite_scan_line(session):
    """The sqlite scan's line of the sqlite join's EXPLAIN: it carries the
    constraint pushed down into the generated SQL."""
    plan = session.explain(dict(CONNECTOR_SQL)["sqlite_join"])
    return next(ln for ln in plan.split("\n") if "sqlite.main.orders" in ln).strip()


def run_connector_sql(session):
    return [(name, jsonable(observe(session, sql))) for name, sql in CONNECTOR_SQL]


def jsonable(rows):
    if isinstance(rows, str):
        return rows
    return [[v if v is None or isinstance(v, (bool, int, float, str)) else str(v) for v in r]
            for r in rows]


def test_phase_statement_connectors_tiny(monkeypatch):
    """Phase statements' step 6 at tiny through both packages, each over a
    sqlite database it writes itself from tpch.tiny, registered through
    ``TRINO_TPU_SQLITE_DB``; the pushed-down constraint shows in EXPLAIN."""
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for pkg in (JAX, TORCH):
            path = os.path.join(tmp, f"{pkg.name}.db")
            write_sqlite(path, pkg.session(), pkg.T)
            monkeypatch.setenv("TRINO_TPU_SQLITE_DB", path)
            s = pkg.session()
            got[pkg.name] = run_connector_sql(s)
            scan = sqlite_scan_line(s)
            assert "constraint=TupleDomain(o_orderdate" in scan
            got[pkg.name].append(("explain_sqlite_scan", scan))
            inserted = dict(got[pkg.name])["blackhole_insert"][0][0]
            assert s.catalogs["blackhole"].rows_swallowed == 15000 + inserted
    assert got["torch"] == got["jax"]
    answers = dict(got["torch"])
    assert answers["sequence_sum"] == [[1000000, 500000500000]]
    assert answers["blackhole_read"] == [[0]]


def test_phase_statement_transactions_tiny():
    """Phase statements' step 5 at tiny: the port's counts equal the
    reference's run of the same steps in one session."""
    got = {}
    for pkg in (JAX, TORCH):
        s = pkg.session()
        got[pkg.name] = [(label, jsonable(observe(s, sql))) for label, sql in txn_sequence("tiny")]
    assert got["torch"] == got["jax"]
    reads = dict(got["torch"])
    assert reads["read_after_rollback"] == reads["read_committed"]
    assert reads["read_in_txn"] == reads["read_after_commit"] == reads["read_again"]
    assert reads["read_in_txn"][0][0] > reads["read_committed"][0][0]


# ------------------------------------------------------------ the writer


def expected_data(scale="sf1"):
    """The expected data of chip_smoke.py's phase statements, from the JAX
    package on the CPU: EXPLAIN of the 22 TPC-H queries and EXPLAIN ANALYZE
    of Q17 and Q18 at ``scale``, the transaction steps at ``scale``, and
    step 6 at tiny."""
    props = {"catalog": "tpch", "schema": scale, "fused_join_pallas": True}
    s = JaxSession(dict(props))
    out = {"scale": scale, "properties": props,
           "writer": "trino_tpu (JAX, CPU) via tests/test_torch_statements.py --write-expected",
           "explain": {}, "explain_analyze": {}, "prepared": {}}
    for q in range(1, 23):
        out["explain"][str(q)] = {"sql": QUERIES[q], "text": s.explain(QUERIES[q])}
    for q in (17, 18):
        t0 = time.perf_counter()
        lines, rows = plan_lines(explain_text(s, "explain analyze " + QUERIES[q]))
        out["explain_analyze"][str(q)] = {"sql": QUERIES[q], "plan": lines, "rows": rows}
        sql, using = PREPARED_TPCH[q]
        out["prepared"][str(q)] = {"sql": sql, "using": using}
        print(f"Q{q} EXPLAIN ANALYZE at {scale}: {time.perf_counter() - t0:.1f} s", flush=True)
    out["udf"] = {"create": Q6_UDF_CREATE, "sql": q6_udf_sql(),
                  "handwritten_sql": q6_udf_sql(handwritten=True), "drop": "drop function rev"}
    out["transactions"] = [{"label": label, "sql": sql, "rows": jsonable(observe(s, sql))}
                           for label, sql in txn_sequence(scale)]
    saved = os.environ.get("TRINO_TPU_SQLITE_DB")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tpch_tiny.db")
        write_sqlite(path, JaxSession(dict(TINY)), JT)
        os.environ["TRINO_TPU_SQLITE_DB"] = path
        try:
            tiny = JaxSession(dict(TINY))
            out["connectors"] = [{"name": n, "sql": sql, "rows": rows}
                                 for (n, rows), (_, sql) in zip(run_connector_sql(tiny),
                                                                CONNECTOR_SQL)]
            out["sqlite_scan_line"] = sqlite_scan_line(tiny)
        finally:
            if saved is None:
                del os.environ["TRINO_TPU_SQLITE_DB"]
            else:
                os.environ["TRINO_TPU_SQLITE_DB"] = saved
    out["sqlite_tables"] = list(SQLITE_TABLES)
    return out


def write_expected():
    out = expected_data("sf1")
    with open(EXPECTED, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {EXPECTED}", flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-expected"]:
        write_expected()
    else:
        sys.exit("usage: python tests/test_torch_statements.py --write-expected")
