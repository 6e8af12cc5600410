"""The port's prepared plans (trino_tpu_torch/server/prepared.py and the
coordinator's EXECUTE path) against the JAX package's, on the CPU.

``bind_plan_parameters``, ``plan_cache_sql`` and the registry run through
both packages on the same statements (the bound plans canonicalize to the
same text). The coordinator cases of the reference's
tests/test_prepared_statements.py run on a port CPU cluster beside a JAX
CPU cluster, comparing rows, dispositions and counter deltas: one
parameterized plan a type signature (the second EXECUTE is a plan-cache
hit with no parse, analyze, plan or optimize span), the result cache keyed
by the bound values, the bind errors, DML through EXECUTE, a concurrent
EXECUTE storm and the dbapi module's ``?`` route. Then TPC-H Q6 and Q17
with ``?`` for their constants: the warm EXECUTE is a plan-cache hit and
its rows equal the plain SELECT's.

Left out by name: ``test_system_prepared_statements_table_and_metrics``'s
system-table half, which tests/test_torch_system_catalog.py holds (its
metric half is kept), and the parse and local-session cases, which
tests/test_torch_statements.py holds.
"""
import os
import sys
import threading

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_query_cache import (  # noqa: E402,F401  (clusters is a fixture)
    CLIENT_TIMEOUT, both, clusters, on_clusters)
from tpch_sql import QUERIES  # noqa: E402


def _last_query(coord):
    return coord.queries[sorted(coord.queries)[-1]]


def _span_names(coord):
    return {s["name"] for s in _last_query(coord).tracer.to_dicts()}


# ------------------------------------------------- the bind pass (unit)
BIND_CASES = (
    ("select o_orderkey, o_totalprice from orders where o_orderkey = ?", ("7",)),
    ("select count(*), sum(o_totalprice) from orders where o_orderdate < ? "
     "and o_totalprice > ?", ("date '1995-03-15'", "1000.0")),
    ("select n_name from nation where n_regionkey = ? or n_name like ? order by 1",
     ("2", "'A%'")),
    ("select l_orderkey, sum(l_quantity) from lineitem where l_quantity > ? "
     "group by l_orderkey having sum(l_quantity) > ? order by 2 desc limit 3", ("45", "250")),
)


def _bind(pkg, sql, args):
    from importlib import import_module

    root = "trino_tpu" if pkg.name == "jax" else "trino_tpu_torch"
    prep = import_module(f"{root}.server.prepared")
    expr_analyzer = import_module(f"{root}.sql.analyzer.expr_analyzer")
    optimizer = import_module(f"{root}.sql.planner.optimizer")
    planner = import_module(f"{root}.sql.planner.planner")
    session = pkg.session()
    stmt = pkg.parser.parse_statement(sql)
    reg = prep.PreparedStatementRegistry()
    ps = reg.put("anonymous", "p", stmt, sql)
    execute = pkg.parser.parse_statement("execute p using " + ", ".join(args))
    values = prep.fold_execute_args(execute.params)
    prep.check_arity(ps, values)
    ptypes = tuple(c.type for c in values)
    with expr_analyzer.parameter_types(ptypes):
        proot = optimizer.optimize(planner.Planner(session).plan(stmt), session)
    bound = prep.bind_plan_parameters(proot, values)
    canon = pkg.plan_key.canonicalize_plan
    before = canon(proot)
    literal = sql
    for a in args:
        literal = literal.replace("?", a, 1)
    out = [ps.param_count, ps.plan_cache_sql(ptypes), prep.plan_has_parameters(proot),
           prep.plan_has_parameters(bound), canon(bound), before,
           session.execute(literal).rows]
    assert canon(proot) == before  # the parameterized plan was not written
    assert out[2] and not out[3]
    return out


@pytest.mark.parametrize("sql,args", BIND_CASES, ids=[f"case{i}" for i in range(len(BIND_CASES))])
def test_bind_plan_parameters_matches_reference(sql, args):
    both(_bind, sql, args)


def _registry_per_user_bound(pkg):
    from importlib import import_module

    root = "trino_tpu" if pkg.name == "jax" else "trino_tpu_torch"
    prep = import_module(f"{root}.server.prepared")
    reg = prep.PreparedStatementRegistry(max_statements=64, max_per_user=8)
    stmt = pkg.parser.parse_statement("select 1")
    a = reg.put("alice", "keep", stmt, "select 1")
    for i in range(20):
        reg.put("bob", f"b{i}", stmt, "select 1")
    bobs = sorted(e.name for e in reg.snapshot() if e.user == "bob")
    assert reg.get("alice", "keep") is a
    assert bobs == sorted(f"b{i}" for i in range(12, 20))
    return [len(reg), bobs]


def test_registry_per_user_bound_protects_other_users():
    both(_registry_per_user_bound)


# ----------------------------------------------------- the coordinator cases
def tiny(ctx, **props):
    return ctx.client(catalog="tpch", schema="tiny", result_cache_enabled="false", **props)


def second_execute_skips_parse_analyze_plan(ctx):
    c = tiny(ctx)
    ctx.run(c, "PREPARE zp FROM select o_orderkey, o_totalprice from orders "
               "where o_orderkey = ?")
    h0, m0 = ctx.M.PLAN_CACHE_HITS.value(), ctx.M.PLAN_CACHE_MISSES.value()
    plan_spans = {"parse", "analyze/plan", "optimize", "prepare/bind", "plan-cache/hit"}
    out = [c.prepared_statements["zp"]]
    for k in (7, 7, 32):
        out += [ctx.run(c, f"EXECUTE zp USING {k}")[0], sorted(_span_names(ctx.coord) & plan_spans)]
    out += [ctx.M.PLAN_CACHE_HITS.value() - h0, ctx.M.PLAN_CACHE_MISSES.value() - m0,
            ctx.run(c, "select o_orderkey, o_totalprice from orders where o_orderkey = 32")[0]]
    assert out[2] == ["analyze/plan", "optimize", "prepare/bind"]
    assert out[4] == out[6] == ["plan-cache/hit", "prepare/bind"]
    assert out[3] == out[1] and out[5] != out[1] and out[5][0][0] == 32
    assert out[7:9] == [2, 1] and out[9] == out[5]
    return out


def execute_matches_unprepared_across_types(ctx):
    c = tiny(ctx)
    ctx.run(c, "PREPARE tm FROM select count(*), sum(o_totalprice) from orders "
               "where o_orderdate < ? and o_totalprice > ?")
    out = [ctx.run(c, "EXECUTE tm USING date '1995-03-15', 1000.0")[0],
           ctx.run(c, "select count(*), sum(o_totalprice) from orders where o_orderdate < "
                      "date '1995-03-15' and o_totalprice > 1000.0")[0]]
    assert out[0] == out[1]
    return out


def result_cache_keys_on_bound_values(ctx):
    c = ctx.client()
    ctx.run(c, "create table rc_pt (k bigint, v varchar)")
    ctx.run(c, "insert into rc_pt values (1, 'one'), (2, 'two')")
    ctx.run(c, "PREPARE rcq FROM select v from rc_pt where k = ?")
    out = [ctx.run(c, f"EXECUTE rcq USING {k}") for k in (1, 1, 2, 2, 1)]
    ctx.run(c, "insert into rc_pt values (3, 'three')")
    out.append(ctx.run(c, "EXECUTE rcq USING 1"))
    assert [d for _, d in out] == ["MISS", "HIT", "MISS", "HIT", "HIT", "MISS"]
    assert out[0][0] == [("one",)] and out[2][0] == [("two",)]
    return out


def prepared_nondeterministic_bypasses_result_cache(ctx):
    c = ctx.client(catalog="tpch", schema="tiny")
    ctx.run(c, "PREPARE nd FROM select random() < ?, count(*) from region")
    out = [ctx.run(c, "EXECUTE nd USING 0.5")[1]]
    assert out == ["BYPASS"]
    return out


def bind_errors_are_loud(ctx):
    err = ctx.pkg.remote.RemoteQueryError
    c = tiny(ctx)
    ctx.run(c, "PREPARE be FROM select o_orderkey from orders where o_orderkey = ?")
    out = []
    for sql, match in (("EXECUTE be", "expects 1 parameters"),
                       ("EXECUTE be USING 1, 2", "expects 1 parameters"),
                       ("EXECUTE be USING random()", "constant"),
                       ("EXECUTE be USING 'not-a-key'", None),
                       ("EXECUTE never_prepared USING 1", "not found"),
                       ("DEALLOCATE PREPARE never_prepared", "not found")):
        with pytest.raises(err, match=match):
            c.execute(sql, timeout=CLIENT_TIMEOUT)
        out.append(sql)
    return out


def deallocate_round_trip(ctx):
    c = tiny(ctx)
    ctx.run(c, "PREPARE dr FROM select 1")
    out = ["dr" in c.prepared_statements, ctx.run(c, "EXECUTE dr")]
    ctx.run(c, "DEALLOCATE PREPARE dr")
    out.append("dr" in c.prepared_statements)
    with pytest.raises(ctx.pkg.remote.RemoteQueryError, match="not found"):
        c.execute("EXECUTE dr", timeout=CLIENT_TIMEOUT)
    assert out == [True, ([(1,)], "BYPASS"), False]
    return out


def bind_metric_counts_each_execute(ctx):
    c = tiny(ctx)
    _, _, n0 = ctx.M.EXECUTE_BIND_SECONDS.snapshot()
    ctx.run(c, "PREPARE sysq FROM select o_orderkey from orders where o_orderkey = ?")
    ctx.run(c, "EXECUTE sysq USING 7")
    ctx.run(c, "EXECUTE sysq USING 7")
    _, _, n1 = ctx.M.EXECUTE_BIND_SECONDS.snapshot()
    with pytest.raises(ctx.pkg.remote.RemoteQueryError):
        c.execute("EXECUTE sysq USING 1, 2, 3", timeout=CLIENT_TIMEOUT)
    entry = ctx.coord.prepared.get("anonymous", "sysq")
    out = [n1 - n0, entry.param_count, entry.executions, ctx.M.PREPARED_STATEMENTS.value() >= 1]
    ctx.run(c, "DEALLOCATE PREPARE sysq")
    assert out == [2, 1, 2, True]
    return out


def prepared_statements_partition_by_user(ctx):
    import time

    ctx.coord.submit("PREPARE mine FROM select 1", {}, user="alice")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and ctx.coord.prepared.get("alice", "mine") is None:
        time.sleep(0.05)
    out = [ctx.coord.prepared.get("alice", "mine") is not None]
    with pytest.raises(ctx.pkg.remote.RemoteQueryError, match="not found"):
        tiny(ctx).execute("EXECUTE mine", timeout=CLIENT_TIMEOUT)
    assert out == [True]
    return out


def prepared_insert_binds_and_mutates(ctx):
    c = ctx.client(result_cache_enabled="false")
    ctx.run(c, "create table pdml (a bigint, b varchar)")
    ctx.run(c, "PREPARE pins FROM insert into pdml values (?, ?)")
    ctx.run(c, "EXECUTE pins USING 1, 'x'")
    ctx.run(c, "EXECUTE pins USING 2, 'y'")
    out = [ctx.run(c, "select a, b from pdml order by a")[0]]
    with pytest.raises(ctx.pkg.remote.RemoteQueryError, match="constant"):
        c.execute("EXECUTE pins USING random(), 'z'", timeout=CLIENT_TIMEOUT)
    out.append(ctx.run(c, "select count(*) from pdml")[0])
    assert out == [[(1, "x"), (2, "y")], [(2,)]]
    return out


def concurrent_execute_storm(ctx):
    ctx.run(tiny(ctx), "PREPARE storm FROM select o_orderkey, count(*) from orders "
                       "where o_orderkey = ? group by o_orderkey")
    keys = (1, 2, 3, 4, 5, 6, 7, 32)
    errors = []

    def run_one(ti):
        c = tiny(ctx)
        for r in range(6):
            k = keys[(ti + r) % len(keys)]
            try:
                rows, _ = ctx.run(c, f"EXECUTE storm USING {k}")
                assert rows == [(k, 1)], f"binding {k} got {rows}"
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errors.append(str(e))

    threads = [threading.Thread(target=run_one, args=(ti,)) for ti in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    out = [errors, ctx.coord.prepared.get("anonymous", "storm") is not None]
    assert out == [[], True]
    return out


def dbapi_qmark_routes_through_prepare_execute(ctx):
    conn = ctx.pkg.dbapi.connect(coordinator_url=ctx.coord.base_url)
    cur = conn.cursor()
    sql = "select o_orderkey, o_totalprice from orders where o_orderkey = ?"
    cur.execute(sql, (7,))
    out = [cur.fetchall()]
    known = dict(conn._client.prepared_statements)
    cur.execute(sql, (32,))
    out += [conn._client.prepared_statements == known, cur.fetchall()[0][0],
            sorted(n[:6] for n in known)]
    assert out[0][0][0] == 7 and out[1:] == [True, 32, ["dbapi_"]]
    return out


def dbapi_executemany_loops_one_prepared_plan(ctx):
    conn = ctx.pkg.dbapi.connect(coordinator_url=ctx.coord.base_url, catalog="memory",
                                 schema="default")
    cur = conn.cursor()
    cur.execute("create table dbm (a bigint, b varchar)")
    cur.executemany("insert into dbm values (?, ?)", [(1, "a"), (2, "b"), (3, "c")])
    cur.execute("select count(*) from dbm")
    out = [cur.fetchone(), len([n for n in conn._client.prepared_statements
                               if n.startswith("dbapi_")])]
    assert out == [(3,), 1]
    return out


@pytest.mark.parametrize("scenario", [
    second_execute_skips_parse_analyze_plan, execute_matches_unprepared_across_types,
    result_cache_keys_on_bound_values, prepared_nondeterministic_bypasses_result_cache,
    bind_errors_are_loud, deallocate_round_trip, bind_metric_counts_each_execute,
    prepared_statements_partition_by_user, prepared_insert_binds_and_mutates,
    concurrent_execute_storm, dbapi_qmark_routes_through_prepare_execute,
    dbapi_executemany_loops_one_prepared_plan], ids=lambda f: f.__name__)
def test_coordinator_prepared(clusters, scenario):
    on_clusters(clusters, scenario)


# ------------------------------------------------- TPC-H Q6 and Q17 with ?
TPCH_PARAMS = {
    6: (("date '1994-01-01'", "0.06 - 0.01", "0.06 + 0.01", "< 24"),
        ("?", "?", "?", "< ?"), ("date '1994-01-01'", "0.05", "0.07", "24")),
    17: (("'Brand#23'", "'MED BOX'"), ("?", "?"), ("'Brand#23'", "'MED BOX'")),
}


@pytest.mark.parametrize("q", sorted(TPCH_PARAMS))
def test_warm_tpch_execute_is_a_plan_cache_hit(clusters, q):
    """EXECUTE of Q6 / Q17 with ``?`` twice on the port's cluster: the
    second is a plan-cache hit (no analyze or optimize span), and both give
    the plain SELECT's rows; the JAX cluster gives the same rows."""
    literals, marks, args = TPCH_PARAMS[q]
    sql = QUERIES[q]
    for lit, mark in zip(literals, marks):
        assert lit in sql
        sql = sql.replace(lit, mark, 1)
    execute = f"EXECUTE tq{q} USING " + ", ".join(args)

    def scenario(ctx):
        c = tiny(ctx)
        ctx.run(c, f"PREPARE tq{q} FROM {sql}")
        plain = ctx.run(c, QUERIES[q])[0]
        h0 = ctx.M.PLAN_CACHE_HITS.value()
        cold = ctx.run(c, execute)[0]
        warm = ctx.run(c, execute)[0]
        names = _span_names(ctx.coord)
        out = [plain, ctx.M.PLAN_CACHE_HITS.value() - h0,
               sorted(names & {"analyze/plan", "optimize", "plan-cache/hit"})]
        assert cold == warm == plain
        assert out[1:] == [1, ["plan-cache/hit"]]
        return out

    on_clusters(clusters, scenario)
