"""The port's materialized views (trino_tpu_torch/matview/) against the JAX
package's (trino_tpu/matview/), on the CPU.

The cases are those of the reference's tests/test_matview.py, each run
through both packages: the embedded cases through both Sessions, the
coordinator cases through a port CPU cluster beside a JAX CPU cluster.
Each compares rows, the substitution notes (the views' hit counts and the
EXPLAIN header ``Materialized view ...: substituted`` or ``fallback``) and
EXPLAIN text. Then the staleness matrix of microbench/matview.py at tiny
(``chip_smoke.staleness_matrix`` on the CPU beside the JAX package's
``run_staleness_matrix``: the same steps, 0 incorrect substitutions), and
chip_smoke.py's phase matview at tiny on the CPU against the JAX package's
answers at tiny.

The process-plane cases ``test_sync_procedure_requires_internal_signature``
(both packages) and ``test_process_plane_registry_replication`` (a port
coordinator with one executor child, rows against the JAX Session) are
here too. Left out by name: ``test_explain_analyze_annotations``
(distributed EXPLAIN ANALYZE, held by tests/test_torch_operator_stats.py;
the embedded EXPLAIN ANALYZE header is held here) and
``test_matview_bench_check`` (a wall-clock gate of the JAX package). Two cases lose a statement over the system
catalog: ``test_create_validation``'s view over ``system.runtime.queries``
and the ``system.metadata.materialized_views`` reads of
``test_coordinator_lifecycle_and_stats``, whose freshness is read from
``staleness_reason`` here; tests/test_torch_system_catalog.py reads the
view's row through SQL on both clusters.

Also the writer of the expected data of chip_smoke.py's phase matview, on
a machine without JAX:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_matview.py --write-expected

(a few minutes of one CPU and several GiB of host memory: the Q3 and Q18
views at SF1).
"""
import json
import os
import sys
import types

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402  (its SQL, the staleness matrix and phase matview)
from test_torch_query_cache import (  # noqa: E402,F401  (clusters is a fixture)
    CLIENT_TIMEOUT, TORCH, both, clusters, on_clusters)
from tpch_sql import QUERIES  # noqa: E402

EXPECTED = os.path.join(os.path.dirname(HERE), "trino_tpu_torch", "testdata",
                        "matview_sf1_expected.json")
MEM = {"catalog": "memory", "schema": "default"}
MV_SQL = "create materialized view mv1 as select k, sum(v) as total from t group by k"
QUERY = "select k, sum(v) as total from t group by k"


def _mod(pkg, path):
    from importlib import import_module

    return import_module(f"{'trino_tpu' if pkg.name == 'jax' else 'trino_tpu_torch'}.{path}")


def _mem_session(pkg, **props):
    s = pkg.session({**MEM, **props})
    s.execute("create table t (k bigint, v bigint)")
    s.execute("insert into t values (1, 10), (2, 20), (1, 30)")
    return s


def _hits(session):
    return sum(mv.hits for mv in session.matviews.snapshot())


def observe(session, sql):
    """(sorted rows, views' hits moved) of one statement, or the class
    name and message of what it raised."""
    h0 = _hits(session)
    try:
        rows = session.execute(sql).rows
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e).split("\n")[0]
    return sorted(rows, key=repr), _hits(session) - h0


# ------------------------------------------------------------------ parser
def _parse(pkg):
    ast, parse = pkg.ast, pkg.parser.parse_statement
    s = parse("create materialized view m.d.v1 as select 1 as x")
    out = [type(s).__name__, s.name, s.not_exists, type(s.query).__name__]
    out.append(parse("create or replace materialized view v1 as select 1 x").or_replace)
    out.append(parse("create materialized view if not exists v1 as select 1 x").not_exists)
    r = parse("refresh materialized view memory.default.v1")
    d = parse("drop materialized view if exists v1")
    out += [type(r).__name__, r.name, type(d).__name__, d.if_exists]
    with pytest.raises(_mod(pkg, "sql.parser.parser").ParseError):
        parse("create materialized view v1 (a bigint)")
    out.append(isinstance(parse("select materialized from t"), ast.Query))
    assert out == ["CreateMaterializedView", ("m", "d", "v1"), False, "Query", True, True,
                   "RefreshMaterializedView", ("memory", "default", "v1"),
                   "DropMaterializedView", True, True]
    return out


# --------------------------------------------------------- embedded cases
def _roundtrip(pkg):
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    mv = s.matviews.snapshot()[0]
    # the match keys (canonical plan text) equal the reference's too
    out = [mv.qualified, mv.storage_qualified, mv.base_versions, mv.column_names,
           [str(t) for t in mv.column_types], mv.canonical, sorted(mv.prefix_canonicals.items()),
           observe(s, QUERY), s.explain(QUERY), observe(s, "select * from mv1")]
    s.execute("drop materialized view mv1")
    out += [s.matviews.empty(), s.catalogs["memory"].get_table("default", "mv1$storage"),
            observe(s, QUERY)]
    assert out[:2] == ["memory.default.mv1", "memory.default.mv1$storage"]
    assert out[7] == ([(1, 40), (2, 20)], 1) and "[mv: memory.default.mv1]" in out[8]
    assert out[10] is True and out[11] is None and out[12] == ([(1, 40), (2, 20)], 0)
    return out


def _validation(pkg):
    s = _mem_session(pkg)
    out = [observe(s, "create materialized view bad as select k, random() as r from t"),
           observe(s, "create materialized view bad as select k, k from t"),
           observe(s, MV_SQL), observe(s, MV_SQL),
           observe(s, "create materialized view if not exists mv1 as select k from t group by k"),
           len(s.matviews.snapshot()[0].column_names),
           observe(s, "create or replace materialized view mv1 as "
                      "select v, count(*) as n from t group by v"),
           s.matviews.snapshot()[0].column_names, observe(s, "select * from mv1")]
    assert "not materializable" in out[0][1] and "uniquely named" in out[1][1]
    assert "already exists" in out[3][1] and out[5] == 2 and out[7] == ("v", "n")
    assert out[8][0] == [(10, 1), (20, 1), (30, 1)]
    return out


def _refresh_on_create_off(pkg):
    s = _mem_session(pkg, materialized_view_refresh_on_create=False)
    s.execute(MV_SQL)
    mv = s.matviews.snapshot()[0]
    out = [mv.base_versions, mv.last_refresh, observe(s, QUERY),
           observe(s, "refresh materialized view mv1"), observe(s, QUERY)]
    assert out[:3] == [None, None, ([(1, 40), (2, 20)], 0)] and out[4] == ([(1, 40), (2, 20)], 1)
    return out


def _missing_view_errors(pkg):
    s = _mem_session(pkg)
    out = [observe(s, "refresh materialized view nope"),
           observe(s, "drop materialized view nope"),
           observe(s, "drop materialized view if exists nope")]
    assert "not found" in out[0][1] and "not found" in out[1][1]
    return out


def _staleness(pkg):
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    out = [observe(s, QUERY)]
    for stmt in ("insert into t values (3, 5)", "update t set v = v + 1 where k = 3",
                 "delete from t where k = 3"):
        s.execute(stmt)
        out += [observe(s, QUERY), observe(s, "refresh materialized view mv1"),
                observe(s, QUERY)]
    s.execute("drop table t")
    s.execute("create table t (k bigint, v bigint)")
    s.execute("insert into t values (7, 7)")
    out += [observe(s, QUERY), observe(s, "refresh materialized view mv1"), observe(s, QUERY)]
    substituted = [o[1] for i, o in enumerate(out) if i % 3 != 2]
    assert substituted == [1, 0, 1, 0, 1, 0, 1, 0, 1]
    assert out[-1] == ([(7, 7)], 1)
    return out


def _out_of_band_storage(pkg):
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    s.catalogs["memory"].insert_rows("default", "mv1$storage", [(9, 9)])
    out = [observe(s, QUERY)]
    s.catalogs["memory"].drop_table("default", "mv1$storage")
    out += [observe(s, QUERY), observe(s, "refresh materialized view mv1"), observe(s, QUERY)]
    assert [o[1] for o in (out[0], out[1], out[3])] == [0, 0, 1]
    return out


def _substitution_off(pkg):
    s = _mem_session(pkg, materialized_view_substitution=False)
    s.execute(MV_SQL)
    out = [observe(s, QUERY), observe(s, "select * from mv1"), s.explain(QUERY)]
    assert out[0] == ([(1, 40), (2, 20)], 0) and out[1][0] == [(1, 40), (2, 20)]
    return out


def _transaction_never_substitutes(pkg):
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    out = [observe(s, "start transaction"), observe(s, QUERY), observe(s, "commit")]
    assert out[1] == ([(1, 40), (2, 20)], 0)
    return out


def _prefix_and_filter_on_top(pkg):
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    mv = s.matviews.snapshot()[0]
    out = [sorted(mv.prefix_canonicals.values()), observe(s, "select k from t group by k"),
           s.explain("select k from t group by k"),
           observe(s, QUERY + " order by total desc limit 1"),
           s.explain(QUERY + " order by total desc limit 1")]
    assert out[0] == [1] and out[1] == ([(1,), (2,)], 1) and out[3] == ([(1, 40)], 1)
    assert "mv1$storage" in out[2] and "['k']" in out[2] and "(prefix 1 columns)" in out[2]
    return out


def _plan_cache_stays_substitution_free(pkg):
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    root = pkg.query.plan_sql(s, QUERY)
    canon = pkg.plan_key.canonicalize_plan(root)
    substitute_plan = _mod(pkg, "matview.substitute").substitute_plan
    sub1, notes1 = substitute_plan(s, root)
    untouched = all(not (isinstance(n, pkg.plan.TableScanNode) and n.mv_name is not None)
                    for n in pkg.plan.walk_plan(root))
    s.execute("insert into t values (9, 9)")
    sub2, notes2 = substitute_plan(s, root)
    out = [notes1, untouched, sub2 is root, notes2, pkg.plan_key.canonicalize_plan(root) == canon,
           pkg.plan_key.canonicalize_plan(sub1)]
    assert notes1[0]["result"] == "substituted" and out[1:3] == [True, True]
    assert notes2[0]["result"] == "stale" and out[4]
    return out


def _mv_over_view_name(pkg):
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    s.execute("create materialized view mv2 as "
              "select total, count(*) as n from mv1 group by total")
    out = [observe(s, "select total, count(*) as n from mv1 group by total")]
    assert out[0][0] == [(20, 1), (40, 1)]
    return out


def _cycle_guard(pkg):
    MaterializedView = _mod(pkg, "matview.registry").MaterializedView
    s = _mem_session(pkg)

    def reg(name, sql):
        s.matviews.put(MaterializedView(
            catalog="memory", schema="default", name=name, definition_sql=sql,
            definition=pkg.parser.parse_statement(sql), owner="t",
            default_catalog="memory", default_schema="default"))

    reg("cyca", "select * from cycb")
    reg("cycb", "select * from cyca")
    out = [observe(s, "select * from cyca")]
    assert "cycle" in out[0][1]
    return out


def _access_control_refires(pkg):
    sec = pkg.security
    rules = sec.RuleBasedAccessControl([
        sec.TableRule(["alice"], privileges=("SELECT", "INSERT")),
        sec.TableRule(["bob"], "memory", "default", "mv1$storage", ("SELECT",)),
    ])
    alice = pkg.session(dict(MEM), identity=sec.Identity("alice"), access_control=rules)
    alice.execute("create table t (k bigint, v bigint)")
    alice.execute("insert into t values (1, 10), (2, 20)")
    alice.execute(MV_SQL)
    out = [observe(alice, QUERY)]
    bob = pkg.session(dict(MEM), identity=sec.Identity("bob"), access_control=rules,
                      catalogs=alice.catalogs, matviews=alice.matviews)
    out += [observe(bob, QUERY)[0], observe(bob, "refresh materialized view mv1")[0]]
    assert out == [([(1, 10), (2, 20)], 1), "AccessDeniedError", "AccessDeniedError"]
    return out


def _access_check_unit(pkg):
    sec = pkg.security
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    mv = s.matviews.snapshot()[0]
    s.access_control = sec.RuleBasedAccessControl(
        [sec.TableRule(["nobody"], privileges=("SELECT",))])
    s.identity = sec.Identity("intruder")
    out = [_mod(pkg, "matview.substitute")._access_denied_reason(s, mv)]
    assert "access denied" in out[0]
    return out


def _or_replace_if_not_exists_rejected(pkg):
    s = _mem_session(pkg)
    out = [observe(s, "create or replace materialized view if not exists "
                      "mv1 as select k from t group by k"), s.matviews.empty()]
    assert "cannot combine" in out[0][1] and out[1]
    return out


def _unreadable_storage_falls_back(pkg):
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    conn = s.catalogs["memory"]
    orig = conn.get_table

    def flaky(schema, table):
        if table.endswith("$storage"):
            raise RuntimeError("storage connector exploded")
        return orig(schema, table)

    conn.get_table = flaky
    try:
        out = [observe(s, QUERY), s.explain(QUERY).split("\n")[0]]
    finally:
        conn.get_table = orig
    out.append(observe(s, QUERY))
    assert out[0] == ([(1, 40), (2, 20)], 0) and out[2] == ([(1, 40), (2, 20)], 1)
    assert "fallback (stale" in out[1]
    return out


def _or_replace_failure_keeps_old(pkg):
    L = _mod(pkg, "matview.lifecycle")
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    stmt = pkg.parser.parse_statement("create or replace materialized view mv1 as "
                                      "select v, count(*) as n from t group by v")

    def boom(_root):
        raise RuntimeError("refresh exploded")

    with pytest.raises(RuntimeError, match="refresh exploded"):
        L.create_materialized_view(s, stmt, execute_fn=boom)
    mv = s.matviews.get("memory", "default", "mv1")
    out = [mv.column_names, observe(s, QUERY)]
    assert out == [("k", "total"), ([(1, 40), (2, 20)], 1)]
    return out


def _fallback_storage_name(pkg):
    s = pkg.session()
    s.execute("create materialized view nv as select n_regionkey, count(*) as n from nation "
              "group by n_regionkey")
    mv = s.matviews.snapshot()[0]
    out = [mv.storage_catalog, mv.storage_table,
           observe(s, "select n_regionkey, count(*) as n from nation group by n_regionkey")]
    assert out == ["memory", "nv$tpch$storage", ([(i, 5) for i in range(5)], 1)]
    return out


def _definition_sql_fallback(pkg):
    L = _mod(pkg, "matview.lifecycle")
    R = _mod(pkg, "matview.registry")
    sql = "-- nightly rollup\ncreate materialized view m as select 1 as x"
    text = L.definition_sql_of(sql)
    mv = R.MaterializedView(catalog="memory", schema="default", name="m", definition_sql=text,
                            definition=pkg.parser.parse_statement(sql).query, owner="t")
    payload = R.to_payload(mv)
    rt = R.from_payload(payload)
    out = [text, type(rt.definition).__name__,
           L.definition_sql_of("create materialized view m as select 1 as x"),
           sorted(k for k in payload if k != "createdAt"), R.drop_payload("m", "d", "x")]
    assert out[0] == sql.strip() and out[1] == "Query" and out[2] == "select 1 as x"
    return out


def _explain_and_explain_analyze(pkg):
    """EXPLAIN text and the EXPLAIN ANALYZE header and plan lines of a
    substituted and a stale query."""
    s = _mem_session(pkg)
    s.execute(MV_SQL)
    fresh = s.explain(QUERY)
    analyze = [r[0] for r in s.execute("explain analyze " + QUERY).rows]
    s.execute("insert into t values (2, 2)")
    stale = s.explain(QUERY)
    analyze_stale = [r[0] for r in s.execute("explain analyze " + QUERY).rows]
    keep = [analyze[0]] + [ln.split("  [")[0] for ln in analyze if ln.lstrip().startswith("- ")]
    keep_stale = [analyze_stale[0]] + [ln.split("  [")[0] for ln in analyze_stale
                                       if ln.lstrip().startswith("- ")]
    assert fresh.startswith("Materialized view memory.default.mv1: substituted\n")
    assert keep[0] == "Materialized view memory.default.mv1: substituted"
    assert "fallback (stale" in stale.split("\n")[0] and "[mv:" not in stale
    return [fresh, keep, stale, keep_stale]


def _q3_shape_at_tiny(pkg):
    """The Q3 view of phase matview at tiny over the tpch catalog: rows,
    EXPLAIN and the fallback with substitution off."""
    s = pkg.session({"catalog": "tpch", "schema": "tiny"})
    sql = chip_smoke.mv_q3() + chip_smoke.MV_Q3_TAIL
    base = s.execute(sql).rows
    s.execute("create materialized view q3rev as " + chip_smoke.mv_q3())
    mv = s.matviews.snapshot()[0]
    out = [base, observe(s, sql), s.explain(sql), mv.canonical,
           sorted(mv.prefix_canonicals.items())]
    s.properties["materialized_view_substitution"] = False
    out.append(observe(s, sql))
    assert out[1] == (sorted(base, key=repr), 1) and out[5] == (sorted(base, key=repr), 0)
    return out


EMBEDDED = [_parse, _roundtrip, _validation, _refresh_on_create_off, _missing_view_errors,
            _staleness, _out_of_band_storage, _substitution_off, _transaction_never_substitutes,
            _prefix_and_filter_on_top, _plan_cache_stays_substitution_free, _mv_over_view_name,
            _cycle_guard, _access_control_refires, _access_check_unit,
            _or_replace_if_not_exists_rejected, _unreadable_storage_falls_back,
            _or_replace_failure_keeps_old, _fallback_storage_name, _definition_sql_fallback,
            _explain_and_explain_analyze, _q3_shape_at_tiny]


@pytest.mark.parametrize("case", EMBEDDED, ids=[f.__name__.lstrip("_") for f in EMBEDDED])
def test_embedded(case):
    both(case)


# ------------------------------------------------------ coordinator cases
def _client(ctx, **props):
    return ctx.pkg.remote.StatementClient(ctx.coord.base_url, {**MEM, **props})


def _run(ctx, c, sql):
    _cols, rows = c.execute(sql, timeout=CLIENT_TIMEOUT)
    return [tuple(r) for r in rows], c.stats.get("mvHits"), c.stats.get("mvNames")


def coordinator_lifecycle_and_stats(ctx):
    c = _client(ctx)
    _run(ctx, c, "create table ct (k bigint, v bigint)")
    _run(ctx, c, "insert into ct values (1, 10), (2, 20)")
    q = "select k, sum(v) as total from ct group by k order by k"
    out = [_run(ctx, c, "create materialized view cmv as "
                        "select k, sum(v) as total from ct group by k"),
           _run(ctx, c, "select k, total from cmv order by k"),
           _run(ctx, _client(ctx), q)]
    staleness = _mod(ctx.pkg, "matview.substitute").staleness_reason
    mv = ctx.coord.matviews.get("memory", "default", "cmv")
    out += [staleness(ctx.coord.catalogs, mv), mv.hits >= 2, mv.storage_qualified]
    _run(ctx, c, "insert into ct values (3, 3)")
    out += [staleness(ctx.coord.catalogs, mv), _run(ctx, c, q),
            _run(ctx, c, "refresh materialized view cmv"), _run(ctx, c, q)]
    _run(ctx, c, "drop materialized view cmv")
    out.append(ctx.coord.matviews.get("memory", "default", "cmv"))
    assert out[1] == ([(1, 10), (2, 20)], 1, ["memory.default.cmv"]) and out[2][1] == 1
    assert out[3] is None and out[4] and "moved" in out[6]
    assert out[7] == ([(1, 10), (2, 20), (3, 3)], 0, None) and out[8][0] == [(3,)]
    assert out[9][1] == 1 and out[10] is None
    return out


def result_cache_coupling(ctx):
    c = _client(ctx, result_cache_enabled="true")
    _run(ctx, c, "create table rt (k bigint, v bigint)")
    _run(ctx, c, "insert into rt values (1, 5)")
    _run(ctx, c, "create materialized view rmv as select k, sum(v) as total from rt group by k")
    sql = "select k, sum(v) as total from rt group by k order by k"
    out = []
    for stmt in (None, None, "refresh materialized view rmv", None, None,
                 "insert into rt values (2, 6)", None):
        if stmt is not None:
            _run(ctx, c, stmt)
            continue
        rows, mv_hits, _names = _run(ctx, c, sql)
        # a HIT plans nothing on the reference's dispatch plane, so its
        # mvHits are compared on the MISSes only
        out.append((rows, c.cache_status, mv_hits if c.cache_status == "MISS" else None))
    _run(ctx, c, "drop materialized view rmv")
    assert [o[1:] for o in out] == [("MISS", 1), ("HIT", None), ("MISS", 1), ("HIT", None),
                                    ("MISS", 0)]
    assert out[-1][0] == [(1, 5), (2, 6)]
    return out


def device_cache_warm_on_refresh(ctx):
    devcache = _mod(ctx.pkg, "devcache")
    c = _client(ctx, device_cache_enabled="true")
    _run(ctx, c, "create table wt (k bigint, v bigint)")
    _run(ctx, c, "insert into wt values (1, 2), (3, 4)")
    warm0 = TORCH.M.MV_WARM_ROWS.value()
    _run(ctx, c, "create materialized view wmv as select k, sum(v) as total from wt group by k")
    entries = {e["table"]: e for e in devcache.DEVICE_CACHE.snapshot()}
    staged_hits = entries["wmv$storage"]["hits"]
    out = [_run(ctx, c, "select k, sum(v) as total from wt group by k order by k"),
           c.stats.get("deviceCacheHits", 0) >= 1]
    entries = {e["table"]: e for e in devcache.DEVICE_CACHE.snapshot()}
    out.append(entries["wmv$storage"]["hits"] - staged_hits)
    _run(ctx, c, "drop materialized view wmv")
    if ctx.pkg is TORCH:
        # the port counts the rows its warm staged (2 groups)
        assert TORCH.M.MV_WARM_ROWS.value() - warm0 == 2
    assert out == [([(1, 2), (3, 4)], 1, ["memory.default.wmv"]), True, 1]
    return out


def prepared_execute_substitutes(ctx):
    c = _client(ctx)
    _run(ctx, c, "create table pt (k bigint, v bigint)")
    _run(ctx, c, "insert into pt values (1, 2), (1, 3), (2, 4)")
    _run(ctx, c, "create materialized view pmv as select k, sum(v) as total from pt group by k")
    _run(ctx, c, "PREPARE pq FROM select k, sum(v) as total from pt group by k order by k")
    out = [_run(ctx, c, "EXECUTE pq")]
    _run(ctx, c, "drop materialized view pmv")
    _run(ctx, c, "DEALLOCATE PREPARE pq")
    assert out == [([(1, 5), (2, 4)], 1, ["memory.default.pmv"])]
    return out


def prepared_mv_ddl_roundtrip(ctx):
    c = _client(ctx)
    _run(ctx, c, "create table pdt (k bigint, v bigint)")
    _run(ctx, c, "insert into pdt values (1, 2), (1, 3), (2, 4)")
    _run(ctx, c, "PREPARE pcm FROM create materialized view pmv2 as "
                 "select k, sum(v) as total from pdt group by k")
    _run(ctx, c, "EXECUTE pcm")
    mv = ctx.coord.matviews.get("memory", "default", "pmv2")
    q = "select k, sum(v) as total from pdt group by k order by k"
    out = [mv is not None and mv.base_versions is not None, mv.definition_sql, _run(ctx, c, q)]
    _run(ctx, c, "insert into pdt values (3, 9)")
    _run(ctx, c, "PREPARE prm FROM refresh materialized view pmv2")
    out += [_run(ctx, c, "EXECUTE prm")[0], _run(ctx, c, q)]
    _run(ctx, c, "PREPARE pdm FROM drop materialized view pmv2")
    _run(ctx, c, "EXECUTE pdm")
    out.append(ctx.coord.matviews.get("memory", "default", "pmv2"))
    for name in ("pcm", "prm", "pdm"):
        _run(ctx, c, f"DEALLOCATE PREPARE {name}")
    assert out[0] and out[2] == ([(1, 5), (2, 4)], 1, ["memory.default.pmv2"])
    assert out[3] == [(3,)] and out[4][1] == 1 and out[5] is None
    return out


def distributed_refresh_over_tpch(ctx):
    """A view over tpch whose refresh runs distributed (tasks on the
    workers), then a SELECT that reads it."""
    c = _client(ctx, catalog="tpch", schema="tiny")
    sql = ("select o_orderpriority, count(*) as n from orders "
           "group by o_orderpriority")
    base = _run(ctx, c, sql + " order by 1")
    t0 = ctx.M.TASKS_TOTAL.value()
    created = _run(ctx, c, "create materialized view opri as " + sql)
    out = [base, created, ctx.M.TASKS_TOTAL.value() - t0 > 0, _run(ctx, c, sql + " order by 1")]
    _run(ctx, c, "drop materialized view opri")
    assert out[2] and out[3] == (base[0], 1, ["tpch.tiny.opri"])
    return out


@pytest.mark.parametrize("scenario", [
    coordinator_lifecycle_and_stats, result_cache_coupling, device_cache_warm_on_refresh,
    prepared_execute_substitutes, prepared_mv_ddl_roundtrip, distributed_refresh_over_tpch],
    ids=lambda f: f.__name__)
def test_coordinator_matview(clusters, scenario):
    on_clusters(clusters, scenario)


# ------------------------------------ the staleness matrix and phase matview
def test_staleness_matrix_at_tiny():
    """microbench/matview.py's staleness matrix through the JAX package and
    its port in chip_smoke.py: the same steps, every fallback bit-identical
    and 0 incorrect substitutions."""
    import microbench.matview as mb

    want = mb.run_staleness_matrix("tiny")
    got = chip_smoke.staleness_matrix(torch.device("cpu"))
    assert got == want
    assert got["incorrect_freshness_substitutions"] == 0 and got["stale_fallback_ok"]


def phase_expected(schema):
    """The JAX package's answers for phase matview at ``schema``: Q3's base
    rows, its view's row count and EXPLAIN text (the view fresh), and the
    join tiers and row count of the Q18 view's refresh (uncached, as eager
    Q18 runs)."""
    from trino_tpu.client.session import Session as JaxSession
    from trino_tpu.obs import metrics as JM

    props = {**chip_smoke.MV_PROPS, "schema": schema}
    s = JaxSession({**props, "device_cache_enabled": True})
    sql = chip_smoke.mv_q3() + chip_smoke.MV_Q3_TAIL
    rows = s.execute(sql).rows
    s.execute("create materialized view q3rev as " + chip_smoke.mv_q3())
    mv = s.matviews.get("tpch", schema, "q3rev")
    view_rows = s.catalogs[mv.storage_catalog].table_row_count(mv.storage_schema,
                                                               mv.storage_table)
    explain = s.explain(sql).split("\n")
    assert s.execute(sql).rows == rows and mv.hits == 2
    eager = JaxSession(dict(props))
    t0 = {t: JM.FUSED_JOIN_SELECTIONS.value(t) for t in chip_smoke.TIERS}
    eager.execute("create materialized view q18agg as " + chip_smoke.MV_Q18_AGG)
    tiers = {t: JM.FUSED_JOIN_SELECTIONS.value(t) - t0[t] for t in chip_smoke.TIERS}
    mv18 = eager.matviews.get("tpch", schema, "q18agg")
    rows18 = eager.catalogs[mv18.storage_catalog].table_row_count(mv18.storage_schema,
                                                                  mv18.storage_table)
    return {"scale": schema, "properties": props,
            "q3": {"sql": sql, "rows": chip_smoke.jsonable_rows(rows), "view_rows": view_rows,
                   "explain": explain},
            "q18": {"sql": chip_smoke.MV_Q18_AGG, "tiers": tiers, "view_rows": rows18}}


def test_phase_matview_at_tiny_on_the_cpu():
    """chip_smoke.py's phase matview, at tiny on the CPU, against the JAX
    package's answers at tiny (and Q18's rows from the JAX Session)."""
    from trino_tpu.client.session import Session as JaxSession

    mvexp = phase_expected("tiny")
    q18 = JaxSession({"catalog": "tpch", "schema": "tiny"}).execute(QUERIES[18]).rows
    expected = {"18": {"sql": QUERIES[18], "rows": chip_smoke.jsonable_rows(q18)}}
    out = chip_smoke.phase_matview(torch.device("cpu"), mvexp, expected,
                                   types.SimpleNamespace(now=None), "cpu", schema="tiny")
    assert out["q3"]["warm_failures"] == 0 and out["q3"]["warmed_rows"] > 0
    assert out["q18"]["tiers"] == mvexp["q18"]["tiers"]
    assert out["staleness"]["incorrect_freshness_substitutions"] == 0


# ------------------------------------------------- executor-process plane
def test_sync_procedure_requires_internal_signature():
    """The replication procedure is not a user surface: an unsigned (or
    wrongly signed) CALL is denied in both packages, so clients cannot
    inject registry entries that would launder access control."""
    import base64

    blob = base64.b64encode(json.dumps(
        {"op": "drop", "catalog": "m", "schema": "d", "name": "x"}).encode()).decode()
    got = {}
    for name in ("jax", "torch"):
        pkg = types.SimpleNamespace(name=name)
        coordinator = _mod(pkg, "server.coordinator")
        wire = _mod(pkg, "server.wire")
        security = _mod(pkg, "server.security")
        registry = _mod(pkg, "matview.registry")
        tables = _mod(pkg, "server.system_tables")
        coord = coordinator.CoordinatorServer.__new__(coordinator.CoordinatorServer)
        coord.matviews = registry.MaterializedViewRegistry()  # no sockets
        proc = tables.CoordinatorSystemTables(coord).procedure(
            "runtime", "sync_materialized_view")
        denied = 0
        for sig in (None, "deadbeef"):
            with pytest.raises(security.AccessDeniedError):
                proc(None, blob, sig)
            denied += 1
        got[name] = (denied, proc(None, blob, wire.sign(blob.encode())))
    assert got["torch"] == got["jax"] == (2, "dropped m.d.x")


@pytest.fixture(scope="module")
def proc_coord(tmp_path_factory):
    """A port coordinator with one executor child, on a fresh filesystem
    catalog root (the view's storage, which the child reads too)."""
    from trino_tpu_torch.server.coordinator import CoordinatorServer

    old = os.environ.get("TRINO_TPU_FS_ROOT")
    os.environ["TRINO_TPU_FS_ROOT"] = str(tmp_path_factory.mktemp("mvlake"))
    coord = CoordinatorServer(device="cpu", executor_plane="process", executor_processes=1)
    coord.start()
    try:
        yield coord
    finally:
        coord.stop()
        if old is None:
            os.environ.pop("TRINO_TPU_FS_ROOT", None)
        else:
            os.environ["TRINO_TPU_FS_ROOT"] = old


def _finished(q, timeout=120.0):
    q.state.wait_for_terminal(timeout)
    assert q.state.get() == "FINISHED", q.failure
    return q


def test_process_plane_registry_replication(proc_coord):
    """CREATE and DROP on the dispatch process replicate the registry to
    the executor process (sync_materialized_view payloads): a sticky-routed
    SELECT substitutes in the child against filesystem storage, and a DROP
    stops it; the rows are the JAX Session's throughout."""
    pytest.importorskip("pyarrow")
    from trino_tpu.client.session import Session as JaxSession

    coord = proc_coord
    props = {"catalog": "tpch", "schema": "tiny", "short_query_fast_path": "true",
             "materialized_view_storage_catalog": "filesystem"}
    sql = "select c_custkey, c_name from customer where c_mktsegment = 'BUILDING'"
    want = [tuple(r) for r in JaxSession({"catalog": "tpch", "schema": "tiny"}).execute(sql).rows]
    # boot and baseline: the broadcast reaches booted children only
    q = _finished(coord.submit(sql, props))
    assert q.plane.startswith("executor-process:")
    assert [tuple(r) for r in q.rows] == want and q.mv_substitutions == []
    _finished(coord.submit("create materialized view tpch.tiny.bld as " + sql, props))
    assert coord.matviews.get("tpch", "tiny", "bld") is not None
    q = _finished(coord.submit(sql, props))
    assert q.plane.startswith("executor-process:"), q.plane
    assert q.mv_substitutions == ["tpch.tiny.bld"]
    assert [tuple(r) for r in q.rows] == want
    _finished(coord.submit("drop materialized view tpch.tiny.bld", props))
    q = _finished(coord.submit(sql, props))
    assert q.plane.startswith("executor-process:")
    assert q.mv_substitutions == []
    assert [tuple(r) for r in q.rows] == want


def write_expected():
    out = phase_expected("sf1")
    out["writer"] = "trino_tpu (JAX, CPU) via tests/test_torch_matview.py --write-expected"
    with open(EXPECTED, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"q3: {len(out['q3']['rows'])} rows, view {out['q3']['view_rows']} rows; "
          f"q18 view {out['q18']['view_rows']} rows, tiers {out['q18']['tiers']}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-expected"]:
        write_expected()
    else:
        sys.exit("usage: python tests/test_torch_matview.py --write-expected")
