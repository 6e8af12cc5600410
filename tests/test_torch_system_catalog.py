"""The port's system catalog (trino_tpu_torch/connector/system/,
server/system_tables.py) and the coordinator's observability routes, held
against the JAX package on the CPU.

The cases of the reference's tests/test_system_catalog.py run through both
packages. The units use both Sessions: CALL parsing, provider-less tables,
the metrics rows, the history ring's retention, the two-part fallback and
the determinism gate. The cluster cases run the same SQL against a port CPU
cluster and a JAX CPU cluster (two in-process workers each). These must be
exactly equal: every system table's column list, the active count of
``system.runtime.nodes``, ``kill_query``'s messages and guards, the
uncachable reason text, and the key sets of the trace, profile and flows
payloads. The span names of TPC-H Q3's trace must also be equal, and the
flow link classes and owners of Q3.

A running query is held RUNNING with ``slow_injection`` (every task sleeps)
until ``kill_query`` fails it. The system-table halves of the reference's
dispatch, prepared-statement, resource-group and materialized-view tests
run here too (``system.runtime.serving``, ``prepared_statements``,
``resource_groups``, ``queries``, ``system.metadata.materialized_views``),
and chip_smoke.py's phase observe at ``tiny``.
"""
import json
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_obs_common import (BOTH, JAX, Q3_SQL, TINY, TORCH, both_clusters,  # noqa: E402
                              client, drain, get_json, new_session, query, span_names,
                              submit, wait_terminal)

SYSTEM_SCHEMAS = [("metadata",), ("metrics",), ("runtime",)]
RUNTIME_TABLES = [("compiles",), ("device_cache",), ("kernels",), ("memory",), ("nodes",),
                  ("prepared_statements",), ("queries",), ("resource_groups",), ("serving",),
                  ("stragglers",), ("tasks",), ("transfers",)]


def _both(fn):
    got, want = fn(TORCH), fn(JAX)
    assert got == want
    return got


# ----------------------------------------------------------------- units
def test_call_statement_parses():
    def case(pkg):
        parser = __import__(f"{pkg.root}.sql.parser.parser", fromlist=["parse_statement"])
        stmt = parser.parse_statement("call system.runtime.kill_query('q1', 'too slow')")
        stmt2 = parser.parse_statement("call runtime.noop()")
        return type(stmt).__name__, stmt.name, len(stmt.args), stmt2.name, stmt2.args

    assert _both(case) == ("Call", ("system", "runtime", "kill_query"), 2,
                           ("runtime", "noop"), ())


def test_call_unknown_procedure_errors():
    def case(pkg):
        with pytest.raises(ValueError, match="procedure") as e:
            new_session(pkg).execute("call tpch.tiny.nothing()")
        return str(e.value)

    _both(case)


def test_schemas_tables_and_columns_equal_the_reference():
    assert TORCH.system.SYSTEM_TABLES == JAX.system.SYSTEM_TABLES
    assert TORCH.system.SYSTEM_PROCEDURES == JAX.system.SYSTEM_PROCEDURES

    def case(pkg):
        s = new_session(pkg)
        out = {}
        for (schema, table) in sorted(pkg.system.SYSTEM_TABLES):
            out[(schema, table)] = s.execute(
                f"select * from system.{schema}.{table} where false").column_names
            out[(schema, table, "describe")] = s.execute(
                f"describe system.{schema}.{table}").rows
        return out

    cols = _both(case)
    assert all(c for c in cols.values())


def test_provider_less_system_tables():
    def case(pkg):
        s = new_session(pkg)
        rows = (s.execute("show schemas from system").rows,
                s.execute("show tables from system.runtime").rows,
                s.execute("select * from system.runtime.queries").rows,
                s.execute("select * from system.runtime.tasks").rows)
        pkg.M.QUERY_SECONDS.observe(0.1, "FINISHED")
        one = s.execute("select name, type from system.metrics where name = "
                        "'trino_tpu_query_seconds_count' and labels = 'state=\"FINISHED\"'").rows
        a = s.execute("select count(*) from system.metrics").rows[0][0]
        b = s.execute("select count(*) from system.metrics.metrics").rows[0][0]
        assert a >= 1 and abs(a - b) <= 2
        return rows, [tuple(r) for r in one]

    (schemas, tables, qrows, trows), one = _both(case)
    assert schemas == SYSTEM_SCHEMAS and tables == RUNTIME_TABLES
    assert qrows == trows == [] and one == [("trino_tpu_query_seconds_count", "histogram")]


def test_metrics_table_expands_histogram_buckets():
    def case(pkg):
        pkg.M.QUERY_SECONDS.observe(0.3, "FINISHED")
        rows = pkg.system.metric_sample_rows()
        names = {r[0] for r in rows}
        bucket = next(r for r in rows if r[0] == "trino_tpu_query_seconds_bucket"
                      and 'le="+Inf"' in (r[2] or "") and 'state="FINISHED"' in (r[2] or ""))
        return ({"trino_tpu_query_seconds_bucket", "trino_tpu_query_seconds_sum",
                 "trino_tpu_query_seconds_count"} <= names, bucket[1], bucket[3] >= 1.0)

    assert _both(case) == (True, "histogram", True)


def test_query_history_ring_retention():
    def case(pkg):
        def entry(i, ended_at):
            return {"queryId": f"q{i}", "state": "FINISHED", "endedAt": ended_at}

        h = pkg.system_tables.QueryHistory()
        old = time.time() - 3600.0
        before = pkg.M.QUERY_HISTORY_EVICTIONS.value()
        for i in range(5):
            h.record(entry(i, old), max_history=3, min_expire_age_ms=1000)
        evicted = pkg.M.QUERY_HISTORY_EVICTIONS.value() - before
        h2 = pkg.system_tables.QueryHistory()
        now = time.time()
        for i in range(5):
            h2.record(entry(i, now), max_history=3, min_expire_age_ms=60_000)
        young = len(h2)
        h2.HARD_CAP = 4
        h2.record(entry(99, now), max_history=3, min_expire_age_ms=60_000)
        return (len(h), evicted, [r["queryId"] for r in h.snapshot()], young, len(h2),
                pkg.system_tables.DEFAULT_MAX_HISTORY,
                pkg.system_tables.DEFAULT_MIN_EXPIRE_AGE_MS)

    assert _both(case)[:5] == (3, 2, ["q4", "q3", "q2"], 5, 4)


def test_two_part_fallback_only_for_declared_catalogs():
    def case(pkg):
        T = __import__(f"{pkg.root}.types", fromlist=["parse_type"])
        planner = __import__(f"{pkg.root}.sql.planner.planner", fromlist=["PlanningError"])
        s = new_session(pkg)
        s.catalogs["memory"].create_table("x", "x", [("v", T.parse_type("bigint"))], [])
        with pytest.raises(planner.PlanningError, match="table not found") as e:
            s.execute("select * from memory.x")
        s.execute("select count(*) from system.metrics")
        return (str(e.value), s.catalogs["system"].single_table_schemas,
                s.catalogs["memory"].single_table_schemas)

    assert _both(case)[1:] == (True, False)


def test_system_scan_is_uncachable():
    def case(pkg):
        det = __import__(f"{pkg.root}.cache.determinism", fromlist=["uncachable_reason"])
        q = __import__(f"{pkg.root}.exec.query", fromlist=["plan_sql"])
        parser = __import__(f"{pkg.root}.sql.parser.parser", fromlist=["parse_statement"])
        s = new_session(pkg)
        sql = "select query_id from system.runtime.queries"
        reason = det.uncachable_reason(parser.parse_statement(sql), q.plan_sql(s, sql))
        return reason, s.catalogs["system"].data_version("runtime", "queries")

    reason, version = _both(case)
    assert "system.runtime.queries" in reason and version is None


def test_query_log_listener_writes_jsonl_and_crashers_are_isolated(tmp_path, monkeypatch):
    out = {}
    for pkg in BOTH:
        log_path = tmp_path / f"{pkg.name}.jsonl"
        monkeypatch.setenv("TRINO_TPU_QUERY_LOG", str(log_path))

        class Crasher(pkg.events.EventListener):
            def query_created(self, event):
                raise RuntimeError("boom on create")

            def query_completed(self, event):
                raise RuntimeError("boom on complete")

        coord = pkg.coordinator.CoordinatorServer(**pkg.kw)
        coord.events.add(Crasher())
        coord.start()
        try:
            q = coord.submit("select count(*) from system.runtime.nodes")
            assert wait_terminal(q, 60.0) == "FINISHED", q.failure
            deadline = time.monotonic() + 10.0
            lines = []
            while time.monotonic() < deadline and not lines:
                if log_path.exists():
                    lines = log_path.read_text().strip().splitlines()
                time.sleep(0.05)
            assert len(lines) == 1
            rec = json.loads(lines[0])
            assert rec["queryId"] == q.query_id and rec["state"] == "FINISHED"
            assert rec["outputRows"] == 1 and rec["error"] is None
            assert rec["wallMs"] >= 0 and rec["spanCount"] > 0
            assert rec["timeline"] is not None
            out[pkg.name] = (sorted(rec), sorted(rec["timeline"]))
        finally:
            coord.stop()
    assert out["torch"] == out["jax"]


# --------------------------------------------- in-process multi-node tier
@pytest.fixture(scope="module")
def clusters():
    yield from both_clusters("sysw")


def test_live_introspection_and_kill_query(clusters):
    """While a distributed query runs, a second session sees it RUNNING in
    system.runtime.queries with its tasks on both workers and the workers
    in system.runtime.nodes; CALL system.runtime.kill_query fails it with
    the given reason, and its tasks are gone (404)."""
    out = {}
    for pkg in BOTH:
        coord = clusters[pkg.name]
        payload = submit(pkg, coord, "select l_returnflag, count(*) from lineitem "
                                     "group by l_returnflag",
                         headers={"X-Trino-Session-catalog": "tpch",
                                  "X-Trino-Session-schema": "tiny",
                                  "X-Trino-Session-slow_injection": "a0:20"})
        qid = payload["id"]
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            info = get_json(pkg, coord, f"/v1/query/{qid}")
            if info["state"] == "RUNNING" and info["queryStats"]["totalSplits"]:
                break
            assert info["state"] not in ("FINISHED", "FAILED", "CANCELED"), info
            time.sleep(0.05)
        else:
            pytest.fail("query never reached RUNNING")
        _cols, rows = query(pkg, coord, "select query_id, state, total_splits, user "
                                        "from system.runtime.queries")
        mine = [r for r in rows if r[0] == qid]
        assert mine and mine[0][1] == "RUNNING" and mine[0][2] > 0
        _cols, trows = query(pkg, coord, f"select task_id, state, worker_uri, total_splits "
                                         f"from system.runtime.tasks where query_id = '{qid}'")
        worker_urls = {n["url"] for n in coord.registry.alive()}
        assert trows and {r[2] for r in trows} == worker_urls
        assert all(r[0].startswith(qid) and r[1] in ("PLANNED", "RUNNING", "FLUSHING",
                                                     "FINISHED") for r in trows)
        assert sum(r[3] for r in trows) == mine[0][2]
        _cols, nrows = query(pkg, coord, "select node_id, http_uri, state, version "
                                         "from system.runtime.nodes where state = 'active'")
        assert {r[0] for r in nrows} == {"sysw0", "sysw1"} and {r[1] for r in nrows} == worker_urls
        version = __import__(pkg.root).__version__
        assert all(r[3] == version for r in nrows)
        _cols, krows = query(pkg, coord,
                             f"call system.runtime.kill_query('{qid}', 'killed by test')")
        assert krows == [[f"killed {qid}"]]
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            info = get_json(pkg, coord, f"/v1/query/{qid}")
            if info["state"] in ("FINISHED", "FAILED", "CANCELED"):
                break
            time.sleep(0.05)
        assert info["state"] == "FAILED" and "killed by test" in (info["failure"] or "")
        _cols, rows = query(pkg, coord, f"select state, failure from system.runtime.queries "
                                        f"where query_id = '{qid}'")
        assert rows and rows[0][0] == "FAILED" and "killed by test" in (rows[0][1] or "")
        # the killed query's tasks were canceled: the workers no longer know them
        q = coord.get_query(qid)
        gone = [pkg.wire.http_request("GET", f"{loc.base_url}/v1/task/{loc.task_id}/status",
                                      timeout=5.0)[0]
                for locs in q.fragment_tasks.values() for loc in locs if loc is not None]
        assert gone and set(gone) == {404}
        out[pkg.name] = (mine[0][1], len(nrows), krows[0][0].replace(qid, "Q"), rows[0][0])
    assert out["torch"] == out["jax"]


def test_kill_query_guards(clusters):
    out = {}
    for pkg in BOTH:
        coord = clusters[pkg.name]
        with pytest.raises(RuntimeError, match="query not found") as e:
            query(pkg, coord, "call system.runtime.kill_query('nope', 'r')")
        q = coord.submit("select count(*) from system.runtime.nodes")
        assert wait_terminal(q, 60.0) == "FINISHED", q.failure
        provider = coord.catalogs["system"]._provider

        class _S:
            query_id = "qX"
            identity = None

        with pytest.raises(ValueError, match="cannot kill the query") as e2:
            provider._kill_query(_S(), "qX", "r")
        already = provider._kill_query(_S(), q.query_id, "r")
        out[pkg.name] = (str(e.value).split("\n")[0].replace("ValueError: ", ""),
                         str(e2.value), already.replace(q.query_id, "Q"))
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == "query Q is already FINISHED"


def test_system_queries_never_admitted_to_caches(clusters):
    out = {}
    for pkg in BOTH:
        coord = clusters[pkg.name]
        coord.query_cache.results.invalidate_all()
        coord.query_cache.plans.invalidate_all()
        sql = "select query_id, state from system.runtime.queries"
        headers = {"X-Trino-Session-result_cache_enabled": "true"}
        for _ in range(2):
            payload = submit(pkg, coord, sql, headers)
            drain(pkg, payload)
            qinfo = get_json(pkg, coord, f"/v1/query/{payload['id']}")
            assert qinfo["cacheStatus"] == "BYPASS"
        reason = next(s["attributes"].get("reason") for s in
                      coord.get_query(payload["id"]).tracer.to_dicts()
                      if s["name"] == "cache/lookup")
        assert len(coord.query_cache.results) == 0
        assert len(coord.query_cache.plans._entries) == 0
        query(pkg, coord, "select count(*) from tpch.tiny.region", headers=headers)
        assert len(coord.query_cache.results) == 1
        out[pkg.name] = reason
    assert out["torch"] == out["jax"] == "live system table system.runtime.queries"


def test_history_ring_covers_finished_queries_and_ui(clusters):
    for pkg in BOTH:
        coord = clusters[pkg.name]
        _cols, rows = query(pkg, coord, "select count(*) from tpch.tiny.nation")
        assert rows == [[25]]
        recs = coord.history.snapshot()
        assert any(r["state"] == "FINISHED" and "nation" in (r["query"] or "") for r in recs)
        _cols, qrows = query(pkg, coord, "select query_id, state, result_rows "
                                         "from system.runtime.queries where state = 'FINISHED'")
        assert qrows and all(r[1] == "FINISHED" for r in qrows)
        status, body, _ = pkg.wire.http_request("GET", f"{coord.base_url}/ui")
        page = body.decode()
        assert status == 200
        assert 'id="recent"' in page and 'href="#recent"' in page and "recent queries" in page
        finished = [r for r in recs if r["state"] == "FINISHED"]
        assert finished and finished[0]["queryId"] in page
    assert sorted(clusters["torch"].history.snapshot()[0]) == sorted(
        clusters["jax"].history.snapshot()[0])


def test_history_retention_properties_cannot_shrink_shared_ring(clusters):
    for pkg in BOTH:
        coord = clusters[pkg.name]
        for i in range(3):
            query(pkg, coord, f"select {i} + 0")
        before = {r["queryId"] for r in coord.history.snapshot()}
        assert len(before) >= 3
        query(pkg, coord, "select 99", headers={
            "X-Trino-Session-query_max_history": "1",
            "X-Trino-Session-query_min_expire_age_ms": "0"})
        assert before <= {r["queryId"] for r in coord.history.snapshot()}


def test_metrics_table_on_coordinator_refreshes_server_gauges(clusters):
    for pkg in BOTH:
        coord = clusters[pkg.name]
        _cols, rows = query(pkg, coord, "select name, labels, value from system.metrics "
                                        "where name in ('trino_tpu_workers', "
                                        "'trino_tpu_queries_total')")
        by_name = {r[0]: r for r in rows}
        assert by_name["trino_tpu_workers"][2] >= 2.0
        assert by_name["trino_tpu_queries_total"][2] >= 1.0
        assert pkg.M.WORKERS.value() == 0


# ------------------------------------------- the payloads across packages
def test_q3_trace_profile_flows_payloads_equal_the_reference(clusters):
    """Q3 through both clusters: the key sets of the trace, profile and
    flows payloads, the trace's span names (each with its count) and the
    flow link classes and owners are equal; the workers' task spans parent
    under the coordinator's schedule span."""
    out = {}
    for pkg in BOTH:
        coord = clusters[pkg.name]
        q = coord.submit(Q3_SQL, dict(TINY))
        assert wait_terminal(q) == "FINISHED", q.failure
        trace = get_json(pkg, coord, f"/v1/query/{q.query_id}/trace")
        traced = get_json(pkg, coord, f"/v1/query/{q.query_id}/trace?recorder=1")
        profile = get_json(pkg, coord, f"/v1/query/{q.query_id}/profile")
        flows = get_json(pkg, coord, f"/v1/query/{q.query_id}/flows")
        names = span_names(trace["root"])
        spans = q.tracer.to_dicts() + q.worker_spans()
        schedule = next(s for s in spans if s["name"] == "schedule")
        tasks = [s for s in spans if s["name"] == "task"]
        assert tasks and {t["parentId"] for t in tasks} == {schedule["spanId"]}
        assert len({t["attributes"]["task_id"] for t in tasks}) == len(tasks)
        out[pkg.name] = {
            "trace": sorted(trace), "traced": sorted(traced), "profile": sorted(profile),
            "flows": sorted(flows), "names": sorted((n, names.count(n)) for n in set(names)),
            "links": {(r["link"], r["owner"].replace(q.query_id, "Q"))
                      for r in flows["transfers"]},
            "span_count": trace["spanCount"] == len(names)}
        status, _, _ = pkg.wire.http_request(
            "GET", f"{coord.base_url}/v1/query/nope/profile", timeout=10.0)
        assert status == 404
    assert out["torch"] == out["jax"]


def test_chip_smoke_phase_observe_at_tiny():
    """chip_smoke.py's phase observe at tiny on the CPU, against the JAX
    Session's rows of Q1, Q3, Q17 and Q18 (the card runs it at SF1 against
    tpch_sf1_expected.json): traffic, traces, flows, the system tables,
    kernel rows, the compile ledger, the caches, kill_query (the victim
    held running by ``slow_injection``), EXPLAIN ANALYZE, OTLP and the CLI."""
    import torch

    from trino_tpu.client.session import Session as JaxSession
    from tpch_sql import QUERIES

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    jax = JaxSession(dict(TINY))
    expected = {str(q): {"sql": QUERIES[q], "rows": chip_smoke.jsonable_rows(
        jax.execute(QUERIES[q]).rows)} for q in (1, 3, 17, 18)}
    with chip_smoke.MergeCapture() as cap:
        out = chip_smoke.phase_observe(torch.device("cpu"), expected, None, None, cap, "cpu",
                                       None, schema="tiny",
                                       kill_props={"slow_injection": "a0:20"})
    assert set(out["trace"]) == {"Q1", "Q3", "Q18"}
    assert out["otlp_spans"] > 0 and out["kill"]["task_statuses"] == [404]
    assert [r[0] for r in out["compiles"]] == ["miss", "hit"]
    assert out["cli"]["summary"].endswith("[cache: HIT]")
    assert all(k["join_rows"] for k in out["kernels"].values())


# ------------- the system-table halves of the serving, prepared and view tests
def test_serving_table_and_dispatch_queue_phase(clusters):
    """The reference's tests/test_dispatch.py case: the queue span and its
    ledger phase, and system.runtime.serving's structures and owners."""
    out = {}
    for pkg in BOTH:
        coord = clusters[pkg.name]
        q = coord.submit("select 7", dict(TINY))
        assert wait_terminal(q) == "FINISHED"
        assert "dispatch/queue" in {s["name"] for s in q.tracer.to_dicts()}
        tl = q.timeline_dict()
        assert tl["phases"]["dispatch-queue"] >= 0.0 and tl["coverage"] >= 0.95
        _cols, rows = query(pkg, coord, "select structure, owner, plane from system.runtime.serving")
        out[pkg.name] = sorted(tuple(r) for r in rows)
    assert out["torch"] == out["jax"]
    assert {"dispatch_queue", "executor_lanes", "serving_index", "result_cache", "plan_cache",
            "prepared_statements", "query_registry", "query_history", "device"} <= {
        r[0] for r in out["torch"]}


def test_prepared_statements_table(clusters):
    """The reference's tests/test_prepared_statements.py system-table half:
    a PREPARE, two EXECUTEs and a failed bind, then DEALLOCATE."""
    out = {}
    for pkg in BOTH:
        c = client(pkg, clusters[pkg.name])
        c.execute("PREPARE sysq FROM select o_orderkey from orders where o_orderkey = ?")
        c.execute("EXECUTE sysq USING 7")
        c.execute("EXECUTE sysq USING 7")
        with pytest.raises(pkg.remote.RemoteQueryError):
            c.execute("EXECUTE sysq USING 1, 2, 3")
        _cols, rows = c.execute("select user, name, parameters, executions "
                                "from system.runtime.prepared_statements where name = 'sysq'")
        c.execute("DEALLOCATE PREPARE sysq")
        _cols, after = c.execute("select name from system.runtime.prepared_statements "
                                 "where name = 'sysq'")
        out[pkg.name] = (rows, after)
    assert out["torch"] == out["jax"] == ([["anonymous", "sysq", 1, 2]], [])


def test_resource_groups_and_queries_tables(clusters):
    """The reference's tests/test_resource_groups.py system-table half: the
    live tree over SQL and the admitting group of a query."""
    out = {}
    for pkg in BOTH:
        coord = clusters[pkg.name]
        q = coord.submit("select count(*) from region", dict(TINY))
        assert wait_terminal(q) == "FINISHED"
        _cols, rows = query(pkg, coord, "select * from system.runtime.resource_groups")
        _cols, group = query(pkg, coord, "select resource_group from system.runtime.queries "
                                         f"where query_id = '{q.query_id}'")
        out[pkg.name] = ([r[0] for r in rows], {len(r) for r in rows}, group)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == {12} and out["torch"][2] == [["global"]]


def test_materialized_views_table(clusters):
    """The reference's tests/test_matview.py system-table half: a view's row
    with live freshness, stale after an INSERT into its base table."""
    out = {}
    for pkg in BOTH:
        c = client(pkg, clusters[pkg.name], {"catalog": "memory", "schema": "default"})
        c.execute("create table smv_t (k bigint, v bigint)")
        c.execute("insert into smv_t values (1, 10), (2, 20)")
        c.execute("create materialized view smv as select k, sum(v) as total from smv_t group by k")
        c.execute("select k, sum(v) as total from smv_t group by k order by k")
        _cols, rows = c.execute("select catalog, schema_name, name, fresh, stale_reason, "
                                "storage_table, hit_count from system.metadata.materialized_views "
                                "where name = 'smv'")
        c.execute("insert into smv_t values (3, 3)")
        _cols, stale = c.execute("select fresh, stale_reason from "
                                 "system.metadata.materialized_views where name = 'smv'")
        c.execute("drop materialized view smv")
        out[pkg.name] = (rows, stale[0][0], "moved" in (stale[0][1] or ""))
    assert out["torch"] == out["jax"]
    assert out["torch"][0][0][:4] == ["memory", "default", "smv", True]
    assert out["torch"][0][0][5] == "memory.default.smv$storage" and out["torch"][1:] == (False, True)
