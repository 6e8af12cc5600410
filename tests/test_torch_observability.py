"""The port's EXPLAIN ANALYZE, typed session properties and query events,
held against the JAX package on the CPU.

The cases of the reference's tests/test_observability.py go through both
Sessions at ``tiny``. EXPLAIN ANALYZE must print the same annotation kinds
and the same live row counts, and the spill lines must agree. SET, SHOW and
RESET SESSION must give the same rows. Both packages must refuse the same
properties with the same messages, and the executors must read the same
switches. The cases of tests/test_observability_events.py run on a cluster
of each package. The created and completed events fire, a listener's
failure stays isolated, and a FAILED query's event carries its error. The
completed event also carries the phase ledger. ``/v1/metrics`` renders the
coordinator's gauges with the observability plane's series. The live
``?recorder=1`` trace merges the rings, as the reference's
tests/test_flight_recorder.py asks. Last, the CLI: the same stats dicts
and rows through both packages' ``render_summary``, ``render_progress``
and ``format_table``, the reference's ``[cache: HIT]`` summary case, and
``python -m trino_tpu_torch.client.cli --execute`` as a subprocess
against the port's CPU cluster.
"""
import os
import re
import sys
import time
import urllib.request

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_obs_common import (BOTH, JAX, TINY, TORCH, execute, get_json,  # noqa: E402
                              new_session, start_cluster, stop_cluster, wait_terminal)

def _both(fn):
    got, want = fn(TORCH), fn(JAX)
    assert got == want
    return got


def _plan(pkg, sql, **props):
    s = new_session(pkg)
    for k, v in props.items():
        s.set_property(k, v)
    return "\n".join(r[0] for r in s.execute(sql).rows)


def _kinds(text):
    """The annotation kinds of a plan (``wall=``, ``rows=``, ...)."""
    return sorted(set(re.findall(r"\b([a-z_]+)=", text)))


def _rows_of(text):
    return [re.sub(r".*- (\w+).*rows=(\d+).*", r"\1 \2", ln) for ln in text.split("\n")
            if "rows=" in ln and "- " in ln]


def test_explain_analyze_reports_stats():
    sql = ("explain analyze select o_orderpriority, count(*) from orders "
           "where o_orderdate >= date '1995-01-01' group by o_orderpriority "
           "order by o_orderpriority")

    def case(pkg):
        text = _plan(pkg, sql)
        assert "Query wall time:" in text and "scanned=" in text
        assert "Aggregation" in text and "TableScan" in text
        return _kinds(text), _rows_of(text)

    _both(case)


def test_explain_analyze_shows_spill_and_budget():
    sql = ("explain analyze select c_custkey, count(o_orderkey) from customer, orders "
           "where c_custkey = o_custkey group by c_custkey")

    def case(pkg):
        text = _plan(pkg, sql, query_max_device_memory=100_000)
        assert "Device memory budget:" in text and "spilled:" in text and "passes" in text
        return ([ln.split(":")[0] for ln in text.split("\n") if ":" in ln and "- " not in ln],
                _rows_of(text))

    _both(case)


def test_explain_shows_constraint_and_dynamic_filters():
    sql = ("explain (type logical) select count(*) from lineitem, orders "
           "where l_orderkey = o_orderkey and o_orderkey < 100")
    text = _both(lambda pkg: _plan(pkg, sql))
    assert "constraint=" in text and "dynamic_filters=['l_orderkey']" in text


def test_set_show_reset_session():
    def case(pkg):
        s = new_session(pkg)
        s.execute("set session dynamic_filtering_enabled = false")
        off = s.properties["dynamic_filtering_enabled"]
        rows = s.execute("show session").rows
        s.execute("reset session dynamic_filtering_enabled")
        cap = [r for r in rows if r[0] == "device_cache_max_bytes"]
        # the port departs from the reference here: the cap is unset by
        # default (a quarter of the device cache's budget), not 1 GiB
        if pkg is TORCH:
            assert cap[0][1:3] == ("None", "None") and "a quarter" in cap[0][4]
        return off, [r for r in rows if r not in cap], s.properties["dynamic_filtering_enabled"]

    off, rows, on = _both(case)
    by_name = {r[0]: r for r in rows}
    assert off is False and on is True
    assert by_name["dynamic_filtering_enabled"][1] == "False"
    assert "spill" in by_name["spill_enabled"][4]


def test_unknown_property_rejected():
    def case(pkg):
        msgs = []
        with pytest.raises(ValueError, match="does not exist") as e:
            new_session(pkg).execute("set session no_such_knob = 1")
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="does not exist") as e:
            pkg.session.Session({"bogus_prop": 1}, **pkg.kw)
        msgs.append(str(e.value))
        return msgs

    _both(case)


def test_property_type_validation():
    def case(pkg):
        s = new_session(pkg)
        msgs = []
        with pytest.raises(ValueError, match="expected integer") as e:
            s.set_property("query_max_device_memory", "not-a-number")
        msgs.append(str(e.value))
        with pytest.raises(ValueError, match="positive") as e:
            s.set_property("target_result_page_rows", 0)
        msgs.append(str(e.value))
        s.set_property("query_max_device_memory", "1048576")
        return msgs, s.properties["query_max_device_memory"]

    assert _both(case)[1] == 1048576


def test_dynamic_filtering_property_respected():
    def case(pkg):
        ex_mod = __import__(f"{pkg.root}.exec.executor", fromlist=["Executor"])
        s = new_session(pkg)
        s.set_property("dynamic_filtering_enabled", False)
        off = ex_mod.Executor(s).enable_dynamic_filtering
        s.set_property("dynamic_filtering_enabled", True)
        return off, ex_mod.Executor(s).enable_dynamic_filtering

    assert _both(case) == (False, True)


def _spills(pkg, **props):
    ex_mod = __import__(f"{pkg.root}.exec.executor", fromlist=["Executor"])
    q = __import__(f"{pkg.root}.exec.query", fromlist=["plan_sql"])
    s = new_session(pkg)
    for k, v in props.items():
        s.set_property(k, v)
    ex = ex_mod.Executor(s)
    root = q.plan_sql(s, "select l_orderkey, count(*) from lineitem group by l_orderkey")
    page = ex.execute_checked(root)
    return sorted(sp.kind for sp in ex.memory.spills), len(page.to_pylist())


def test_spill_works_with_dynamic_filtering_off():
    kinds, rows = _both(lambda pkg: _spills(pkg, dynamic_filtering_enabled=False,
                                            query_max_device_memory=150_000))
    assert "aggregation" in kinds and rows == 15000


def test_explain_analyze_live_row_counts():
    def case(pkg):
        text = _plan(pkg, "explain analyze select * from orders where o_orderkey = 7")
        return next(ln for ln in text.split("\n") if "- Filter" in ln).split("rows=")[1]

    assert _both(case).startswith("1]")


def test_spill_disabled_runs_unpartitioned():
    kinds, rows = _both(lambda pkg: _spills(pkg, query_max_device_memory=50_000,
                                            spill_enabled=False))
    assert kinds == [] and rows == 15000


# ------------------------------------------------------- query events
@pytest.fixture(scope="module")
def clusters():
    started = {}
    try:
        for pkg in BOTH:
            started[pkg.name] = start_cluster(pkg, "w", workers=1)
        yield {name: c for name, (c, _ws) in started.items()}
    finally:
        for coord, ws in started.values():
            stop_cluster(coord, ws)


def _recorder(pkg):
    class Recorder(pkg.events.EventListener):
        def __init__(self):
            self.created, self.completed = [], []

        def query_created(self, event):
            self.created.append(event)

        def query_completed(self, event):
            self.completed.append(event)

    class Exploder(pkg.events.EventListener):
        def query_completed(self, event):
            raise RuntimeError("listener bug")

    return Recorder(), Exploder()


def _completed(rec, qid):
    deadline = time.time() + 10
    while not any(e.query_id == qid for e in rec.completed) and time.time() < deadline:
        time.sleep(0.05)
    return next(e for e in rec.completed if e.query_id == qid)


def test_query_events_fire(clusters):
    def case(pkg):
        coord = clusters[pkg.name]
        rec, boom = _recorder(pkg)
        coord.events.add(rec)
        coord.events.add(boom)
        q = coord.submit("select 1 as x", dict(TINY), user="alice")
        state = wait_terminal(q, 30.0)
        ev = _completed(rec, q.query_id)
        created = next(e for e in rec.created if e.query_id == q.query_id)
        tl = ev.timeline
        return (state, created.user, ev.state, ev.output_rows, ev.error, ev.wall_seconds >= 0,
                tl is not None and tl["coverage"] >= 0.95, sorted(tl or {}),
                sorted({s["name"] for s in ev.spans}))

    got = _both(case)
    assert got[:7] == ("FINISHED", "alice", "FINISHED", 1, None, True, True)


def test_failed_query_event_carries_error(clusters):
    def case(pkg):
        coord = clusters[pkg.name]
        rec, _boom = _recorder(pkg)
        coord.events.add(rec)
        q = coord.submit("select definitely_not_a_column from nowhere", {})
        state = wait_terminal(q, 30.0)
        ev = _completed(rec, q.query_id)
        return state, ev.state, bool(ev.error), ev.timeline is not None

    assert _both(case) == ("FAILED", "FAILED", True, True)


def test_metrics_endpoint(clusters):
    def case(pkg):
        coord = clusters[pkg.name]
        # both packages' tasks collect per-operator stats on a plain query:
        # the operator series need no EXPLAIN ANALYZE
        q = coord.submit("select count(*) from nation", dict(TINY))
        assert wait_terminal(q, 30.0) == "FINISHED"
        body = urllib.request.urlopen(coord.base_url + "/v1/metrics").read().decode()
        assert 'trino_tpu_queries{state="FINISHED"}' in body and "trino_tpu_workers 1" in body
        total = next(ln for ln in body.splitlines() if ln.startswith("trino_tpu_queries_total"))
        assert int(total.split()[-1]) >= 1
        names = ("trino_tpu_query_phase_seconds_count", "trino_tpu_transfer_bytes_total",
                 "trino_tpu_exchange_requests_total", "trino_tpu_fast_path_queries_total",
                 "trino_tpu_operator_rows_total")
        return {n: bool(re.search(rf"^{n}\b", body, re.M)) for n in names}

    assert all(_both(case).values())


def test_recorder_param_on_live_query_merges_live_rings(clusters):
    """``/trace?recorder=1`` of a query that did not fail merges the live
    rings on every read (nothing is stored), in both packages."""
    def case(pkg):
        coord = clusters[pkg.name]
        q = coord.submit("select count(*) from lineitem", dict(TINY))
        assert wait_terminal(q, 60.0) == "FINISHED"
        trace = get_json(pkg, coord, f"/v1/query/{q.query_id}/trace?recorder=1")
        pm = trace["postmortem"]
        assert q.postmortem is None and pm["queryId"] == q.query_id
        assert pm["coordinator"]["records"] and pm["workers"]
        return sorted(trace), sorted(pm), sorted(pm["coordinator"]), pm["state"]

    assert _both(case)[3] == "FINISHED"


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("seed", range(4))
def test_cli_renderers_equal_the_reference(seed):
    """The same stats dicts and rows through both CLIs' ``render_summary``,
    ``render_progress`` and ``format_table``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tl = JAX.timeline.compute_timeline(
        [{"name": n, "start": float(rng.random()), "durationS": float(rng.random()) / 3,
          "spanId": f"s{i}", "parentId": None, "attributes": {}}
         for i, n in enumerate(["query", "schedule", "device/execute", "exchange/pull",
                                "device/staging", "parse", "optimize"])], 0.0, 1.5).to_dict()
    stats = {"state": str(rng.choice(["RUNNING", "FINISHED", "QUEUED"])),
             "stages": int(rng.integers(0, 4)), "completedStages": int(rng.integers(0, 4)),
             "totalRows": int(rng.integers(0, 10**9)), "elapsedMs": int(rng.integers(0, 10**5)),
             "completedSplits": int(rng.integers(0, 9)), "totalSplits": int(rng.integers(0, 9)),
             "peakBytes": int(rng.integers(0, 10**9)),
             "memory": {"shedBytes": int(rng.integers(0, 2)) * 4096},
             "adaptations": int(rng.integers(0, 3)),
             "fastPath": str(rng.choice(["fast-path", "distributed"])),
             "resourceGroup": "global", "deviceCacheHits": int(rng.integers(0, 3)),
             "mvHits": int(rng.integers(0, 2)), "mvNames": ["memory.default.mv"],
             "flows": {"drainBytes": 1234, "drainMbPerS": float(rng.random()),
                       "stragglers": int(rng.integers(0, 3))},
             "timeline": tl}
    rows = [(int(rng.integers(-99, 99)), None, bool(rng.random() < .5), "x" * int(rng.integers(0, 9)),
             float(rng.random())) for _ in range(5)]
    cols = ["a", "bb", "c", "d", "eeeeee"]
    assert _both(lambda pkg: (pkg.cli.render_summary(stats), pkg.cli.render_progress(stats),
                              pkg.cli.format_table(cols, rows), pkg.cli.render_summary(None)))
    assert TORCH.cli.render_progress({"state": "RUNNING", "stages": 3, "completedStages": 2,
                                      "totalRows": 6_000_000, "elapsedMs": 1200}) == \
        "[RUNNING 2/3 stages, 6.0M rows, 1.2s]"


def test_cli_summary_prints_cache_status(capsys):
    """The summary line carries the result-cache disposition (the
    reference's tests/test_query_cache.py case, with a stub transport)."""
    def case(pkg):
        class _Args:
            server = "http://stub"
            catalog = "memory"
            schema = "default"

        class _Stub:
            cache_status = "HIT"
            stats = {"totalRows": 5, "totalSplits": 1, "completedSplits": 1}

            def execute(self, sql):
                return ["a"], [(1,)]

        console = pkg.cli.Console.__new__(pkg.cli.Console)
        console.args = _Args()
        console._client = _Stub()
        console._session = None
        assert console.run_statement("select a from t") == 0
        out = capsys.readouterr().out
        return re.sub(r"in \d+\.\d+s", "in ?s", out)

    out = _both(case)
    assert "[cache: HIT]" in out and "5 rows processed" in out


def test_cli_execute_against_the_coordinator(clusters):
    """``python -m trino_tpu_torch.client.cli --server URL --execute`` as a
    subprocess: the table of the rows the reference's ``format_table``
    prints for the JAX cluster's answer, then ``[cache: HIT]`` on a repeat
    with the result cache on."""
    import subprocess

    sql = "select n_regionkey, count(*) as c from nation group by n_regionkey order by 1"
    _c, cols, rows = execute(JAX, clusters["jax"], sql)
    want = JAX.cli.format_table(cols, [tuple(r) for r in rows])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    outs = []
    for _ in range(2):
        res = subprocess.run(
            [sys.executable, "-m", "trino_tpu_torch.client.cli", "--server",
             clusters["torch"].base_url, "--session", "result_cache_enabled=true",
             "--execute", sql], env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        outs.append(res.stdout)
    for out in outs:
        assert out.startswith(want + "\n(5 rows in "), out
    assert "[cache: MISS]" in outs[0] and "[cache: HIT]" in outs[1]
