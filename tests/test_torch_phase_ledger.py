"""The port's phase ledger (trino_tpu_torch/obs/timeline.py) and the task
spans it reads, held against the JAX package on the CPU.

The cases of the reference's tests/test_phase_ledger.py. The sweep's units
give the same span dicts to both packages' ``compute_timeline``,
``summarize`` and ``observe_phases``, and the results must be exactly
equal. The cluster cases run the same statements on a port CPU cluster and
a JAX CPU cluster (two in-process workers each). The ledger's keys, its
coverage bound and where it rides must agree: query info, the trace, the
statement stats, ``system.runtime.queries``, the phase histogram, the CLI
summary and EXPLAIN ANALYZE. Timings are not compared.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_obs_common import (BOTH, JAX, TINY, TORCH, both_clusters, execute,  # noqa: E402
                              get_json, wait_terminal)
from tpch_sql import QUERIES as TPCH  # noqa: E402


def _span(name, start, dur, sid="s", parent=None, **attrs):
    return {"name": name, "start": start, "durationS": dur, "spanId": sid,
            "parentId": parent, "attributes": attrs}


def _both(fn):
    """fn(pkg) for both packages; the results must be equal."""
    got, want = fn(TORCH), fn(JAX)
    assert got == want
    return got


# ------------------------------------------------------------ sweep units
def test_exclusive_attribution_with_overlap():
    spans = [
        _span("query", 10.1, 0.9, "r"),
        _span("schedule", 10.2, 0.4, "sc"),
        _span("device/staging", 10.3, 0.2, "st"),
        _span("execute/root-fragment", 10.6, 0.35, "ex"),
        _span("exchange/pull", 10.62, 0.1, "p1"),
        _span("exchange/pull", 10.65, 0.1, "p2"),
    ]
    d = _both(lambda pkg: pkg.timeline.compute_timeline(spans, 10.0, 11.0).to_dict())
    ph = d["phases"]
    assert ph["queued"] == pytest.approx(0.1)
    assert ph["device-staging"] == pytest.approx(0.2)
    assert ph["schedule"] == pytest.approx(0.2)
    assert ph["exchange-wait"] == pytest.approx(0.13)
    assert ph["device-execute"] == pytest.approx(0.35 - 0.13)
    assert ph["dispatch"] == pytest.approx(0.15)
    assert d["unattributedS"] == pytest.approx(0.0)
    in_wall = sum(v for p, v in ph.items() if p not in ("client-drain", "segment-fetch"))
    assert in_wall == pytest.approx(d["wallS"], abs=1e-6)


def test_phase_sums_never_exceed_wall():
    spans = [_span("query", 0.0, 100.0, "r"), _span("device/execute", 0.0, 100.0, "a"),
             _span("device/staging", 0.0, 100.0, "b"), _span("exchange/pull", 0.0, 100.0, "c")]

    def case(pkg):
        tl = pkg.timeline.compute_timeline(spans, 0.0, 1.0)
        return tl.phases, tl.wall_s, tl.unattributed_s

    phases, wall, unattributed = _both(case)
    assert sum(phases.values()) <= wall + 1e-9
    assert phases["device-staging"] == pytest.approx(1.0)
    assert unattributed == pytest.approx(0.0)


def test_open_spans_run_to_wall_end_and_missing_root_is_queued():
    spans = [_span("query", 0.2, None, "r"), _span("device/execute", 0.3, None, "e")]

    def case(pkg):
        tl = pkg.timeline.compute_timeline(spans, 0.0, 1.0)
        tl2 = pkg.timeline.compute_timeline([], 5.0, 7.0)
        return tl.to_dict(), tl2.to_dict(), tl2.coverage

    d, d2, cov = _both(case)
    assert d["phases"]["queued"] == pytest.approx(0.2)
    assert d["phases"]["device-execute"] == pytest.approx(0.7)
    assert d2["phases"]["queued"] == pytest.approx(2.0) and cov == pytest.approx(1.0)


def test_observe_phases_covers_every_label():
    assert TORCH.timeline.PHASES == JAX.timeline.PHASES
    assert TORCH.timeline.SPAN_PHASE == JAX.timeline.SPAN_PHASE
    for pkg in BOTH:
        tl = pkg.timeline.compute_timeline([_span("query", 0.0, 1.0, "r")], 0.0, 1.0)
        hist = pkg.M.QUERY_PHASE_SECONDS
        before = {p: hist.snapshot(p)[2] for p in pkg.timeline.PHASES}
        pkg.timeline.observe_phases(tl.to_dict())
        assert all(hist.snapshot(p)[2] == before[p] + 1 for p in pkg.timeline.PHASES)
    mine, ref = TORCH.M.QUERY_PHASE_SECONDS, JAX.M.QUERY_PHASE_SECONDS
    assert (mine.name, mine.help, mine.labelnames, mine.buckets) == (
        ref.name, ref.help, ref.labelnames, ref.buckets)


@pytest.mark.parametrize("seed", range(4))
def test_summarize_is_compact_and_ordered(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    names = list(JAX.timeline.SPAN_PHASE) + ["query"]
    spans = [_span("query", 0.0, 1.0, "r")] + [
        _span(names[int(rng.integers(0, len(names)))], float(rng.random()),
              float(rng.random()) / 2, f"s{i}") for i in range(12)]
    line = _both(lambda pkg: pkg.timeline.summarize(
        pkg.timeline.compute_timeline(spans, 0.0, 1.0).to_dict()))
    assert "% attributed)" in line
    fixed = [_span("query", 0.0, 1.0, "r"), _span("device/execute", 0.0, 0.6, "e"),
             _span("parse", 0.6, 0.2, "p")]
    line = _both(lambda pkg: pkg.timeline.summarize(
        pkg.timeline.compute_timeline(fixed, 0.0, 1.0).to_dict()))
    assert line.index("device-execute") < line.index("parse-analyze")


# ------------------------------------------------- acceptance, live cluster
@pytest.fixture(scope="module")
def clusters():
    yield from both_clusters("ledger-w")


def _assert_ledger(tl, where):
    assert tl is not None, f"no timeline for {where}"
    assert tl["wallS"] > 0
    assert tl["coverage"] >= 0.95, (where, tl)
    assert tl["unattributedS"] <= 0.05 * tl["wallS"] + 1e-9
    in_wall = sum(v for p, v in tl["phases"].items() if p not in ("client-drain", "segment-fetch"))
    assert in_wall <= tl["wallS"] + 2e-5
    # phases plus the residual make up the wall (microsecond rounding)
    assert abs(in_wall - tl["wallS"]) <= 2e-5 + 1e-6 * len(tl["phases"])
    return tl


def _keys(tl):
    return sorted(tl), sorted(tl["phases"])


def test_ledger_distributed_tpch_q1(clusters):
    out = {}
    for pkg in BOTH:
        coord = clusters[pkg.name]
        q = coord.submit(TPCH[1], dict(TINY))
        assert wait_terminal(q) == "FINISHED", q.failure
        tl = _assert_ledger(q.timeline_dict(), f"{pkg.name} q1")
        assert (tl["phases"]["device-staging"] + tl["phases"]["device-execute"]
                + tl["phases"]["exchange-wait"]) > 0
        assert q.info()["queryStats"]["timeline"]["coverage"] >= 0.95
        trace = get_json(pkg, coord, f"/v1/query/{q.query_id}/trace")
        assert trace["timeline"]["coverage"] >= 0.95
        out[pkg.name] = (_keys(tl), sorted(trace))
    assert out["torch"] == out["jax"]


def test_ledger_fast_path_point_query(clusters):
    for pkg in BOTH:
        q = clusters[pkg.name].submit("select n_name from nation where n_nationkey = 7",
                                      {**TINY, "short_query_fast_path": "true"})
        assert wait_terminal(q) == "FINISHED", q.failure
        assert q.fast_path == "fast-path"
        _assert_ledger(q.timeline_dict(), f"{pkg.name} fast path")
        assert any(s["name"] == "fastpath/execute" for s in q.tracer.to_dicts())


def test_ledger_second_execute_of_prepared(clusters):
    for pkg in BOTH:
        c, _cols, _rows = execute(pkg, clusters[pkg.name],
                                  "PREPARE ledger_pt FROM select n_name from nation "
                                  "where n_nationkey = ?")
        c.execute("EXECUTE ledger_pt USING 3")
        _cols, rows = c.execute("EXECUTE ledger_pt USING 7")
        assert rows == [["GERMANY"]]
        q = clusters[pkg.name].get_query(c.query_id)
        tl = _assert_ledger(q.timeline_dict(), f"{pkg.name} second EXECUTE")
        assert tl["phases"]["prepare-bind"] >= 0
        assert c.stats["timeline"]["coverage"] >= 0.95


def test_queued_phase_histogram_on_metrics_and_system_table(clusters):
    import urllib.request

    for pkg in BOTH:
        coord = clusters[pkg.name]
        q = coord.submit("select 1 as x", dict(TINY))
        assert wait_terminal(q) == "FINISHED", q.failure
        body = urllib.request.urlopen(coord.base_url + "/v1/metrics").read().decode()
        assert 'trino_tpu_query_phase_seconds_bucket{phase="queued"' in body
        assert 'trino_tpu_query_phase_seconds_count{phase="queued"}' in body
        q2 = coord.submit("select name, labels from system.metrics "
                          "where name like 'trino_tpu_query_phase_seconds%'", {})
        assert wait_terminal(q2) == "FINISHED", q2.failure
        assert any("queued" in (r[1] or "") for r in q2.rows), q2.rows[:5]


def test_queries_table_carries_ledger_columns(clusters):
    for pkg in BOTH:
        coord = clusters[pkg.name]
        q = coord.submit("select count(*) from nation", dict(TINY))
        assert wait_terminal(q) == "FINISHED", q.failure
        q2 = coord.submit("select query_id, queued_ms, planning_ms, execution_ms, "
                          "unattributed_ms from system.runtime.queries "
                          "where state = 'FINISHED'", {})
        assert wait_terminal(q2) == "FINISHED", q2.failure
        row = next(r for r in q2.rows if r[0] == q.query_id)
        assert row[1] is not None and row[1] >= 0
        assert row[2] is not None and row[2] > 0
        assert row[3] is not None and row[3] > 0
        tl = q.timeline_dict()
        assert row[4] == pytest.approx(tl["phases"]["unattributed"] * 1000.0, abs=1.0)


def test_cli_summary_and_explain_analyze_render_ledger(clusters):
    out = {}
    for pkg in BOTH:
        c, _cols, _rows = execute(pkg, clusters[pkg.name], "select count(*) from region")
        line = pkg.cli.render_summary(c.stats)
        assert "phases:" in line and "% attributed" in line
        _cols, rows = c.execute("explain analyze select count(*) from region")
        text = "\n".join(r[0] for r in rows)
        assert "Phase ledger:" in text
        out[pkg.name] = [ln.split(":", 1)[0] for ln in text.split("\n")
                         if ln.startswith(("Query wall time", "Phase ledger", "Data flow",
                                           "Straggler", "Fast path", "Peak working set"))]
    assert out["torch"] == out["jax"]
