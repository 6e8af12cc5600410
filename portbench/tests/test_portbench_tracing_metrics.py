"""The per-layer metrics read from the port's host-time counters: each reads
a finite, non-negative value in its cell at tiny on the CPU with tracing on,
and nothing where its counter is absent (a program without it). The spans
that feed them leave what the other readers read as it was."""
import json
import math
import time
from types import SimpleNamespace

import pytest

from portbench import core

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
TINY = {"scale_factor": 0.01, "schema": "tiny"}
NEW = {
    "tpch-sf1.power": ("plan_ms_per_query", "host_pass_ms_per_query", "dispatch_ms_per_query"),
    "tpch-sf1.dashboard": ("rows_copy_ms_per_query", "replay_host_ms_per_query"),
}


def _run(cell, monkeypatch, seed=2 ** 33 + 11, **changes):
    seen = {}
    real = core.per_layer

    def per_layer(run, names):
        seen["run"] = run
        return real(run, names)

    monkeypatch.setattr(core, "per_layer", per_layer)
    res = core.run_cell(BENCH, cell, seed, 1.0, True, "cpu", time.perf_counter(),
                        config_overrides=TINY, traffic_overrides=changes)
    return res, seen["run"]


@pytest.mark.parametrize("cell", sorted(NEW))
def test_each_new_metric_reads_in_its_cell(cell, monkeypatch):
    res, run = _run(cell, monkeypatch)
    assert res["correct"], res["notes"]
    for name in NEW[cell]:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    others = {n for c, names in NEW.items() if c != cell for n in names}
    assert not others & set(res["metrics"])
    # the host passes sit inside the executor's runs
    if cell == "tpch-sf1.power":
        assert res["metrics"]["host_pass_ms_per_query"]["value"] > 0
        assert run.counters["trino_tpu_executor_seconds_total"] >= \
            run.counters["trino_tpu_scalar_host_seconds_total"]


@pytest.mark.parametrize("name", sorted(n for names in NEW.values() for n in names))
def test_a_missing_counter_reads_nothing(name):
    reader = __import__(f"portbench.metrics.{name}", fromlist=["read"])
    assert reader.read(SimpleNamespace(completed=5, counters={})) is None
    full = {k: 1.0 for k in core.counters()}
    assert reader.read(SimpleNamespace(completed=0, counters=full)) is None
    assert reader.read(SimpleNamespace(completed=5, counters=full)) is not None


class _Untimed:
    """``trace.timed`` without its spans and counters."""

    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        from trino_tpu_torch.obs import trace

        return trace.NOOP_SPAN

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("cell", sorted(NEW))
def test_the_other_readers_read_as_without_the_new_spans(cell, monkeypatch):
    """One query, so that each instance does the same work: the harness's
    spans, the staging family's spans per query and the device-cache
    misses read alike with and without the spans this program adds."""
    from trino_tpu_torch.obs import trace

    res, run = _run(cell, monkeypatch, queries=[3])
    real_timed, real_current = trace.timed, trace.current
    with monkeypatch.context() as m:
        m.setattr(trace, "timed", _Untimed)
        # the spans the program had before keep recording: an ambient span
        # with no counter, under any tracer
        m.setattr(trace, "span", lambda name, **attributes: real_timed(name, None, **attributes))
        m.setattr(trace, "current", lambda detail=False: None if detail else real_current())
        bare, bare_run = _run(cell, monkeypatch, queries=[3])
    assert res["correct"] and bare["correct"]
    old = {n for n in res["metrics"] if not any(n in names for names in NEW.values())}
    assert old == set(bare["metrics"]) - {n for names in NEW.values() for n in names}
    assert old, res["metrics"]
    for r in (run, bare_run):
        for harness in ("replay", "rows", "execute"):
            d = [s for s in r.spans if s.name == harness]
            assert len(d) in (0, r.completed)
    assert run.staging_spans / run.completed == bare_run.staging_spans / bare_run.completed
    for name in {"devcache_misses_per_query", "launches_per_query"} & old:
        assert res["metrics"][name] == bare["metrics"][name]
