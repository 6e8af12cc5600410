"""The one traffic generator: each key of a traffic file changes what a run
sends, as ``portbench/traffic.py`` says, and a run at tiny on the CPU with
several clients, open arrivals or fresh parameters for every query is still
checked against the reference."""
import json
import time

import pytest

from portbench import core
from portbench.queries.tpch import params as P
from portbench.traffic import Traffic

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
TINY = {"scale_factor": 0.01, "schema": "tiny"}
POWER = json.loads((core.HERE / "workloads" / "tpch-sf1.power.json").read_text())


def _traffic(seed=3, **changes):
    return Traffic({**POWER, **changes}, seed, 0.01, P)


def _run(cell="tpch-sf1.power", seed=7, seconds=1.0, trace=False, **changes):
    return core.run_cell(BENCH, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                         config_overrides=TINY, traffic_overrides=changes)


def test_a_key_nothing_reads_is_refused():
    with pytest.raises(ValueError, match="unknown keys"):
        _traffic(loop="closed")
    with pytest.raises(ValueError, match="missing"):
        Traffic({k: v for k, v in POWER.items() if k != "clients"}, 1, 0.01, P)


def test_fixed_parameters_do_the_same_work_on_every_seed():
    a, b = _traffic(seed=1, order="seeded"), _traffic(seed=2 ** 33 + 5, order="seeded")
    keys_a = {a.key(0, i) for i in range(22)}
    assert keys_a == {b.key(0, i) for i in range(22)}
    assert [a.key(0, i) for i in range(22)] != [b.key(0, i) for i in range(22)]
    assert a.order(0) != a.order(1) and sorted(a.order(1)) == sorted(POWER["queries"])
    assert [a.key(0, i) for i in range(22)] == [a.key(0, 22 + i) for i in range(22)]


def test_per_stream_and_per_query_parameters():
    s = _traffic(parameters="per_stream")
    assert s.key(0, 0) == s.key(0, 22) and s.key(0, 0) != s.key(1, 0)
    q = _traffic(parameters="per_query", order="seeded")
    window = {q.key(c, i) for c in range(2) for i in range(44)}
    assert len(window) == 88
    assert not window & set(q.setup_keys(0)) and not window & set(q.profile_keys(1))
    assert len(q.compared(window)) == 88
    capped = _traffic(parameters="per_query", compare_at_most=5)
    assert len(capped.compared(window)) == 5
    assert capped.compared(window) == _traffic(parameters="per_query",
                                               compare_at_most=5).compared(window)


@pytest.mark.parametrize("changes", [
    {"clients": 2, "order": "seeded"},
    {"clients": 2, "arrivals": 25},
    {"parameters": "per_query", "compare_at_most": 6, "warmup_passes": 1},
], ids=["two_closed_streams", "open_arrivals", "fresh_parameters"])
def test_a_mix_runs_and_is_checked(changes):
    res = _run(**changes)
    assert res["correct"], res["notes"]
    assert res["attempted"] == res["notes"]["window_queries"] > 0
    assert res["metrics"]["queries_per_s.eager"]["value"] > 0
    if "compare_at_most" in changes:
        assert res["notes"]["instances_compared"] == 6


def test_a_fault_in_a_sampled_mix_is_not_correct(monkeypatch):
    from trino_tpu_torch.client.session import Session

    real, warm = Session.execute, {"n": 0}

    def execute(self, sql):
        res = real(self, sql)
        warm["n"] += 1
        if warm["n"] > 44:  # past set-up's two clients' passes
            res.rows = list(res.rows)[: len(res.rows) // 2] if res.rows else [(0,)]
        return res

    monkeypatch.setattr(Session, "execute", execute)
    res = _run(clients=2, parameters="per_stream", compare_at_most=4, warmup_passes=1)
    assert not res["correct"]
    assert res["checks"]["mismatched_answers"]["value"] > 0


def test_the_compiled_driver_refuses_what_it_cannot_replay():
    with pytest.raises(ValueError, match="one client"):
        _run("tpch-sf1.dashboard", clients=2)


def test_the_window_spans_leave_out_the_traced_passes(monkeypatch):
    seen = {}
    real = core.per_layer

    def per_layer(run, names):
        seen["run"] = run
        return real(run, names)

    monkeypatch.setattr(core, "per_layer", per_layer)
    res = _run("tpch-sf1.dashboard", trace=True)
    run = seen["run"]
    replays = [s for s in run.spans if s.name == "replay"]
    assert len(replays) == run.completed
    assert len([s for s in run.profile_spans if s.name == "replay"]) == \
        int(run.traffic.spec["profiled_passes"]) * 22
    assert res["correct"] and "replay_ms_per_query" in res["metrics"]


def test_the_configuration_names_its_benchmark_family():
    params, reference = core.family({"benchmark": "tpch"})
    assert params is P and hasattr(reference, "reference_answers")
    with pytest.raises(ModuleNotFoundError):
        core.family({"benchmark": "no_such_benchmark"})
