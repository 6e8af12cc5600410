"""Each fault the cells can have, planted under the timed path of a CPU run
at tiny, turns ``correct`` false: an answer altered where it is made, half
of an answer's rows left out, a query that never answers. The look for a
card is skipped; the rest of the run is the benchmark's own."""
import json
import time

import pytest

from portbench import core

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
TINY = {"scale_factor": 0.01, "schema": "tiny"}


def _run(cell, seed=5):
    return core.run_cell(BENCH, cell, seed, 1.0, False, "cpu", time.perf_counter(),
                         config_overrides=TINY)


def _alter(rows):
    if not rows:
        return [(0,)]
    first = list(rows[0])
    first[-1] = first[-1] + 1 if isinstance(first[-1], int) else \
        first[-1] * 2 if first[-1] is not None and not isinstance(first[-1], str) else "x"
    return [tuple(first)] + list(rows[1:])


def _halve(rows):
    return list(rows[: len(rows) // 2])


def _plant(monkeypatch, cell, fault):
    """Break the answer where the cell's timed path makes it."""
    if cell == "tpch-sf1.dashboard":
        from trino_tpu_torch.data.page import Page

        real = Page.to_pylist
        monkeypatch.setattr(Page, "to_pylist", lambda self: fault(real(self)))
    else:
        from trino_tpu_torch.client.session import Session

        real = Session.execute

        def execute(self, sql):
            res = real(self, sql)
            res.rows = fault(res.rows)
            return res

        monkeypatch.setattr(Session, "execute", execute)


@pytest.mark.parametrize("cell", ["tpch-sf1.dashboard", "tpch-sf1.power"])
def test_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["notes"]


@pytest.mark.parametrize("cell", ["tpch-sf1.dashboard", "tpch-sf1.power"])
@pytest.mark.parametrize("fault", [_alter, _halve], ids=["altered", "half_left_out"])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    calls = {"n": 0}

    def after_setup(rows):
        # the fault lives in the timed path: the window's answers, not set-up's
        # (set-up makes 44 answers in either cell)
        calls["n"] += 1
        return fault(rows) if calls["n"] > 60 else rows

    _plant(monkeypatch, cell, after_setup)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["mismatched_answers"]["value"] > 0


@pytest.mark.parametrize("cell", ["tpch-sf1.dashboard", "tpch-sf1.power"])
def test_a_query_that_never_answers_is_not_correct(monkeypatch, cell):
    calls = {"n": 0}

    def sometimes(rows):
        calls["n"] += 1
        if calls["n"] > 60 and calls["n"] % 7 == 0:
            raise RuntimeError("planted: no answer")
        return rows

    _plant(monkeypatch, cell, sometimes)
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["failed_queries"]["value"] > 0
