"""The per-layer metrics read from the counters of the executor's dynamic
filters, windows and set operations: each reads a finite, non-negative
value in its cells at tiny on the CPU with tracing on, and nothing where its
counter is absent (a program without it); the ``tpcds`` family's cell runs
and reads every metric it lists, with no JAX loaded."""
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from portbench import core

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
TINY = {"scale_factor": 0.01, "schema": "tiny"}
NEW = {
    "tpcds-sf10.analytics": ("dynamic_filter_ms_per_query", "dynamic_filter_mb_per_query",
                             "window_ms_per_query", "set_op_ms_per_query"),
    "tpch-sf1.power": ("dynamic_filter_ms_per_query", "dynamic_filter_mb_per_query"),
}
COUNTERS = {"dynamic_filter_ms_per_query": "trino_tpu_dynamic_filter_seconds_total",
            "dynamic_filter_mb_per_query": "trino_tpu_dynamic_filter_host_bytes_total",
            "window_ms_per_query": "trino_tpu_window_seconds_total",
            "set_op_ms_per_query": "trino_tpu_set_op_seconds_total"}


def _reader(name):
    return __import__(f"portbench.metrics.{name}", fromlist=["read"])


@pytest.mark.parametrize("cell", sorted(NEW))
def test_each_new_metric_reads_in_its_cells(cell):
    res = core.run_cell(BENCH, cell, 2 ** 33 + 13, 1.0, True, "cpu", time.perf_counter(),
                        config_overrides=TINY)
    assert res["correct"], res["notes"]
    for name in NEW[cell]:
        value = res["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    assert res["metrics"]["dynamic_filter_mb_per_query"]["value"] > 0
    if cell == "tpcds-sf10.analytics":
        # every metric the cell lists but the device trace's, which a CPU run lacks
        listed = [m for m in BENCH["per_layer"] if cell in m.get("workloads", ())]
        program = {m["name"] for m in listed if m["source"] != "device_trace"}
        assert program <= set(res["metrics"]) <= {m["name"] for m in listed}
    else:
        assert not {"window_ms_per_query", "set_op_ms_per_query"} & set(res["metrics"])


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_a_reader_on_recorded_counters(name):
    reader = _reader(name)
    assert reader.read(SimpleNamespace(completed=5, counters={})) is None
    assert reader.read(SimpleNamespace(completed=0, counters={COUNTERS[name]: 1.0})) is None
    got = reader.read(SimpleNamespace(completed=4, counters={COUNTERS[name]: 2.0}))
    assert got == (0.5e-6 if name.endswith("_mb_per_query") else 500.0)


SMOKE = """
import json, sys, time
t = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench import core
bench = json.load(open({bench!r}))
r = core.run_cell(bench, "tpcds-sf10.analytics", 11, 1.0, {trace}, "cpu", t,
                  config_overrides={{"scale_factor": 0.01, "schema": "tiny"}})
print(json.dumps({{"correct": r["correct"], "forbidden": core.forbidden_modules(),
                  "metrics": sorted(r["metrics"])}}))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_at_tiny_loads_no_jax(trace):
    code = SMOKE.format(root=str(core.ROOT), bench=str(core.ROOT / "BENCHMARK.json"),
                        trace=trace)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["forbidden"] == []
    assert res["metrics"], res
