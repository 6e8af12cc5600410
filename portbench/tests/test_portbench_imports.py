"""No run imports JAX or the JAX package, and the reference imports nothing
of the program: checked on the sources, and after a CPU smoke of each driver
at tiny in a fresh interpreter."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "trino_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_imports(path)) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in list((BENCH / "reference").glob("*.py")) + \
            [BENCH / "queries" / "tpch" / "params.py"]:
        assert not set(_imports(path)) & (JAX | {"trino_tpu_torch"}), path


SMOKE = """
import json, sys, time
t = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench import core
bench = json.load(open({bench!r}))
r = core.run_cell(bench, {cell!r}, 11, 1.0, {trace}, "cpu", t,
                  config_overrides={{"scale_factor": 0.01, "schema": "tiny"}})
print(json.dumps({{"correct": r["correct"], "forbidden": core.forbidden_modules(),
                  "metrics": sorted(r["metrics"])}}))
"""


@pytest.mark.parametrize("cell", ["tpch-sf1.dashboard", "tpch-sf1.power"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_driver_smoke_at_tiny_loads_no_jax(cell, trace):
    code = SMOKE.format(root=str(ROOT), bench=str(ROOT / "BENCHMARK.json"), cell=cell,
                        trace=trace)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["forbidden"] == []
    assert res["metrics"], res


def test_the_run_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "tpch-sf1.dashboard", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""
