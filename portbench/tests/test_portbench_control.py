"""The control (the reference with float64 decimals in the program's place)
fails the comparison that decides ``correct``: at tiny and SF1 on the CPU, and
at each configuration's own size on the card."""
import json

import pytest

from portbench.control import control_readings
from portbench.core import HERE, ROOT

# the TPC-H configurations the benchmark's cells run (control.py is this
# family's control)
CONFIGS = sorted(c for c in {w["config"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]}
    if json.loads((HERE / "configs" / f"{c}.json").read_text())["benchmark"] == "tpch")


@pytest.mark.parametrize("sf,seeds", [(0.01, (1, 2, 3, 2 ** 33 + 9)), (1, (4,))])
def test_the_control_is_refused_on_the_cpu(sf, seeds):
    for reading in control_readings(sf, seeds, "cpu"):
        assert reading["mismatched_answers"] >= 1, reading


@pytest.mark.cuda
@pytest.mark.parametrize("config", CONFIGS)
def test_the_control_is_refused_at_the_cells_size(config):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    sf = json.loads((HERE / "configs" / f"{config}.json").read_text())["scale_factor"]
    for reading in control_readings(sf, (101, 102, 103), "cuda"):
        assert reading["mismatched_answers"] >= 1, reading
