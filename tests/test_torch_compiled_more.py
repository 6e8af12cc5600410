"""TPC-DS q95 and q64 at ``tiny`` through the port's CompiledQuery and the
JAX package's: equal build decisions, rows and recompiles (q95 needs five
at ``tiny``, the test of the recapture loop; q64 returns no row there, in
both). A file of its own, so the xdist ``loadfile`` workers split it from
test_torch_compiled.py. Tolerance: exact."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from trino_tpu.exec import compiled as j_compiled  # noqa: E402
from trino_tpu.exec.query import plan_sql as jax_plan_sql  # noqa: E402
from trino_tpu.sql.planner import plan as JP  # noqa: E402
from tpcds_sql import Q64, Q95  # noqa: E402
from test_torch_compiled import TPCDS, sessions  # noqa: E402
from test_torch_compiled_tpch import build_profile  # noqa: E402

from trino_tpu_torch.exec.compiled import CompiledQuery  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql  # noqa: E402
from trino_tpu_torch.sql.planner import plan as TP  # noqa: E402


@pytest.mark.parametrize("name", ["q95", "q64"])
def test_tpcds_compiled_tiny_equals_reference(name):
    """q95 needs the reference's five recompiles at tiny (the hints are
    copies); q64 returns no row at tiny, in both."""
    sql = {"q95": Q95, "q64": Q64}[name]
    js, ts = sessions(TPCDS)
    jcq = j_compiled.CompiledQuery.build(js, jax_plan_sql(js, sql))
    tcq = CompiledQuery.build(ts, plan_sql(ts, sql))
    assert build_profile(tcq, TP.walk_plan) == build_profile(jcq, JP.walk_plan)
    rows = tcq.run().to_pylist()
    assert rows == jcq.run().to_pylist()
    assert tcq.recompiles == jcq.recompiles
    if name == "q95":
        assert tcq.recompiles == 5 and len(rows) == 1
    assert tcq.run().to_pylist() == rows == ts.execute(sql).rows
