"""SQL through both Sessions: the comparison the slice's test files share
(tests/test_torch_window.py, _setops.py, _aggregates.py, _tpcds.py), its
own checks, and the guard that the port loads neither ``jax`` nor the JAX
package.

Tolerances: decimal, integer, varchar, date and boolean values must be
equal; a double may differ by ``math.isclose(rel_tol=1e-9, abs_tol=1e-12)``
(at SF1, in chip_smoke.py, ``rel_tol=1e-8``), because the two packages sum
floats in different orders (XLA on the CPU, ``index_add_`` and ``cumsum``
in the port).
"""
import json
import math
import os
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from trino_tpu.client.session import Session as JaxSession  # noqa: E402
from trino_tpu.obs import metrics as jax_metrics  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch.obs import metrics as torch_metrics  # noqa: E402

REL_TOL = 1e-9
ABS_TOL = 1e-12
TIERS = ("dense", "fused", "merge-sorted", "merge-pallas", "legacy")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def values_match(got, want, rel_tol=REL_TOL, abs_tol=ABS_TOL) -> bool:
    """Exact, except that two floats may differ within the tolerance (and
    two NaNs match)."""
    if isinstance(got, float) and isinstance(want, float):
        if math.isnan(got) or math.isnan(want):
            return math.isnan(got) and math.isnan(want)
        return math.isclose(got, want, rel_tol=rel_tol, abs_tol=abs_tol)
    return type(got) is type(want) and got == want


def assert_rows_match(got, want, what="", rel_tol=REL_TOL, abs_tol=ABS_TOL):
    """Rows in the same order, value by value under ``values_match``."""
    assert len(got) == len(want), f"{what}: {len(got)} rows, the reference {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) and all(
            values_match(a, b, rel_tol, abs_tol) for a, b in zip(g, w)), \
            f"{what}: row {i}: {g} != the reference's {w}"


def _tier_counts(metric):
    return {t: metric.value(t) for t in TIERS}


class BothSessions:
    """A JAX Session and a port Session on the CPU over the same catalogs'
    data: memory tables are created in both from the same rows."""

    def __init__(self, properties=None):
        self.props = dict(properties or {})
        self.jax = JaxSession(properties=dict(self.props))
        self.torch = TorchSession(properties=dict(self.props), device="cpu")

    def create_table(self, schema, name, columns, rows):
        """``columns``: (name, type name) pairs, the type parsed by each
        package."""
        from trino_tpu import types as JT
        from trino_tpu_torch import types as TT

        self.jax.catalogs["memory"].create_table(
            schema, name, [(c, JT.parse_type(t)) for c, t in columns], rows)
        self.torch.catalogs["memory"].create_table(
            schema, name, [(c, TT.parse_type(t)) for c, t in columns], rows)

    def run(self, sql):
        """(reference rows, port rows, reference tiers, port tiers)."""
        j0 = _tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
        ref = self.jax.execute(sql).rows
        j1 = _tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
        t0 = _tier_counts(torch_metrics.FUSED_JOIN_SELECTIONS)
        got = self.torch.execute(sql).rows
        t1 = _tier_counts(torch_metrics.FUSED_JOIN_SELECTIONS)
        return (ref, got, {t: j1[t] - j0[t] for t in TIERS},
                {t: t1[t] - t0[t] for t in TIERS})

    def check(self, sql, rel_tol=REL_TOL, abs_tol=ABS_TOL):
        """Rows within the tolerance and equal join tiers; returns the rows."""
        ref, got, jt, tt = self.run(sql)
        assert_rows_match(got, ref, sql.strip()[:80], rel_tol, abs_tol)
        assert tt == jt, f"join tiers {tt} != the reference's {jt}"
        return got

    def check_raises(self, sql):
        """Both packages refuse the statement; returns the two messages."""
        with pytest.raises(Exception) as ref:
            self.jax.execute(sql)
        with pytest.raises(Exception) as got:
            self.torch.execute(sql)
        return str(ref.value), str(got.value)


@pytest.mark.parametrize("got,want,ok", [
    (1.0, 1.0 + 1e-12, True),
    (1.0, 1.0 + 1e-6, False),
    (0.0, 1e-13, True),
    (float("nan"), float("nan"), True),
    (float("nan"), 1.0, False),
    (1, 1.0, False),  # a type change is a difference
    (True, 1, False),
    ("a", "a", True),
    (None, None, True),
])
def test_values_match(got, want, ok):
    assert values_match(got, want) is ok


NAMED_MODULES = (
    "trino_tpu_torch.server.security", "trino_tpu_torch.server.prepared",
    "trino_tpu_torch.sql.routines", "trino_tpu_torch.exec.table_functions",
    "trino_tpu_torch.exec.transaction", "trino_tpu_torch.exec.operator_stats",
    "trino_tpu_torch.connector.blackhole.connector",
    "trino_tpu_torch.connector.sqlite.connector",
    "trino_tpu_torch.connector.filesystem.connector",
    # the nested-type slice
    "trino_tpu_torch.ops.array_ops", "trino_tpu_torch.exec.match_recognize",
    # the distributed path
    "trino_tpu_torch.data.serde", "trino_tpu_torch.sql.planner.fragmenter",
    "trino_tpu_torch.server.wire", "trino_tpu_torch.server.statemachine",
    "trino_tpu_torch.server.buffer", "trino_tpu_torch.server.exchange_client",
    "trino_tpu_torch.server.task", "trino_tpu_torch.server.worker",
    "trino_tpu_torch.server.fastpath", "trino_tpu_torch.server.coordinator",
    "trino_tpu_torch.client.remote", "trino_tpu_torch.client.dbapi",
    # the repeat-query path
    "trino_tpu_torch.cache", "trino_tpu_torch.cache.plan_key",
    "trino_tpu_torch.cache.determinism", "trino_tpu_torch.cache.result_cache",
    "trino_tpu_torch.matview", "trino_tpu_torch.matview.registry",
    "trino_tpu_torch.matview.substitute", "trino_tpu_torch.matview.lifecycle",
    # the adaptive distributed path
    "trino_tpu_torch.obs.devprofiler", "trino_tpu_torch.parallel.exchange",
    "trino_tpu_torch.adaptive.runtime_stats", "trino_tpu_torch.adaptive.replanner",
    # the serving plane
    "trino_tpu_torch.server.dispatch", "trino_tpu_torch.server.resource_groups",
    "trino_tpu_torch.server.cluster_memory", "trino_tpu_torch.server.auth",
    "trino_tpu_torch.server.events", "trino_tpu_torch.obs.memledger",
    "trino_tpu_torch.obs.flightrecorder", "trino_tpu_torch.obs.metrics",
    "trino_tpu_torch.devcache.hostcache")


def test_port_loads_neither_jax_nor_the_jax_package():
    """Every module of trino_tpu_torch imported in a fresh interpreter:
    neither ``jax`` nor ``trino_tpu`` (or a submodule) is in sys.modules."""
    code = r"""
import importlib, json, pkgutil, sys
import trino_tpu_torch
names = []
for info in pkgutil.walk_packages(trino_tpu_torch.__path__, "trino_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "trino_tpu" or m.startswith("trino_tpu."))
print(json.dumps({"modules": names, "loaded": bad}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(seen["modules"]) > 50  # the whole package, not an empty walk
    # the statement surface, its connectors, the nested-type modules, the
    # distributed path and the caches and views are in the walk
    assert set(NAMED_MODULES) <= set(seen["modules"])
    assert seen["loaded"] == [], f"the port loaded {seen['loaded']}"
