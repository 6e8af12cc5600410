"""The 22 TPC-H queries at ``tiny`` with the device cache on, cold then
warm, through both Sessions: the JAX package (trino_tpu) is the
reference, the port (trino_tpu_torch) runs on the CPU here.

Each run returns the reference's rows and join tiers (with the cache on,
a bare-scan build can take the merge tier: Q5 and Q9), and every warm run
is served from the cache: every scan a hit, zero rows staged and zero
bytes copied. Q12-Q22 are in test_torch_tpch_cached_more.py (a second
file, so the xdist ``loadfile`` workers split them). A port-only test
checks that the warm runs left every cached tensor bitwise as the cold
runs made it.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from trino_tpu.client.session import Session as JaxSession  # noqa: E402
from trino_tpu.devcache import DEVICE_CACHE as JAX_DEVICE_CACHE  # noqa: E402
from trino_tpu.obs import metrics as jax_metrics  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402

from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch.devcache import DEVICE_CACHE, HOST_CACHE  # noqa: E402
from trino_tpu_torch.exec.executor import Executor  # noqa: E402
from trino_tpu_torch.exec.query import plan_sql  # noqa: E402
from trino_tpu_torch.obs import metrics as M  # noqa: E402

TIERS = ("dense", "fused", "merge-sorted", "merge-pallas", "legacy")
PROPS = {"catalog": "tpch", "schema": "tiny", "fused_join_pallas": True,
         "device_cache_enabled": True}


@pytest.fixture(scope="module")
def sessions():
    return JaxSession(properties=dict(PROPS)), TorchSession(dict(PROPS), device="cpu")


def _tiers(metric):
    return {t: metric.value(t) for t in TIERS}


def _run_port(session, sql):
    """(rows, tier deltas, scan dispositions, rows staged, bytes copied)."""
    t0, r0, b0 = _tiers(M.FUSED_JOIN_SELECTIONS), M.STAGED_ROWS.value(), \
        M.STAGED_H2D_BYTES.value()
    ex = Executor(session)
    rows = ex.execute_checked(plan_sql(session, sql)).to_pylist()
    t1 = _tiers(M.FUSED_JOIN_SELECTIONS)
    return (rows, {t: t1[t] - t0[t] for t in TIERS}, sorted(ex.scan_cache.values()),
            M.STAGED_ROWS.value() - r0, M.STAGED_H2D_BYTES.value() - b0)


def _run_jax(session, sql):
    t0 = _tiers(jax_metrics.FUSED_JOIN_SELECTIONS)
    rows = session.execute(sql).rows
    t1 = _tiers(jax_metrics.FUSED_JOIN_SELECTIONS)
    return rows, {t: t1[t] - t0[t] for t in TIERS}


def check_cached_query(jax_session, port_session, q):
    """Cold then warm from empty caches: equal rows and tiers in both
    packages; the cold run stages (a second scan of one table within it may
    hit), the warm run is all hits and stages nothing."""
    for c in (DEVICE_CACHE, HOST_CACHE, JAX_DEVICE_CACHE):
        c.invalidate_all()
    for label in ("cold", "warm"):
        ref, ref_tiers = _run_jax(jax_session, QUERIES[q])
        rows, tiers, dispositions, staged, copied = _run_port(port_session, QUERIES[q])
        assert ref, "the reference returned no rows"
        assert rows == ref, label
        assert tiers == ref_tiers, label
        if label == "cold":
            assert "miss" in dispositions and set(dispositions) <= {"miss", "hit"}
            assert staged > 0 and copied > 0
        else:
            assert dispositions and set(dispositions) == {"hit"}
            assert staged == 0 and copied == 0
    if q in (5, 9):  # a cached sorted build takes them to the merge tier
        assert tiers["merge-sorted"] == 1


@pytest.mark.parametrize("q", range(1, 12))
def test_tpch_tiny_cached_cold_warm(sessions, q):
    check_cached_query(*sessions, q)


def _cached_tensors():
    """{cache key: [tensors]} of every resident artifact: a scan page's
    values, nulls, high limbs and selection, a sorted build's columns, row
    permutation and live flags."""
    out = {}
    for e in DEVICE_CACHE.entries():
        v = e.value
        if hasattr(v, "columns"):
            ts = [t for c in v.columns for t in (c.values, c.nulls, c.hi) if t is not None]
            ts += [v.sel] if v.sel is not None else []
        else:
            ts = list(v.cols) + [v.rows, v.live]
        out[e.key] = ts
    return out


def test_cached_tensors_unchanged_by_warm_runs():
    """Port only: torch tensors are mutable, and a cached page or sorted
    build is shared by every later query. After the 22 warm runs every
    cached tensor is bitwise what the cold runs staged, and no entry was
    replaced."""
    import torch

    for c in (DEVICE_CACHE, HOST_CACHE):
        c.invalidate_all()
    session = TorchSession(dict(PROPS), device="cpu")
    for q in range(1, 23):
        session.execute(QUERIES[q])
    before = _cached_tensors()
    ids = {k: [id(t) for t in ts] for k, ts in before.items()}
    snapshot = {k: [t.clone() for t in ts] for k, ts in before.items()}
    assert any(not hasattr(e.value, "columns") for e in DEVICE_CACHE.entries())  # builds too
    m0 = M.DEVICE_CACHE_MISSES.value()
    for q in range(1, 23):
        session.execute(QUERIES[q])
    assert M.DEVICE_CACHE_MISSES.value() == m0
    after = _cached_tensors()
    assert after.keys() == snapshot.keys()
    for k, ts in after.items():
        assert [id(t) for t in ts] == ids[k]
        for t, s in zip(ts, snapshot[k]):
            assert t.dtype == s.dtype and torch.equal(t, s), k
