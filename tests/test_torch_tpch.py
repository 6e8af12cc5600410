"""TPC-H Q1-Q9, Q17 and Q18 through both Sessions: the JAX package
(trino_tpu) is the reference, the PyTorch port (trino_tpu_torch) runs on
the CPU here. The other queries are in test_torch_tpch_more.py (a second
file, so the xdist ``loadfile`` workers split them).

Also the writer of the port's SF1 expected rows, which the GPU smoke run
(chip_smoke.py) compares against on a machine without JAX:

    JAX_PLATFORMS=cpu python tests/test_torch_tpch.py --write-expected
"""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
import trino_tpu.ops.join as jax_join  # noqa: E402
from trino_tpu.client.session import Session as JaxSession  # noqa: E402
from trino_tpu.obs import metrics as jax_metrics  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402

import trino_tpu_torch.ops.join as torch_join  # noqa: E402
from trino_tpu_torch import Session as TorchSession  # noqa: E402
from trino_tpu_torch.obs import metrics as torch_metrics  # noqa: E402

EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "trino_tpu_torch", "testdata", "tpch_sf1_expected.json")
TIERS = ("dense", "fused", "merge-sorted", "merge-pallas", "legacy")


def _props(schema="tiny"):
    return {"catalog": "tpch", "schema": schema, "fused_join_pallas": True}


def _tier_counts(metric):
    return {t: metric.value(t) for t in TIERS}


def run_both(sql):
    """(reference rows, port rows, reference tier deltas, port tier deltas)."""
    j0 = _tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
    ref = JaxSession(properties=_props()).execute(sql).rows
    j1 = _tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
    t0 = _tier_counts(torch_metrics.FUSED_JOIN_SELECTIONS)
    got = TorchSession(properties=_props(), device="cpu").execute(sql).rows
    t1 = _tier_counts(torch_metrics.FUSED_JOIN_SELECTIONS)
    return (ref, got, {t: j1[t] - j0[t] for t in TIERS},
            {t: t1[t] - t0[t] for t in TIERS})


def check_query(q):
    """Exact rows and equal join-tier selections in both packages."""
    ref, got, jt, tt = run_both(QUERIES[q])
    assert ref, "the reference returned no rows"
    assert got == ref
    assert tt == jt  # same join tiers in both packages


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 6, 7, 8, 9, 17, 18])
def test_tpch_tiny_rows_equal(q):
    check_query(q)


def test_q18_tiny_merge_tier_forced(monkeypatch):
    """With the dense tier priced out in both packages, Q18 takes the merge
    tier (presorted build, single int32 key): the JAX package runs its
    Pallas kernel in interpret mode, the port its plain merge on the CPU."""
    monkeypatch.setattr(jax_join, "DENSE_SPAN_MAX", 0)
    monkeypatch.setattr(torch_join, "DENSE_SPAN_MAX", 0)
    ref, got, jt, tt = run_both(QUERIES[18])
    assert got == ref
    assert jt["merge-pallas"] >= 1
    assert tt == jt


def test_session_without_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default session is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSession(properties=_props())


def test_expected_rows_file_matches_queries():
    """The committed SF1 rows carry the SQL the smoke run executes, for all
    22 queries, with the reference's join-tier selections."""
    with open(EXPECTED) as f:
        data = json.load(f)
    assert data["scale"] == "sf1"
    assert sorted(data["queries"], key=int) == [str(q) for q in range(1, 23)]
    for q in range(1, 23):
        entry = data["queries"][str(q)]
        assert entry["sql"] == QUERIES[q]
        assert entry["rows"] and all(len(r) == len(entry["columns"]) for r in entry["rows"])
        assert set(entry["tiers"]) == set(TIERS)
    assert data["queries"]["17"]["tiers"]["merge-pallas"] >= 1
    assert data["queries"]["18"]["tiers"]["merge-pallas"] >= 1


def jsonable_rows(rows):
    """Rows with decimals and dates as strings (chip_smoke.py's form)."""
    return [[v if v is None or isinstance(v, (int, float, str)) else str(v) for v in r]
            for r in rows]


def write_expected():
    session = JaxSession(properties=_props("sf1"))
    out = {"scale": "sf1", "writer": "trino_tpu (JAX, CPU) via "
           "tests/test_torch_tpch.py --write-expected", "queries": {}}
    for q in range(1, 23):
        t0 = _tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
        res = session.execute(QUERIES[q])
        t1 = _tier_counts(jax_metrics.FUSED_JOIN_SELECTIONS)
        out["queries"][str(q)] = {"sql": QUERIES[q], "columns": list(res.column_names),
                                  "rows": jsonable_rows(res.rows),
                                  "tiers": {t: t1[t] - t0[t] for t in TIERS}}
        print(f"Q{q}: {len(res.rows)} rows", flush=True)
    with open(EXPECTED, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-expected"]:
        write_expected()
    else:
        sys.exit("usage: python tests/test_torch_tpch.py --write-expected")
