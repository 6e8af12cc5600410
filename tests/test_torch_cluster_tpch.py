"""The 22 TPC-H queries at ``tiny`` through the port's distributed path on
the CPU (a coordinator and two workers in this process, the statement
protocol over HTTP), held against the JAX package: rows equal the JAX
Session's after the protocol's JSON rounding (tests/test_torch_cluster.py
``json_round``), and the join tiers the port's workers and root fragment
select equal those of a JAX cluster (coordinator and two workers in this
process) running the same query, as do the plan changes of the adaptive
re-planner, which both coordinators run by default (rules and
descriptions: none on these queries' estimates).
``gather_max_rows_per_device=1``
hash-distributes every grouped final aggregation, as the estimates do at
SF1. Q1-Q11 here, Q12-Q22 in ``_more.py``.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_cluster import jax_rows, rounded, run, start_cluster, stop_cluster  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402

from trino_tpu.obs import metrics as jax_metrics  # noqa: E402
from trino_tpu_torch.obs import metrics as torch_metrics  # noqa: E402

PROPS = {"catalog": "tpch", "schema": "tiny", "fused_join_pallas": True,
         "gather_max_rows_per_device": 1}
TIERS = ("dense", "fused", "merge-sorted", "merge-pallas", "legacy")


@pytest.fixture(scope="module")
def clusters():
    from trino_tpu.server.coordinator import CoordinatorServer as JaxCoordinator
    from trino_tpu.server.worker import WorkerServer as JaxWorker

    coord, ws = start_cluster()
    jcoord = JaxCoordinator()
    jcoord.start()
    jws = [JaxWorker(coordinator_url=jcoord.base_url, node_id=f"jw{i}") for i in range(2)]
    try:
        for w in jws:
            w.start()
        assert coord.registry.wait_for_workers(2, timeout=15.0)
        assert jcoord.registry.wait_for_workers(2, timeout=15.0)
        yield (coord, ws), jcoord
    finally:
        for w in jws:
            w.stop()
        jcoord.stop()
        stop_cluster(coord, ws)


def _tiers(metric):
    return {t: metric.value(t) for t in TIERS}


def check_query(clusters, q):
    (coord, workers), jcoord = clusters
    t0 = _tiers(torch_metrics.FUSED_JOIN_SELECTIONS)
    _, rows = run(coord, QUERIES[q], dict(PROPS))
    t1 = _tiers(torch_metrics.FUSED_JOIN_SELECTIONS)
    assert rounded(rows) == rounded(jax_rows(QUERIES[q], PROPS))
    query = coord.queries[sorted(coord.queries)[-1]]
    assert query.fast_path == "distributed"
    assert {loc.base_url for locs in query.fragment_tasks.values() for loc in locs} == \
        {w.base_url for w in workers}
    from trino_tpu.client.remote import StatementClient as JaxClient

    j0 = _tiers(jax_metrics.FUSED_JOIN_SELECTIONS)
    jclient = JaxClient(jcoord.base_url, dict(PROPS))
    _, jrows = jclient.execute(QUERIES[q], timeout=120.0)
    j1 = _tiers(jax_metrics.FUSED_JOIN_SELECTIONS)
    assert rounded(rows) == rounded(jrows)
    assert {t: t1[t] - t0[t] for t in TIERS} == {t: j1[t] - j0[t] for t in TIERS}
    # adaptive execution is on by default in both: the same plan changes
    # (none on correct estimates)
    jversions = jcoord.get_query(jclient.query_id).plan_versions
    assert [(c["rule"], c["description"]) for c in query.plan_versions] == \
        [(c["rule"], c["description"]) for c in jversions]


@pytest.mark.parametrize("q", [q for q in sorted(QUERIES) if q <= 11])
def test_tpch_query_through_the_cluster(clusters, q):
    check_query(clusters, q)
