"""The port's adaptive distributed path (trino_tpu_torch/adaptive/,
parallel/exchange.py, the salting half of server/task.py and the
coordinator's stage-boundary hook) held against the JAX package's on the
same inputs:

- ``_hot_partitions``, ``spread_partition_ids`` and ``RuntimeStatsProvider``
  against the reference's over seeded numpy inputs;
- both ``AdaptivePlanner``s over the same fragments (both packages plan the
  same SQL from the same plan-node id) and the same stub stats: equal
  ``PlanChange.to_dict()`` for the join flips both ways, capacity
  reseeding, skew mitigation, and the contained rollback of a rewrite that
  fails plan validation;
- both flips on a port cluster and a JAX cluster under the same lie about
  ``customer``'s row count: equal ``planVersions`` (the join's plan-node id
  aside: each package numbers nodes from its own counter) and equal rows,
  the superseded tasks canceled, and EXPLAIN ANALYZE's ``[adapted: ...]``
  annotations;
- salted producers: the re-planner run on the stage stats of a finished
  hot-key join, and its salted producers scheduled through the
  coordinator's task seam, give the unsalted rows with the hot partition's
  probe rows spread.

Rows compare exactly after the protocol's JSON rounding.
"""
import copy
import itertools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_cluster import rounded, start_cluster, stop_cluster  # noqa: E402
from test_torch_operator_stats import _masked  # noqa: E402

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from trino_tpu.adaptive import replanner as jax_rp  # noqa: E402
from trino_tpu.adaptive.runtime_stats import RuntimeStatsProvider as JaxProvider  # noqa: E402
from trino_tpu.parallel.exchange import spread_partition_ids as jax_spread  # noqa: E402

from trino_tpu_torch.adaptive import replanner as torch_rp  # noqa: E402
from trino_tpu_torch.adaptive.runtime_stats import RuntimeStatsProvider  # noqa: E402
from trino_tpu_torch.parallel.exchange import spread_partition_ids  # noqa: E402
from trino_tpu_torch.server import wire  # noqa: E402

TINY = {"catalog": "tpch", "schema": "tiny"}
FLIP_SQL = """
    select c_mktsegment, count(*) c from customer, orders
    where c_custkey = o_custkey group by c_mktsegment order by 1
"""
# one hot join key (90% of lineitem's rows), projected in a subquery so the
# join is an equi-join on a column
SKEW_SQL = """
    select count(*) c, sum(p.v) s
    from (select case when l_orderkey % 10 < 9 then cast(1 as bigint)
                      else l_orderkey end as k,
                 l_orderkey as v from lineitem) p, orders o
    where p.k = o.o_orderkey
"""


# ------------------------------------------------------------- the units
@pytest.mark.parametrize("seed", range(8))
def test_hot_partitions_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 9))
        rows = rng.integers(0, 5000, n)
        if rng.random() < 0.5:
            rows[int(rng.integers(0, n))] = int(rng.integers(4096, 200_000))
        threshold = int(rng.integers(1, 12))
        assert torch_rp.AdaptivePlanner._hot_partitions(rows.tolist(), threshold) == \
            jax_rp.AdaptivePlanner._hot_partitions(rows.tolist(), threshold)
    assert torch_rp.AdaptivePlanner._hot_partitions([50_000, 1_000], 4) == [0]
    assert torch_rp.AdaptivePlanner._hot_partitions([100, 1], 4) == []
    assert (torch_rp.SKEW_MIN_HOT_ROWS, torch_rp.SKEW_REPLICATE_MAX_BYTES) == \
        (jax_rp.SKEW_MIN_HOT_ROWS, jax_rp.SKEW_REPLICATE_MAX_BYTES)


@pytest.mark.parametrize("seed", range(8))
def test_spread_partition_ids_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    n_parts = int(rng.integers(2, 9))
    pid = rng.integers(0, n_parts, int(rng.integers(0, 2000))).astype(np.int64)
    hot = sorted(set(rng.integers(0, n_parts, int(rng.integers(1, 3))).tolist()))
    cursor = jcursor = int(rng.integers(0, n_parts))
    for _ in range(3):  # the cursor carried across pages
        before = pid.copy()
        got, cursor = spread_partition_ids(pid, hot, n_parts, start=cursor)
        want, jcursor = jax_spread(pid, hot, n_parts, start=jcursor)
        assert got.tolist() == want.tolist() and cursor == jcursor
        assert pid.tolist() == before.tolist()  # never mutated
        cold = ~np.isin(pid, hot)
        assert got[cold].tolist() == pid[cold].tolist()


def _entries(rng, n_frags=3):
    states = ("RUNNING", "FLUSHING", "FINISHED")
    out = []
    for fid in range(n_frags):
        for _ in range(int(rng.integers(1, 4))):
            st = {"outputRows": int(rng.integers(0, 10**6))}
            if rng.random() < 0.7:
                st["partitionRows"] = rng.integers(0, 10**4, 3).tolist()
                st["partitionBytes"] = rng.integers(0, 10**6, 3).tolist()
            out.append({"fragment": fid, "state": states[int(rng.integers(0, 3))], "stats": st})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_runtime_stats_provider_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    entries = _entries(rng)
    expected = {fid: int(rng.integers(1, 4)) for fid in range(4)}
    sweeps = []
    for with_expected in (False, True):
        fn = expected.get if with_expected else None
        mine = RuntimeStatsProvider(lambda: copy.deepcopy(entries), sweep_fn=lambda: sweeps.append(1),
                                    expected_tasks_fn=(lambda f: expected.get(f, 0)) if fn else None)
        ref = JaxProvider(lambda: copy.deepcopy(entries),
                          expected_tasks_fn=(lambda f: expected.get(f, 0)) if fn else None)
        assert mine.snapshot() is mine
        ref.snapshot()
        for fid in range(4):
            assert mine.stage_flushed(fid) == ref.stage_flushed(fid)
            assert mine.output_rows(fid) == ref.output_rows(fid)
            assert mine.partition_rows(fid) == ref.partition_rows(fid)
            assert mine.partition_bytes(fid) == ref.partition_bytes(fid)
    assert len(sweeps) == 2


def test_runtime_stats_provider_gates_on_flushed():
    entries = [{"fragment": 0, "state": "FLUSHING",
                "stats": {"outputRows": 5, "partitionRows": [1, 4]}},
               {"fragment": 0, "state": "RUNNING", "stats": {"outputRows": 99}}]
    p = RuntimeStatsProvider(lambda: entries).snapshot()
    assert p.output_rows(0) is None and p.partition_rows(0) is None
    entries[1] = {"fragment": 0, "state": "FINISHED",
                  "stats": {"outputRows": 99, "partitionRows": [2, 0]}}
    p.snapshot()
    assert p.output_rows(0) == 104 and p.partition_rows(0) == [3, 4]
    # a stage with fewer slot records than scheduled tasks is not flushed
    p3 = RuntimeStatsProvider(lambda: entries, expected_tasks_fn=lambda f: 3).snapshot()
    assert p3.output_rows(0) is None


# ---------------------------------- both planners, same fragments and stats
def _lie(monkeypatch, table, value):
    from trino_tpu.connector.tpch.connector import TpchConnector as JaxTpch

    from trino_tpu_torch.connector.tpch.connector import TpchConnector

    for cls in (TpchConnector, JaxTpch):
        orig = cls.table_row_count

        def lying(self, schema, t, _orig=orig):
            return value if t == table else _orig(self, schema, t)

        monkeypatch.setattr(cls, "table_row_count", lying)


def _fragments(pkg, sql, props, monkeypatch):
    """Both packages' fragments of ``sql``, numbered from the same plan-node
    id so the two plans carry equal ids."""
    if pkg == "torch":
        from trino_tpu_torch import Session
        from trino_tpu_torch.exec.query import plan_sql
        from trino_tpu_torch.sql.planner import plan as P
        from trino_tpu_torch.sql.planner.fragmenter import fragment_plan

        session = Session(dict(props), device="cpu")
    else:
        from trino_tpu.client.session import Session
        from trino_tpu.exec.query import plan_sql
        from trino_tpu.sql.planner import plan as P
        from trino_tpu.sql.planner.fragmenter import fragment_plan

        session = Session(dict(props))
    monkeypatch.setattr(P, "_next_plan_id", itertools.count(10**6))
    return session, fragment_plan(plan_sql(session, sql), session)


def _adapt_all(pkg, sql, props, stats_of, monkeypatch, n_workers=2):
    """Run the package's AdaptivePlanner over every non-root fragment in
    schedule order, as the coordinator does, against stub stats
    (``stats_of(fragments)`` -> slot records). Returns (change dicts,
    errors, the fragments' EXPLAIN (TYPE DISTRIBUTED) text)."""
    if pkg == "torch":
        from trino_tpu_torch.adaptive import AdaptivePlanner
        from trino_tpu_torch.sql.planner.fragmenter import format_fragments, fresh_fragment_ids
        provider_cls = RuntimeStatsProvider
    else:
        from trino_tpu.adaptive import AdaptivePlanner
        from trino_tpu.sql.planner.fragmenter import format_fragments, fresh_fragment_ids
        provider_cls = JaxProvider
    session, frags = _fragments(pkg, sql, props, monkeypatch)
    entries = stats_of(frags)
    planner = AdaptivePlanner(session, provider_cls(lambda: copy.deepcopy(entries)), n_workers,
                              fresh_fragment_ids(frags))
    by_id = {f.id: f for f in frags}
    changes, errors = [], []
    for frag in list(frags):
        if frag.partitioning == "single":
            continue
        new, chs, errs = planner.adapt_fragment(frag, by_id)
        for nf in new:
            frags.insert(frags.index(frag), nf)
        changes += [c.to_dict() for c in chs]
        errors += errs
    skew = [(f.id, f.skew_spread_partitions, f.skew_replicate_partitions) for f in frags
            if getattr(f, "skew_spread_partitions", None)
            or getattr(f, "skew_replicate_partitions", None)]
    return changes, errors, format_fragments(frags), skew


def _flushed(frags, rows_of, parts_of=None):
    """Two FLUSHING task records a leaf fragment, splitting its rows."""
    out = []
    for f in frags:
        if f.partitioning == "single":
            continue
        total = rows_of(f)
        for i in range(2):
            st = {"outputRows": total // 2 + (total % 2 if i == 0 else 0)}
            if parts_of is not None and parts_of(f) is not None:
                st["partitionRows"] = [r // 2 for r in parts_of(f)]
                st["partitionBytes"] = [r * 4 for r in parts_of(f)]
            out.append({"fragment": f.id, "state": "FLUSHING", "stats": st})
    return out


def _rows_by_table(f):
    return 1500 if _scan_table_any(f) == {"customer"} else 15000


def _scan_table_any(f):
    out = set()
    stack = [f.root]
    while stack:
        n = stack.pop()
        if type(n).__name__ == "TableScanNode":
            out.add(n.table)
        stack.extend(n.sources)
    return out


CASES = {
    "broadcast->partitioned": (10, {"join_max_broadcast_rows": 200}, None),
    "partitioned->broadcast": (10**6, {"join_max_broadcast_rows": 2000}, None),
    "capacity-reseed": (None, {"adaptive_capacity_reseed": True}, None),
    # the build's actual rows stay over the limit (no flip); the probe's
    # first partition holds the hot key
    "skew-mitigation": (10**6, {"join_max_broadcast_rows": 1000, "adaptive_skew_threshold": 4},
                        (lambda f: 10**6 if _scan_table_any(f) == {"customer"} else 20000,
                         lambda f: [180_000, 2_000] if _scan_table_any(f) == {"orders"}
                         else [600, 600])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_planners_make_equal_changes(case, monkeypatch):
    lie, extra, stub = CASES[case]
    if lie is not None:
        _lie(monkeypatch, "customer", lie)
    props = dict(TINY, **extra)
    rows_of, parts_of = stub if stub is not None else (_rows_by_table, None)
    got = {pkg: _adapt_all(pkg, FLIP_SQL, props,
                           lambda frags: _flushed(frags, rows_of, parts_of), monkeypatch)
           for pkg in ("torch", "jax")}
    assert got["torch"] == got["jax"]
    changes, errors, _text, skew = got["torch"]
    assert errors == []
    rules = [c["rule"] for c in changes]
    if "->" in case:
        assert rules == ["join-distribution"]
        assert changes[0]["description"] == case and changes[0]["detail"]["buildRows"] == 1500
    elif case == "skew-mitigation":
        assert rules == ["skew-mitigation"] and changes[0]["detail"]["hotPartitions"] == [0]
        # one producer spreads the hot partition, the other replicates it
        assert len(skew) == 2 and {s[1] is None for s in skew} == {True, False}
    else:
        assert rules and set(rules) == {"capacity-reseed"}
        assert all(c["detail"]["runtimeRows"] for c in changes)


def test_contained_rollback_equals_the_reference(monkeypatch):
    """A flip whose rewritten fragments fail plan validation is rolled back
    to the pre-adaptation plan, recorded as an error, in both packages."""
    from trino_tpu.sql.planner import sanity as jax_sanity

    from trino_tpu_torch.sql.planner import sanity

    def broken(*args, **kwargs):
        raise ValueError("injected validation failure")

    for mod in (sanity, jax_sanity):
        monkeypatch.setattr(mod, "validate_adapted", broken)
    _lie(monkeypatch, "customer", 10)
    props = dict(TINY, join_max_broadcast_rows=200, plan_validation=True)
    stats = (lambda frags: _flushed(frags, _rows_by_table))
    got = {pkg: _adapt_all(pkg, FLIP_SQL, props, stats, monkeypatch) for pkg in ("torch", "jax")}
    assert got["torch"] == got["jax"]
    changes, errors, text, _skew = got["torch"]
    assert changes == [] and len(errors) == 1
    assert "contained plan-validation failure" in errors[0]
    # the plan is the unadapted one
    _s, frags = _fragments("torch", FLIP_SQL, props, monkeypatch)
    from trino_tpu_torch.sql.planner.fragmenter import format_fragments

    assert text == format_fragments(frags)


# ------------------------------------------------------------ the clusters
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
        yield coord, jcoord
    finally:
        for w in jws:
            w.stop()
        jcoord.stop()
        stop_cluster(coord, ws)


def _run(base_url, sql, props, jax=False):
    if jax:
        from trino_tpu.client.remote import StatementClient
    else:
        from trino_tpu_torch.client.remote import StatementClient
    client = StatementClient(base_url, {k: str(v) for k, v in props.items()})
    _cols, rows = client.execute(sql, timeout=120.0)
    return client, rows


def _without_join_id(changes):
    return [dict(c, detail={k: v for k, v in c["detail"].items() if k != "join"})
            for c in changes]


@pytest.mark.parametrize("lie,limit,direction", [
    (10, 200, "broadcast->partitioned"), (10**6, 2000, "partitioned->broadcast")])
def test_flips_on_both_clusters(clusters, monkeypatch, lie, limit, direction):
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.sql.planner import plan as P

    coord, jcoord = clusters
    _lie(monkeypatch, "customer", lie)
    props = dict(TINY, join_max_broadcast_rows=limit)
    _c, rows_off = _run(coord.base_url, FLIP_SQL, dict(props, adaptive_execution_enabled="false"))
    flips0 = M.ADAPTIVE_JOIN_FLIPS.value(
        "to_partitioned" if direction.endswith("partitioned") else "to_broadcast")
    client, rows = _run(coord.base_url, FLIP_SQL, props)
    jclient, jrows = _run(jcoord.base_url, FLIP_SQL, props, jax=True)
    assert rounded(rows) == rounded(rows_off) == rounded(jrows) and len(rows) == 5
    info = wire.json_request("GET", f"{coord.base_url}/v1/query/{client.query_id}")
    jinfo = wire.json_request("GET", f"{jcoord.base_url}/v1/query/{jclient.query_id}")
    assert _without_join_id(info["planVersions"]) == _without_join_id(jinfo["planVersions"])
    (change,) = info["planVersions"]
    assert change["description"] == direction and change["detail"]["buildRows"] == 1500
    assert client.stats["adaptations"] == 1
    assert M.ADAPTIVE_JOIN_FLIPS.value(
        "to_partitioned" if direction.endswith("partitioned") else "to_broadcast") == flips0 + 1
    q = coord.get_query(client.query_id)
    join = next(n for f in q.fragments for n in P.walk_plan(f.root)
                if isinstance(n, P.JoinNode) and f.id == change["fragment"])
    assert join.id == change["detail"]["join"]
    # the superseded producers were canceled: their workers dropped them
    for fid in change["supersedes"]:
        for loc in q.fragment_tasks[fid]:
            status, _b, _h = wire.http_request(
                "GET", f"{loc.base_url}/v1/task/{loc.task_id}/status", timeout=10.0)
            assert status == 404
    spans = [s for s in q.tracer.spans() if s.name == "plan/adapt"]
    assert [s.attributes.get("description") for s in spans] == [direction]
    assert not any("error" in s.attributes for s in spans)


def test_adapted_annotations_equal_the_reference(clusters, monkeypatch):
    coord, jcoord = clusters
    _lie(monkeypatch, "customer", 10)
    props = dict(TINY, join_max_broadcast_rows=200)
    _c, rows = _run(coord.base_url, "explain analyze " + FLIP_SQL, props)
    _j, jrows = _run(jcoord.base_url, "explain analyze " + FLIP_SQL, props, jax=True)
    text = "\n".join(r[0] for r in rows)
    assert "[adapted: broadcast->partitioned]" in text and "[adapted: superseded]" in text
    assert _masked(text, False) == _masked("\n".join(r[0] for r in jrows), False)


def _chip_smoke():
    """chip_smoke.py, whose phase adaptive and task seam these tests run."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_salted_producers_give_the_unsalted_rows(clusters):
    """The re-planner runs on the stage stats of a finished hot-key join
    (adaptation off, so no rule acted mid-query), salts both producers, and
    the salted fragments, scheduled through the coordinator's task seam,
    give the unsalted rows, with the probe's hot partition spread
    (``chip_smoke.run_fragments`` schedules them, as phase adaptive does)."""
    from trino_tpu.client.session import Session as JaxSession

    from trino_tpu_torch.adaptive import AdaptivePlanner
    from trino_tpu_torch.sql.planner.fragmenter import fresh_fragment_ids

    coord, _ = clusters
    props = dict(TINY, join_max_broadcast_rows=100, adaptive_skew_threshold=4)
    client, rows = _run(coord.base_url, SKEW_SQL, dict(props, adaptive_execution_enabled="false"))
    assert rounded(rows) == rounded(JaxSession(dict(TINY)).execute(SKEW_SQL).rows)
    q = coord.get_query(client.query_id)
    frags = copy.deepcopy(q.fragments)
    by_id = {f.id: f for f in frags}
    entries = [dict(e) for e in q.task_stats.values()]
    planner = AdaptivePlanner(coord.session_factory(dict(props)),
                              RuntimeStatsProvider(lambda: entries), 2, fresh_fragment_ids(frags))
    join_frag = next(f for f in frags if f.partitioning == "hash")
    new, changes, errors = planner.adapt_fragment(join_frag, by_id)
    assert errors == [] and [c.rule for c in changes] == ["skew-mitigation"]
    detail = changes[0].detail
    pr, (hot,) = detail["probePartitionRows"], detail["hotPartitions"]
    assert pr[hot] > 4 * (sum(pr) - pr[hot])
    salted = [f for f in frags if f.id not in changes[0].supersedes]
    for nf in new:
        salted.insert(salted.index(join_frag), nf)
    salted_rows, sq = _chip_smoke().run_fragments(coord, props, salted)
    assert rounded(salted_rows) == rounded(rows)
    probe = [e["stats"]["partitionRows"] for e in sq.task_stats.values()
             if e["fragment"] == new[0].id]
    spread = [sum(p) for p in zip(*probe)]
    assert sum(spread) == sum(pr) and max(spread) < 2 * min(spread)


def test_chip_smoke_phase_adaptive_at_tiny():
    """chip_smoke.py's phase adaptive at tiny on the CPU, against the JAX
    Session's rows of Q1, Q3, Q17 and Q18 (the card runs it at SF1 against
    tpch_sf1_expected.json): both flips, reseeding, the salted join, the
    EXPLAIN ANALYZE checks and the compile ledger."""
    import torch

    from trino_tpu.client.session import Session as JaxSession
    from tpch_sql import QUERIES

    chip_smoke = _chip_smoke()
    jax = JaxSession(dict(TINY))
    expected = {str(q): {"sql": QUERIES[q], "rows": chip_smoke.jsonable_rows(
        jax.execute(QUERIES[q]).rows)} for q in (1, 3, 17, 18)}
    with chip_smoke.MergeCapture() as cap:
        out = chip_smoke.phase_adaptive(torch.device("cpu"), expected, None, cap, "cpu",
                                        schema="tiny")
    assert [f["direction"] for f in out["flips"]] == ["broadcast->partitioned",
                                                      "partitioned->broadcast"]
    assert all(f["change"]["detail"]["buildRows"] == 1500 for f in out["flips"])
    assert [r["query"] for r in out["reseed"]] == ["Q3", "Q18"]
    assert len(out["salted"]["hot"]) == 1
    assert len(out["explain"]) == 4
    assert [e["cache"] for e in out["compile_ledger"]["events"]] == ["miss", "hit"]
