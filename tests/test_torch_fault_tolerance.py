"""The port's fault-tolerant tier (``retry_policy=TASK`` over the durable
spool of ``TRINO_TPU_SPOOL_DIR``: server/task.py's spooled outputs,
server/exchange_client.py's spool read-back, the coordinator's stage-by-
stage scheduler with retries and speculative attempts) held against the
JAX package's:

- the 9 cases of the reference's tests/test_fault_tolerance.py, each on a
  port CPU cluster and a JAX CPU cluster (two workers each) with the same
  SQL and the same injection keys: equal rows (exact, after the protocol's
  JSON values), equal terminal states and failure messages (query ids
  masked), the same retried and winning slots, and no file of the query
  left in either spool directory;
- spool files written by either package read back through the other's
  exchange client, byte for byte the same frames;
- a canceled attempt that wakes after its query ended publishes nothing in
  the port (the reference's publishes its file after the cleanup: ROADMAP
  queue 3, faults of the reference the port repairs);
- ``tests/test_adaptive.py::test_skew_mitigation_salts_hot_partitions``:
  skew salting through the scheduler under the fault-tolerant tier, over
  the reference's filesystem tables (needs ``pyarrow``) and over the same
  hot key computed from tpch.tiny.lineitem, joined to orders (runs
  everywhere; the memory catalog's scans run on the coordinator alone, so
  it cannot feed a distributed join);
- ``tests/test_tracing.py::test_fte_retry_reparents_into_same_trace_exactly_once``;
- a ``cuda``-marked case: an injected failure retried on the card, and
  ``torch.cuda.memory_allocated()`` back where it started.

Each package's queries run against a spool directory of its own (the
environment variable is read at each call).
"""
import os
import re
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)

from torch_obs_common import BOTH, JAX, TINY, TORCH, start_cluster, stop_cluster  # noqa: E402

PKGS = {pkg.name: pkg for pkg in BOTH}

SQL = """
    select o_orderpriority, count(*) as c from orders
    group by o_orderpriority order by o_orderpriority
"""
FTE = {**TINY, "retry_policy": "TASK"}


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    # the servers' segment stores take their directory at construction
    root = tmp_path_factory.mktemp("fte")
    old = os.environ.get("TRINO_TPU_SPOOL_DIR")
    os.environ["TRINO_TPU_SPOOL_DIR"] = str(root / "boot")
    started = {}
    try:
        for pkg in BOTH:
            started[pkg.name] = start_cluster(pkg, f"fte-{pkg.name}-")
        yield {name: c for name, (c, _ws) in started.items()}
    finally:
        for coord, ws in started.values():
            stop_cluster(coord, ws)
        if old is None:
            os.environ.pop("TRINO_TPU_SPOOL_DIR", None)
        else:
            os.environ["TRINO_TPU_SPOOL_DIR"] = old


class Run:
    """One statement's outcome on one package's cluster."""

    def __init__(self, pkg, coord, spool, client, rows, error, wall):
        self.pkg, self.coord, self.spool = pkg, coord, spool
        self.client, self.rows, self.error, self.wall = client, rows, error, wall
        self.q = coord.get_query(client.query_id) if client.query_id else None

    def leftover(self, timeout=2.0):
        """The spool files of this query still there after ``timeout``
        seconds at most (the reference cleans up just after the terminal
        transition)."""
        deadline = time.monotonic() + timeout
        while True:
            left = sorted(f for f in (os.listdir(self.spool) if self.spool.exists() else ())
                          if self.q is not None and f.startswith(self.q.query_id))
            if not left or time.monotonic() > deadline:
                return left
            time.sleep(0.05)

    def mask(self, text):
        """``text`` with this query's id as ``<q>``."""
        return text.replace(self.q.query_id, "<q>") if self.q is not None else text


def run_one(pkg, coord, spool, monkeypatch, sql, props, timeout=120.0):
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(spool))
    client = pkg.remote.StatementClient(coord.base_url, {k: str(v) for k, v in props.items()})
    t0 = time.monotonic()
    rows = error = None
    try:
        _cols, rows = client.execute(sql, timeout=timeout)
    except pkg.remote.RemoteQueryError as e:
        error = str(e)
    return Run(pkg, coord, spool, client, rows, error, time.monotonic() - t0)


def run_both(clusters, monkeypatch, tmp_path, sql, props):
    """The statement on the port's cluster, then on the reference's, each
    with its own spool directory; the port's spool holds no file of the
    query as soon as the client has its answer."""
    out = {}
    for pkg in (TORCH, JAX):
        r = run_one(pkg, clusters[pkg.name], tmp_path / pkg.name, monkeypatch, sql, props)
        if pkg is TORCH:
            assert r.leftover(timeout=0) == []
        out[pkg.name] = r
    return out


def _slots(ids, q):
    """Task ids with their query's id as ``<q>``, sorted."""
    return sorted(t.replace(q.query_id, "<q>") for t in ids)


def test_fte_runs_and_spools(clusters, monkeypatch, tmp_path):
    runs = run_both(clusters, monkeypatch, tmp_path, SQL, FTE)
    t, j = runs["torch"], runs["jax"]
    assert t.error is None and j.error is None
    assert t.rows == j.rows and len(t.rows) == 5
    assert t.q.state.get() == j.q.state.get() == "FINISHED"
    assert t.leftover() == j.leftover() == []
    assert t.q.retried_tasks == j.q.retried_tasks == []
    # every task spooled before it finished, and each consumer read the
    # spool: the source stage's files existed while the query ran
    assert _slots(t.q.task_attempts, t.q) == _slots(j.q.task_attempts, j.q)
    assert set(t.q.task_attempts.values()) == {0}


def test_fte_requires_spool(clusters, monkeypatch, tmp_path):
    for pkg in (TORCH, JAX):
        monkeypatch.delenv("TRINO_TPU_SPOOL_DIR", raising=False)
        client = pkg.remote.StatementClient(clusters[pkg.name].base_url, dict(FTE))
        with pytest.raises(pkg.remote.RemoteQueryError, match="TRINO_TPU_SPOOL_DIR"):
            client.execute(SQL, timeout=60.0)


def test_fte_retries_injected_failure(clusters, monkeypatch, tmp_path):
    """Slot 0's first attempt of fragment 0 fails; its a1 on the next worker
    wins, and no other slot retries (a key for a0 never fires on a1)."""
    runs = run_both(clusters, monkeypatch, tmp_path, SQL,
                    {**FTE, "failure_injection": ".0.0.a0"})
    t, j = runs["torch"], runs["jax"]
    assert t.error is None and j.error is None and t.rows == j.rows
    assert _slots(t.q.retried_tasks, t.q) == _slots(j.q.retried_tasks, j.q) == ["<q>.0.0.a0"]
    assert _slots(t.q.task_attempts, t.q) == _slots(j.q.task_attempts, j.q)
    assert t.q.task_attempts[f"{t.q.query_id}.0.0.a1"] == 1
    tasks = [loc.task_id for locs in t.q.fragment_tasks.values() for loc in locs]
    assert f"{t.q.query_id}.0.0.a1" in tasks
    info = TORCH.wire.json_request("GET", f"{t.coord.base_url}/v1/query/{t.q.query_id}")
    assert info["retriedTasks"] == [f"{t.q.query_id}.0.0.a0"]
    assert info["taskAttempts"][f"{t.q.query_id}.0.0.a1"] == 1
    assert t.leftover() == j.leftover() == []


_FAILED_AFTER = re.compile(r"task \S+ failed after \d+ attempts: injected failure for \S+")


def test_fte_fails_after_max_attempts(clusters, monkeypatch, tmp_path):
    runs = run_both(clusters, monkeypatch, tmp_path, SQL,
                    {**FTE, "failure_injection": ".0.0.a"})  # every attempt of slot 0
    t, j = runs["torch"], runs["jax"]
    assert t.q.state.get() == j.q.state.get() == "FAILED"
    msgs = [r.mask(_FAILED_AFTER.search(r.error).group(0)) for r in (t, j)]
    assert msgs[0] == msgs[1] == "task 0.0 failed after 3 attempts: injected failure for <q>.0.0.a2"
    assert _slots(t.q.retried_tasks, t.q) == _slots(j.q.retried_tasks, j.q) == [
        "<q>.0.0.a0", "<q>.0.0.a1", "<q>.0.0.a2"]
    assert t.leftover() == j.leftover() == []


def _frames_page(pkg, values):
    """One framed serialized BIGINT page of ``values``."""
    if pkg is TORCH:
        import torch

        from trino_tpu_torch import types as T
        from trino_tpu_torch.data.page import Column, Page
        from trino_tpu_torch.data.serde import serialize_page

        page = Page([Column(T.BIGINT, torch.tensor(values, dtype=torch.int64))], None)
    else:
        import jax.numpy as jnp

        from trino_tpu import types as T
        from trino_tpu.data.page import Column, Page
        from trino_tpu.data.serde import serialize_page

        page = Page([Column(T.BIGINT, jnp.asarray(values, dtype=jnp.int64))])
    return pkg.wire.frame_pages([serialize_page(page)])


def test_spool_fallback_serves_dead_producer(clusters, monkeypatch, tmp_path):
    """A consumer whose producer is unreachable reads the spooled output,
    and each package reads the other's spool file: the files are the same
    bytes."""
    from trino_tpu.server.exchange_client import ExchangeClient as JaxClient
    from trino_tpu.server.exchange_client import TaskLocation as JaxLocation

    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.server.exchange_client import ExchangeClient, TaskLocation

    spool = tmp_path / "spool"
    spool.mkdir()
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(spool))
    files = {pkg.name: _frames_page(pkg, [1, 2, 3]) for pkg in BOTH}
    assert files["torch"] == files["jax"]
    for writer in BOTH:
        (spool / f"qdead{writer.name}.9.0.a0.pages").write_bytes(files[writer.name])
        reads0, bytes0 = M.SPOOL_READS.value(), M.SPOOL_BYTES.value()
        from trino_tpu_torch.obs import metrics as TM

        exch0 = TM.EXCHANGE_BYTES.value()
        client = ExchangeClient([TaskLocation("http://127.0.0.1:9", f"qdead{writer.name}.9.0.a0")])
        client.start()
        pages = client.pages()
        assert len(pages) == 1 and pages[0].to_pylist() == [(1,), (2,), (3,)]
        assert M.SPOOL_READS.value() == reads0 + 1
        assert M.SPOOL_BYTES.value() == bytes0 + len(files[writer.name])
        assert TM.EXCHANGE_BYTES.value() == exch0  # disk bytes, not network ones
        jclient = JaxClient([JaxLocation("http://127.0.0.1:9", f"qdead{writer.name}.9.0.a0")])
        jclient.start()
        jpages = jclient.pages()
        assert len(jpages) == 1 and jpages[0].to_pylist() == [(1,), (2,), (3,)]


def test_port_task_spool_files_read_by_the_reference(clusters, monkeypatch, tmp_path):
    """A port task's own spool files (the source stage of a hash-partitioned
    aggregation, a file a partition) read back through the reference's
    ``wire.unframe_pages`` and ``deserialize_page`` to the port's pages, and
    the cleanup leaves nothing."""
    import numpy as np

    from trino_tpu.data.serde import deserialize_page as jax_deserialize
    from trino_tpu.server import wire as jax_wire

    from trino_tpu_torch.data.serde import deserialize_page
    from trino_tpu_torch.exec.query import plan_sql
    from trino_tpu_torch.server import wire
    from trino_tpu_torch.server.coordinator import QueryExecution
    from trino_tpu_torch.sql.planner import plan as P
    from trino_tpu_torch.sql.planner.fragmenter import RemoteSourceNode, fragment_plan

    spool = tmp_path / "spool"
    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(spool))
    coord = clusters["torch"]
    props = {**FTE, "gather_max_rows_per_device": "1000"}
    session = coord.session_factory(dict(props))
    frags = fragment_plan(plan_sql(session, "select o_custkey, count(*) from orders "
                                            "group by o_custkey"), session)
    workers = coord.registry.alive()
    counts = {n.fragment_id: len(workers) for f in frags for n in P.walk_plan(f.root)
              if isinstance(n, RemoteSourceNode) and f.partitioning in ("source", "hash")}
    q = QueryExecution("qfiles", "", dict(props), coord.registry, coord.session_factory)
    source = frags[0]
    assert source.partitioning == "source" and source.output_partition_channels
    q._schedule_fragment(session, source, workers, counts, fte=True)
    names = sorted(os.listdir(spool))
    assert names == sorted(f"qfiles.{source.id}.{w}.a0.p{p}.pages"
                           for w in range(len(workers)) for p in range(len(workers)))
    rows = 0
    for name in names:
        body = (spool / name).read_bytes()
        frames = wire.unframe_pages(body)
        assert frames == jax_wire.unframe_pages(body)
        for fb in frames:
            mine, ref = deserialize_page(fb), jax_deserialize(fb)
            assert mine.num_rows == ref.num_rows
            for a, b in zip(mine.columns, ref.columns):
                np.testing.assert_array_equal(np.asarray(a.values), np.asarray(b.values))
            rows += mine.num_rows
    assert rows > 0
    q._cancel_tasks()
    q._cleanup_spool()
    assert os.listdir(spool) == []


def test_pipelined_policy_unaffected(clusters, monkeypatch, tmp_path):
    runs = run_both(clusters, monkeypatch, tmp_path, SQL, TINY)
    t, j = runs["torch"], runs["jax"]
    assert t.error is None and t.rows == j.rows
    assert t.q.retried_tasks == j.q.retried_tasks == []
    assert t.leftover() == j.leftover() == []


def test_fte_hash_distributed_agg_with_injected_failure(clusters, monkeypatch, tmp_path):
    """A hash stage under the tier: the source stage spools a file a
    partition, its failed attempt retries, the hash stage's finals read the
    partition files."""
    sql = """
        select o_custkey, count(*) as c from orders
        group by o_custkey order by c desc, o_custkey limit 7
    """
    props = {**FTE, "gather_max_rows_per_device": 1000, "failure_injection": ".0.0.a0"}
    runs = run_both(clusters, monkeypatch, tmp_path, sql, props)
    t, j = runs["torch"], runs["jax"]
    assert t.error is None and j.error is None and t.rows == j.rows and len(t.rows) == 7
    assert _slots(t.q.retried_tasks, t.q) == _slots(j.q.retried_tasks, j.q) == ["<q>.0.0.a0"]
    assert any(f.partitioning == "hash" for f in t.q.fragments)
    assert t.leftover() == j.leftover() == []


def test_fte_partitioned_join_with_injected_failure(clusters, monkeypatch, tmp_path):
    sql = """
        select c_mktsegment, count(*) as c
        from customer, orders
        where c_custkey = o_custkey
        group by c_mktsegment order by c_mktsegment
    """
    props = {**FTE, "join_max_broadcast_rows": 1000, "failure_injection": ".0.0.a0"}
    runs = run_both(clusters, monkeypatch, tmp_path, sql, props)
    t, j = runs["torch"], runs["jax"]
    assert t.error is None and j.error is None and t.rows == j.rows and len(t.rows) == 5
    assert _slots(t.q.retried_tasks, t.q) == _slots(j.q.retried_tasks, j.q)
    assert t.leftover() == j.leftover() == []


def test_fte_output_past_the_buffer_watermark(clusters, monkeypatch, tmp_path):
    """Under the tier a producer's output larger than its buffer's watermark
    (``sink_max_buffer_bytes``) finishes: its consumers read the spool file,
    so the port enqueues nothing into the live buffer. The reference's
    producer blocks at the watermark for a pull that cannot come before the
    stage barrier, and fails once its enqueue times out (300 s; here cut to
    1 s), in each of its 3 attempts."""
    from trino_tpu.server import buffer as jax_buffer

    monkeypatch.setattr(jax_buffer.OutputBuffer.enqueue, "__defaults__", (1.0,))
    sql = "select o_orderkey, o_totalprice from orders where o_orderkey % 7 = 0 order by 1"
    small = {"sink_max_buffer_bytes": 256, "task_output_chunk_bytes": 1024}
    runs = run_both(clusters, monkeypatch, tmp_path, sql, {**FTE, **small})
    t, j = runs["torch"], runs["jax"]
    from trino_tpu.client.session import Session as JaxSession

    want = [[v if isinstance(v, int) else str(v) for v in r]
            for r in JaxSession(dict(TINY)).execute(sql).rows]
    assert t.error is None and t.rows == want
    assert t.q.retried_tasks == [] and t.wall < 30
    assert "failed after 3 attempts" in j.error and "output buffer full" in j.error
    # without the tier consumers pull the live buffer while the producer
    # runs: both answer
    pipelined = run_both(clusters, monkeypatch, tmp_path, sql, {**TINY, **small})
    assert pipelined["torch"].rows == pipelined["jax"].rows == t.rows


def _speculate(monkeypatch):
    for pkg in BOTH:
        monkeypatch.setattr(pkg.coordinator.QueryExecution, "SPECULATION_MIN_S", 0.5)
        monkeypatch.setattr(pkg.coordinator.QueryExecution, "SPECULATION_FACTOR", 1.5)


def test_speculative_execution_duplicates_straggler(clusters, monkeypatch, tmp_path):
    """Slot 0's first attempt of fragment 0 sleeps 60 s; its speculative a1
    wins long before, the original is canceled on its worker, and nothing
    is left in flight."""
    _speculate(monkeypatch)
    runs = run_both(clusters, monkeypatch, tmp_path, SQL,
                    {**FTE, "slow_injection": ".0.0.a0:60"})
    for r in runs.values():
        assert r.error is None and r.wall < 45, (r.error, r.wall)
        assert any(".0.0.a1" in tid for tid in r.q.speculation_history)
        assert r.q.speculative_tasks == []
        assert any(a >= 1 for tid, a in r.q.task_attempts.items() if ".0.0." in tid)
    t, j = runs["torch"], runs["jax"]
    assert t.rows == j.rows
    assert _slots(t.q.speculation_history, t.q) == _slots(j.q.speculation_history, j.q)
    # the loser was canceled on its worker: the worker no longer knows it
    status, _b, _h = TORCH.wire.http_request(
        "GET", f"{t.coord.registry.alive()[0]['url']}/v1/task/{t.q.query_id}.0.0.a0/status")
    assert status == 404
    assert t.leftover() == []


def test_canceled_loser_publishes_nothing(clusters, monkeypatch, tmp_path):
    """A speculative loser that wakes after its query ended: the port's
    cancel ends its wait and no file of the query appears; the reference's
    runs its body and publishes its spool file after the query's cleanup
    (its ``_cleanup_spool`` had already run)."""
    _speculate(monkeypatch)
    props = {**FTE, "slow_injection": ".0.0.a0:2"}
    runs = run_both(clusters, monkeypatch, tmp_path, SQL, props)
    t, j = runs["torch"], runs["jax"]
    assert t.error is None and j.error is None and t.rows == j.rows
    time.sleep(max(0.0, 3.5 - min(t.wall, j.wall)))
    assert t.leftover(timeout=0) == []
    # the reference's loser publishes once its 2 s are out and its body ran
    late = f"{j.q.query_id}.0.0.a0.pages"
    deadline = time.monotonic() + 20.0
    while not (j.spool / late).exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert j.leftover(timeout=0) == [late]


# ----------------------------------------------- skew salting end to end
SKEW_PROPS = {**FTE, "join_max_broadcast_rows": "100", "adaptive_skew_threshold": "4"}
COMPUTED_SKEW_SQL = """
    select count(*) c, sum(p.v) s
    from (select case when l_orderkey % 10 < 9 then cast(1 as bigint)
                      else l_orderkey end as k,
                 l_orderkey as v from lineitem) p, orders o
    where p.k = o.o_orderkey
"""
FS_SKEW_SQL = """
    select count(*) c, sum(p.v) s
    from filesystem.lake.probe p, filesystem.lake.build b
    where p.k = b.k
"""


def _skew_change(pkg, coord, client):
    info = pkg.wire.json_request("GET", f"{coord.base_url}/v1/query/{client.query_id}")
    skew = [c for c in info["planVersions"] if c["rule"] == "skew-mitigation"]
    assert len(skew) == 1, info["planVersions"]
    detail = skew[0]["detail"]
    pr, (hot,) = detail["probePartitionRows"], detail["hotPartitions"]
    assert pr[hot] > 4 * (sum(pr) - pr[hot])
    return {k: v for k, v in skew[0].items() if k not in ("detail",)}, detail


@pytest.mark.parametrize("tables", ["filesystem", "computed"])
def test_skew_mitigation_salts_hot_partitions(tables, tmp_path, monkeypatch):
    """A repartition join with one hot key (90% of the probe's rows) under
    the tier: both producers have finished when the join's stage comes up,
    the re-planner salts them (probe spread, build replicated) through the
    scheduler, and the rows equal adaptation off. The port's and the
    reference's plan changes are equal."""
    if tables == "filesystem":
        pytest.importorskip("pyarrow")
    out = {}
    for pkg in BOTH:
        base = tmp_path / pkg.name
        monkeypatch.setenv("TRINO_TPU_FS_ROOT", str(base / "lake"))
        monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(base / "spool"))
        coord, ws = start_cluster(pkg, f"skew-{pkg.name}-")
        try:
            sql = COMPUTED_SKEW_SQL
            if tables == "filesystem":
                sql = FS_SKEW_SQL
                for ddl in ("""create table filesystem.lake.probe as
                               select case when l_orderkey % 10 < 9 then cast(1 as bigint)
                                           else l_orderkey end as k, l_orderkey as v
                               from tpch.tiny.lineitem""",
                            """create table filesystem.lake.build as
                               select distinct l_orderkey as k from tpch.tiny.lineitem"""):
                    pkg.remote.StatementClient(coord.base_url, dict(TINY)).execute(ddl)
            off = pkg.remote.StatementClient(coord.base_url,
                                             dict(SKEW_PROPS, adaptive_execution_enabled="false"))
            _c, rows_off = off.execute(sql, timeout=120.0)
            client = pkg.remote.StatementClient(coord.base_url, dict(SKEW_PROPS))
            _c, rows = client.execute(sql, timeout=120.0)
            assert rows == rows_off
            change, detail = _skew_change(pkg, coord, client)
            q = coord.get_query(client.query_id)
            spool = base / "spool"
            left = [f for f in (os.listdir(spool) if spool.exists() else ())
                    if f.startswith(q.query_id)]
            out[pkg.name] = (rows, change, detail, q)
        finally:
            stop_cluster(coord, ws)
        if pkg is TORCH:
            assert left == []
    (t_rows, t_change, t_detail, t_q), (j_rows, j_change, j_detail, _jq) = (
        out["torch"], out["jax"])
    assert t_rows == j_rows
    assert t_change == j_change
    assert {k: v for k, v in t_detail.items() if k != "join"} == \
        {k: v for k, v in j_detail.items() if k != "join"}
    # the salted probe's rows are spread over both partitions
    new = t_change["newFragments"]
    probe = [e["stats"]["partitionRows"] for e in t_q.task_stats.values()
             if e["fragment"] == new[0] and e["state"] == "FINISHED"]
    spread = [sum(p) for p in zip(*probe)]
    assert sum(spread) == sum(t_detail["probePartitionRows"]) and max(spread) < 2 * min(spread)


# ------------------------------------------------------ the query trace
def _flatten(node):
    yield node
    for child in node.get("children", ()):
        yield from _flatten(child)


def test_fte_retry_reparents_into_same_trace_exactly_once(clusters, monkeypatch, tmp_path):
    """A retried slot's spans join the query's trace once, as its winning
    attempt's, under the coordinator's schedule span, in both packages."""
    out = {}
    for pkg in (TORCH, JAX):
        monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(tmp_path / pkg.name))
        coord = clusters[pkg.name]
        q = coord.submit(SQL, dict(FTE, failure_injection=".0.0.a0"))
        deadline = time.time() + 120
        while not q.state.is_terminal() and time.time() < deadline:
            time.sleep(0.02)
        assert q.state.get() == "FINISHED", q.failure
        assert any(t.endswith(".0.0.a0") for t in q.retried_tasks)
        trace = pkg.wire.json_request("GET", f"{coord.base_url}/v1/query/{q.query_id}/trace")
        nodes = list(_flatten(trace["root"]))
        tasks = [n for n in nodes if n["name"] == "task"]
        task_ids = sorted(t["attributes"]["task_id"].replace(q.query_id, "<q>") for t in tasks)
        slots = [tid.rsplit(".a", 1)[0] for tid in task_ids]
        assert len(slots) == len(set(slots)), task_ids
        assert "<q>.0.0.a1" in task_ids and "<q>.0.0.a0" not in task_ids
        schedule_ids = {n["spanId"] for n in nodes if n["name"] == "schedule"}
        assert {t["parentId"] for t in tasks} <= schedule_ids
        assert trace["spanCount"] == len(nodes)
        out[pkg.name] = task_ids
    assert out["torch"] == out["jax"]


# ------------------------------------------------------------ the card
@pytest.mark.cuda
def test_fte_retry_on_the_card_returns_device_memory(tmp_path, monkeypatch):
    """One query under the tier with an injected failure on a CUDA cluster:
    the expected rows, the retry, and ``torch.cuda.memory_allocated()`` back
    at its start once the query and its retry are done (the canceled and
    failed attempts keep no tensor)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trino_tpu_torch.client.remote import StatementClient
    from trino_tpu_torch.client.session import Session
    from trino_tpu_torch.server.coordinator import CoordinatorServer
    from trino_tpu_torch.server.worker import WorkerServer

    def settled():
        # the frees deferred behind the staging copy's stream land at the
        # allocator's next allocation
        torch.cuda.synchronize()
        torch.empty((1,), device="cuda")
        return torch.cuda.memory_allocated()

    monkeypatch.setenv("TRINO_TPU_SPOOL_DIR", str(tmp_path / "spool"))
    want = Session(dict(TINY), device="cuda").execute(SQL).rows
    coord = CoordinatorServer(device="cuda")
    coord.start()
    ws = [WorkerServer(coordinator_url=coord.base_url, node_id=f"cuda{i}", device="cuda")
          for i in range(2)]
    for w in ws:
        w.start()
    try:
        assert coord.registry.wait_for_workers(2, timeout=15.0)
        StatementClient(coord.base_url, dict(FTE)).execute(SQL, timeout=120.0)  # warm
        before = settled()
        client = StatementClient(coord.base_url, dict(FTE, failure_injection=".0.0.a0"))
        _c, rows = client.execute(SQL, timeout=120.0)
        assert [tuple(r) for r in rows] == [tuple(r) for r in want]
        assert coord.get_query(client.query_id).retried_tasks
        assert settled() <= before
        assert all(not w.tasks.query_memory() for w in ws)
    finally:
        for w in ws:
            w.stop()
        coord.stop()


# ------------------------------------------------- chip_smoke's phase
def test_chip_smoke_phase_fte_at_tiny():
    """chip_smoke.py's phase fte at tiny on the CPU, against the JAX
    Session's rows of Q1, Q3, Q9 and Q18 (the card runs it at SF1 against
    tpch_sf1_expected.json; here the joins' broadcast limit is 100 rows, so
    Q3 has a hash stage at tiny)."""
    import torch

    from trino_tpu.client.session import Session as JaxSession
    from tpch_sql import QUERIES

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    jax = JaxSession(dict(TINY))
    expected = {str(q): {"sql": QUERIES[q], "rows": chip_smoke.jsonable_rows(
        jax.execute(QUERIES[q]).rows)} for q in chip_smoke.FTE_QUERIES}
    with chip_smoke.MergeCapture() as cap:
        out = chip_smoke.phase_fte(torch.device("cpu"), expected, None, cap, "cpu", None,
                                   schema="tiny", extra_props={"join_max_broadcast_rows": "100"})
    assert [r["retried"] for r in out["retries"]] == [["<q>.2.0.a0"], ["<q>.0.0.a0"]]
    assert out["speculation"]["history"] == ["<q>.0.0.a1"]
    assert out["speculation"]["wall_s"] < chip_smoke.FTE_SLOW_S / 2
    assert len(out["skew"]["hot"]) == 1
    (lineitem,), (orders,) = (jax.execute(f"select count(*) from {t}").rows[0]
                              for t in ("lineitem", "orders"))
    assert out["worker_direct"]["rows"] == lineitem and out["worker_direct"]["segments"] >= 2
    assert out["coordinator"]["rows"] == orders
    assert out["read_back"]["exchange_bytes"] == 0 and out["read_back"]["spool_reads"] >= 2
    assert out["ranges"]["statuses"] == [200, 206, 416]
    assert "failed after 3 attempts" in out["out_of_attempts"]
    # the cached Q18 ran on the coordinator's executor: the merge wrapper
    # (its plain version on the CPU) saw the cold run's inputs
    assert {(p, q) for p, q, *_ in cap.captured} <= {("fte", 18)}
