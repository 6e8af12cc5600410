"""The port's distributed path on the CPU: a coordinator and two workers
(``device="cpu"``) in this process over real HTTP, the cases of the
reference's tests/test_control_plane.py and tests/test_streaming_consumer.py
held against the JAX package's Session, one cluster of two worker
subprocesses, the dbapi driver with ``?`` parameters, and the refusals of
what the port does not have.

Rows cross the JSON protocol, which stringifies dates and decimals; doubles
are compared rounded to 9 places (``json_round``), as the reference's
tests do. Every wait has a timeout and every server stops in ``finally``.
"""
import datetime
import decimal
import os
import subprocess
import sys
import threading
import time
from typing import List

import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
from trino_tpu.client.session import Session as JaxSession

from trino_tpu_torch import Session as TorchSession
from trino_tpu_torch.data.page import Page
from trino_tpu_torch.data.serde import deserialize_page
from trino_tpu_torch.exec.executor import Executor
from trino_tpu_torch.exec.query import plan_sql
from trino_tpu_torch.server import wire
from trino_tpu_torch.server.buffer import OutputBuffer
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.statemachine import StateMachine
from trino_tpu_torch.server.task import SqlTask, TaskRequest
from trino_tpu_torch.server.worker import WorkerServer
from trino_tpu_torch.sql.planner import plan as P
from trino_tpu_torch.sql.planner.fragmenter import RemoteSourceNode, fragment_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"catalog": "tpch", "schema": "tiny"}
CLIENT_TIMEOUT = 120.0


def json_round(v):
    """A value as the JSON protocol carries it (dates and decimals as
    strings), doubles rounded to 9 places."""
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, float):
        return round(v, 9)
    return v


def rounded(rows):
    return [[json_round(v) for v in r] for r in rows]


def torch_session(props):
    return TorchSession(dict(props), device="cpu")


def start_cluster(workers=2):
    coord = CoordinatorServer(device="cpu")
    coord.start()
    ws = [WorkerServer(coordinator_url=coord.base_url, node_id=f"w{i}", device="cpu")
          for i in range(workers)]
    for w in ws:
        w.start()
    return coord, ws


def stop_cluster(coord, ws):
    for w in ws:
        w.stop()
    coord.stop()


@pytest.fixture(scope="module")
def cluster():
    coord, ws = start_cluster()
    try:
        assert coord.registry.wait_for_workers(2, timeout=15.0)
        yield coord, ws
    finally:
        stop_cluster(coord, ws)


def run(coord, sql, props=None):
    from trino_tpu_torch.client.remote import StatementClient

    client = StatementClient(coord.base_url, props or dict(TINY))
    return client.execute(sql, timeout=CLIENT_TIMEOUT)


def jax_rows(sql, props=None):
    return JaxSession(dict(props or TINY)).execute(sql).rows


# ---------------------------------------------------------------- unit tier
def test_state_machine_terminal_latch():
    sm = StateMachine("QUEUED", {"FINISHED", "FAILED"})
    seen = []
    sm.add_listener(seen.append)
    assert sm.set("RUNNING")
    assert sm.set("FINISHED")
    assert not sm.set("FAILED")
    assert sm.get() == "FINISHED"
    assert seen == ["QUEUED", "RUNNING", "FINISHED"]


def test_output_buffer_token_protocol():
    buf = OutputBuffer()
    buf.enqueue(b"p0")
    buf.enqueue(b"p1")
    pages, nxt, complete, fail = buf.poll(0, timeout=0)
    assert pages == [b"p0", b"p1"] and nxt == 2 and not complete
    pages2, _, _, _ = buf.poll(0, timeout=0)  # un-acked: delivered again
    assert pages2 == [b"p0", b"p1"]
    buf.enqueue(b"p2")
    buf.set_complete()
    pages3, nxt3, complete3, _ = buf.poll(2, timeout=0)
    assert pages3 == [b"p2"] and nxt3 == 3 and complete3
    _, _, complete4, _ = buf.poll(3, timeout=0)
    assert complete4
    with pytest.raises(ValueError):
        buf.poll(1, timeout=0)  # already acknowledged


def test_output_buffer_multi_consumer():
    buf = OutputBuffer(consumer_count=2)
    buf.enqueue(b"p0")
    buf.enqueue(b"p1")
    buf.set_complete()
    pages_a, nxt_a, complete_a, _ = buf.poll(0, buffer_id=0, timeout=0)
    assert pages_a == [b"p0", b"p1"] and complete_a
    _, _, done_a, _ = buf.poll(nxt_a, buffer_id=0, timeout=0)
    assert done_a
    pages_b, _, _, _ = buf.poll(0, buffer_id=1, timeout=0)
    assert pages_b == [b"p0", b"p1"]
    buf.destroy_consumer(1)
    assert buf.buffered_bytes == 0


def test_output_buffer_backpressure_blocks_producer():
    buf = OutputBuffer(consumer_count=1, max_buffer_bytes=4 * 1024)
    page = b"x" * 1024
    produced = 0

    def producer():
        nonlocal produced
        for _ in range(64):
            buf.enqueue(page, timeout=30.0)
            produced += 1
        buf.set_complete()

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.3)
    assert produced <= 5, f"producer ran ahead: {produced}"
    token = got = 0
    while True:
        pages, token, complete, failure = buf.poll(token, timeout=2.0)
        assert failure is None
        got += len(pages)
        time.sleep(0.01)
        if complete:
            break
    t.join(timeout=10)
    assert got == 64 and produced == 64
    assert buf.peak_buffered_bytes <= 4 * 1024 + len(page)


def test_output_buffer_abort_unblocks_producer():
    buf = OutputBuffer(consumer_count=1, max_buffer_bytes=1024)
    blocked = threading.Event()

    def producer():
        buf.enqueue(b"y" * 1024, timeout=30.0)
        blocked.set()
        buf.enqueue(b"y" * 1024, timeout=30.0)  # parks at the watermark

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    blocked.wait(5)
    time.sleep(0.2)
    buf.abort("consumer gone")
    t.join(timeout=5)
    assert not t.is_alive()


def test_merge_launch_counts_survive_task_threads():
    """The merge wrapper's counts are read-modify-writes from every task
    thread of a worker: 32 threads of 2000 counts each, with a short
    switch interval, lose none."""
    from trino_tpu_torch.ops import merge

    saved = (merge.launches, merge.captured, sys.getswitchinterval())
    merge.launches = merge.captured = 0
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [merge._count_launch(k % 4 == 0)
                                                        for _ in range(2000)])
                   for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert (merge.launches, merge.captured) == (24 * 2000, 8 * 2000)
    finally:
        merge.launches, merge.captured = saved[:2]
        sys.setswitchinterval(saved[2])


# --------------------------------------------- in-process multi-node tier
def test_distributed_q1_matches_reference(cluster):
    coord, _ = cluster
    sql = """
        select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
               avg(l_extendedprice) as avg_price, count(*) as count_order
        from lineitem
        where l_shipdate <= date '1998-09-02'
        group by l_returnflag, l_linestatus
        order by l_returnflag, l_linestatus
    """
    columns, rows = run(coord, sql)
    assert columns == ["l_returnflag", "l_linestatus", "sum_qty", "avg_price", "count_order"]
    assert rounded(rows) == rounded(jax_rows(sql))


def test_distributed_join_broadcast(cluster):
    coord, _ = cluster
    sql = """
        select n_name, count(*) as c
        from customer, nation
        where c_nationkey = n_nationkey
        group by n_name
        order by c desc, n_name limit 5
    """
    _, rows = run(coord, sql)
    assert rounded(rows) == rounded(jax_rows(sql))


def test_query_info_and_node_listing(cluster):
    coord, _ = cluster
    nodes = wire.json_request("GET", f"{coord.base_url}/v1/node")
    assert {n["nodeId"] for n in nodes} >= {"w0", "w1"}
    run(coord, "select count(*) from region")
    by_state, _rows = coord.query_state_counts()
    assert by_state.get("FINISHED", 0) >= 1
    qid = sorted(coord.queries)[-1]
    info = wire.json_request("GET", f"{coord.base_url}/v1/query/{qid}")
    assert info["state"] == "FINISHED"
    assert info["fragments"]
    assert all(t["state"] in ("FLUSHING", "FINISHED") for t in info["tasks"].values())
    winfo = wire.json_request("GET", f"{coord.registry.alive()[0]['url']}/v1/info")
    assert winfo["state"] == "ACTIVE" and winfo["device"] == "cpu"


def test_set_session_round_trips_through_protocol(cluster):
    coord, _ = cluster
    from trino_tpu_torch.client.remote import StatementClient

    client = StatementClient(coord.base_url, dict(TINY))
    client.execute("set session dynamic_filtering_enabled = false", timeout=CLIENT_TIMEOUT)
    assert client.session_properties["dynamic_filtering_enabled"] is False
    _, rows = client.execute("select count(*) from region", timeout=CLIENT_TIMEOUT)
    assert rows == [[5]]
    client.execute("reset session dynamic_filtering_enabled", timeout=CLIENT_TIMEOUT)
    assert "dynamic_filtering_enabled" not in client.session_properties


def test_failed_query_reports_error(cluster):
    coord, _ = cluster
    from trino_tpu_torch.client.remote import RemoteQueryError

    with pytest.raises(RemoteQueryError):
        run(coord, "select nonexistent_column from region")


def test_worker_auth_rejects_unsigned(cluster):
    _, workers = cluster
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{workers[0].base_url}/v1/task/forged", data=b"evil",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=5)
    assert ei.value.code == 401


def test_worker_task_routes_require_hmac(cluster):
    import urllib.error
    import urllib.request

    _, workers = cluster
    req = urllib.request.Request(f"{workers[0].base_url}/v1/task/nonexistent/status",
                                 method="GET")
    try:
        with urllib.request.urlopen(req, timeout=5.0) as resp:
            status = resp.status
    except urllib.error.HTTPError as e:
        status = e.code
    assert status == 401


def test_remote_ddl_persists_across_statements(cluster):
    coord, _ = cluster
    props = {"catalog": "memory", "schema": "default"}
    run(coord, "create table memory.default.advice_t (x bigint, s varchar)", props)
    run(coord, "insert into memory.default.advice_t values (1, 'a'), (2, 'b')", props)
    _, rows = run(coord, "select x, s from memory.default.advice_t order by x", props)
    assert [tuple(r) for r in rows] == [(1, "a"), (2, "b")]
    run(coord, "drop table memory.default.advice_t", props)


def test_hash_distributed_final_aggregation(cluster):
    """gather_max_rows_per_device=1 hash-distributes the final aggregation:
    one final task a worker, each over a disjoint key set."""
    coord, workers = cluster
    props = {**TINY, "gather_max_rows_per_device": 1}
    explain = ("explain (type distributed) select o_custkey, count(*), sum(o_totalprice)"
               " from orders group by o_custkey")
    _, plan_rows = run(coord, explain, props)
    plan_text = "\n".join(r[0] for r in plan_rows)
    assert "[hash]" in plan_text, plan_text
    assert [r[0] for r in plan_rows] == [r[0] for r in jax_rows(explain, props)]
    sql = ("select o_custkey, count(*) c, sum(o_totalprice) s from orders "
           "group by o_custkey order by o_custkey limit 50")
    _, rows = run(coord, sql, props)
    assert rounded(rows) == rounded(jax_rows(sql))
    info = coord.queries[sorted(coord.queries)[-1]].info()
    assert len(info["fragments"]) >= 2
    assert any(len(tasks) == len(workers) and tid.split(".")[1] == fid
               for fid, tasks in info["fragments"].items() for tid in tasks)


def test_hash_distributed_agg_varchar_keys(cluster):
    """Varchar keys co-locate by string, not by page-local code."""
    coord, _ = cluster
    props = {**TINY, "gather_max_rows_per_device": 1}
    sql = ("select c_name, count(*) c from customer, orders "
           "where c_custkey = o_custkey group by c_name "
           "order by c desc, c_name limit 20")
    _, rows = run(coord, sql, props)
    assert rounded(rows) == rounded(jax_rows(sql))


def test_partitioned_join_no_process_holds_both_sides(cluster):
    coord, _ = cluster
    props = {**TINY, "join_max_broadcast_rows": 1000}
    sql = """
        select c_mktsegment, count(*) as c, sum(o_totalprice) as q
        from customer, orders
        where c_custkey = o_custkey and o_totalprice > 1000
        group by c_mktsegment order by c_mktsegment
    """
    s = torch_session(props)
    frags = fragment_plan(plan_sql(s, sql), s)
    join_frag = next(f for f in frags if f.partitioning == "hash"
                     and any(isinstance(n, P.JoinNode) for n in P.walk_plan(f.root)))
    join = next(n for n in P.walk_plan(join_frag.root) if isinstance(n, P.JoinNode))
    assert isinstance(join.left, RemoteSourceNode) and isinstance(join.right, RemoteSourceNode)
    assert join.left.exchange_type == join.right.exchange_type == "partitioned"
    by_id = {f.id: f for f in frags}
    assert by_id[join.left.fragment_id].output_partition_channels
    assert by_id[join.right.fragment_id].output_partition_channels
    _, rows = run(coord, sql, props)
    assert rounded(rows) == rounded(jax_rows(sql))


def test_phased_execution_waits_for_leaf_builds(cluster):
    coord, _ = cluster
    sql = ("select n_name, count(*) from customer, nation where c_nationkey = n_nationkey "
           "group by n_name")
    run(coord, sql)
    q = coord.queries[sorted(coord.queries)[-1]]
    assert q.phase_waits, "the probe fragment scheduled without waiting for its build"


def test_dbapi_qmark_parameters(cluster):
    """Q6 and Q17 with ``?`` parameters through a dbapi cursor: the driver
    PREPAREs once on the coordinator, then EXECUTEs with the bindings."""
    coord, _ = cluster
    from trino_tpu_torch.client import dbapi

    q6 = ("select sum(l_extendedprice * l_discount) as revenue from lineitem "
          "where l_shipdate >= ? and l_shipdate < date '1995-01-01' "
          "and l_discount between ? and ? and l_quantity < ?")
    literal = q6.replace("?", "{}").format("date '1994-01-01'", "0.05", "0.07", "24")
    conn = dbapi.connect(coord.base_url, catalog="tpch", schema="tiny")
    cur = conn.cursor()
    cur.execute(q6, (datetime.date(1994, 1, 1), decimal.Decimal("0.05"),
                     decimal.Decimal("0.07"), 24))
    assert rounded(cur.fetchall()) == rounded(jax_rows(literal))
    assert any(k.startswith("dbapi_") for k in conn._client.prepared_statements)
    q17 = ("select sum(l_extendedprice) / 7.0 as avg_yearly from lineitem, part "
           "where p_partkey = l_partkey and p_brand = ? and p_container = ? "
           "and l_quantity < (select 0.2 * avg(l_quantity) from lineitem "
           "where l_partkey = p_partkey)")
    cur.execute(q17, ("Brand#23", "MED BOX"))
    want = jax_rows(q17.replace("p_brand = ?", "p_brand = 'Brand#23'")
                    .replace("p_container = ?", "p_container = 'MED BOX'"))
    assert rounded(cur.fetchall()) == rounded(want)
    with pytest.raises(dbapi.DatabaseError, match="expects 1 parameters"):
        cur.execute("select count(*) from nation where n_regionkey = ?", (1, 2))


def test_unported_tiers_are_refused(cluster, monkeypatch):
    """Nothing of the reference's cluster is refused now. The
    executor-process plane is ported: a coordinator asking for it starts,
    reports its children in the serving rows and stops (its children boot
    on the first routed query, tests/test_torch_process_plane.py). The
    fault-tolerant tier
    and spooled results are ported: a request setting ``retry_policy=TASK``
    without a spool directory fails with the reference's message, one with
    ``spooled_results_enabled`` runs, and the segment route answers an
    unknown id 404, as the reference's does. Adaptive execution and
    distributed EXPLAIN ANALYZE are ported: a request setting
    ``adaptive_execution_enabled`` runs, and EXPLAIN ANALYZE answers with
    the annotated fragments. The observability routes are ported: ``/ui``
    serves its page and the trace route of an unknown query 404."""
    coord, _ = cluster
    from trino_tpu_torch.client.remote import RemoteQueryError

    monkeypatch.delenv("TRINO_TPU_SPOOL_DIR", raising=False)
    with pytest.raises(RemoteQueryError, match="requires the spooled exchange"):
        run(coord, "select count(*) from region", {**TINY, "retry_policy": "TASK"})
    _cols, rows = run(coord, "select count(*) from region",
                      {**TINY, "spooled_results_enabled": "true"})
    assert rows == [[5]]
    for value in ("true", "false"):
        _cols, rows = run(coord, "select count(*) from region",
                          {**TINY, "adaptive_execution_enabled": value})
        assert rows == [[5]]
    _cols, plan = run(coord, "explain analyze select count(*) from region")
    text = "\n".join(r[0] for r in plan)
    assert text.startswith("Query wall time: ") and "TableScan tpch.tiny.region" in text
    for path, want in (("/ui", 200), ("/v1/query/x/trace", 404), ("/v1/segment/x", 404)):
        status, _, _ = wire.http_request("GET", coord.base_url + path, timeout=10.0)
        assert status == want, path
    status, _, _ = wire.http_request("DELETE", coord.base_url + "/v1/segment/x", timeout=10.0)
    assert status == 204  # an ack of a gone segment is still an ack
    from trino_tpu_torch.server.coordinator import CoordinatorServer

    proc = CoordinatorServer(device="cpu", executor_plane="process", executor_processes=2)
    proc.start()
    try:
        lanes = next(r for r in proc.dispatcher.serving_rows() if r[0] == "executor_lanes")
        assert lanes[2] == "process" and lanes[5].endswith(" processes=2")
    finally:
        proc.stop()
    assert proc.dispatcher.process_plane.children_urls() == []


def test_nested_decimals_and_dates_cross_the_protocol(cluster):
    """Arrays and maps holding decimals and dates come back through the
    statement protocol with the strings their flat columns get: the
    elements of array_agg(o_totalprice) and array_agg(o_orderdate) are the
    flat columns' strings (those ``client/remote.py``
    ``_normalized_slow_values`` gives on the segment path), and
    map_agg(o_orderkey, o_totalprice) maps each key (a JSON object key, so
    a string) to its price's string. The reference's cluster drops the
    connection on these (its ``_jsonable`` does not recurse, so
    ``json.dumps`` raises inside the HTTP handler); the port's repairs it."""
    coord, _ = cluster
    _cols, flat = run(coord, "select o_orderkey, o_totalprice, o_orderdate from orders "
                             "where o_custkey = 1")
    _cols, nested = run(coord, "select array_agg(o_totalprice), array_agg(o_orderdate), "
                               "map_agg(o_orderkey, o_totalprice) from orders "
                               "where o_custkey = 1")
    assert len(flat) == 8 and all(isinstance(v, str) for r in flat for v in r[1:])
    (prices, dates, by_key), = nested
    assert sorted(prices) == sorted(r[1] for r in flat)
    assert sorted(dates) == sorted(r[2] for r in flat)
    assert by_key == {str(r[0]): r[1] for r in flat}
    want = jax_rows("select o_totalprice, o_orderdate from orders where o_custkey = 1")
    assert sorted(prices) == sorted(str(p) for p, _ in want)
    assert sorted(dates) == sorted(d.isoformat() for _, d in want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a GPU")
def test_servers_without_a_gpu_raise():
    with pytest.raises(RuntimeError, match="CUDA"):
        CoordinatorServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        WorkerServer()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", "trino_tpu_torch.server.worker",
                          "--coordinator", "http://127.0.0.1:9"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr


def test_streaming_task_output_consumer_progress_before_finish():
    """An output larger than its sink watermark goes out in many chunks,
    and the producer reaches FINISHED only after the consumer pulled."""
    props = {**TINY, "task_output_chunk_bytes": 64 * 1024,
             "sink_max_buffer_bytes": 128 * 1024}
    session = torch_session(props)
    root = plan_sql(session, "select l_orderkey, l_quantity, l_extendedprice from lineitem")
    (scan,) = [n for n in P.walk_plan(root) if isinstance(n, P.TableScanNode)]
    conn = session.catalogs["tpch"]
    req = TaskRequest(task_id="t_stream", query_id="q_stream", fragment_root=root,
                      splits={scan.id: conn.get_splits("tiny", "lineitem", 1)},
                      upstream={}, session_properties=props)
    task = SqlTask(req, session_factory=torch_session)
    task.start()
    frames, token, state_at_first_page = [], 0, None
    for _ in range(10_000):
        pages, token, complete, failure = task.output.poll(token, 0, max_pages=1, timeout=10.0)
        assert failure is None, failure
        if pages and state_at_first_page is None:
            state_at_first_page = task.state.get()
        frames.extend(pages)
        if complete:
            break
    assert state_at_first_page == "FLUSHING"
    assert len(frames) >= 8
    for _ in range(100):
        if task.state.get() == "FINISHED":
            break
        time.sleep(0.05)
    assert task.state.get() == "FINISHED"
    assert sum(deserialize_page(f).num_rows for f in frames) == \
        jax_rows("select count(*) from lineitem")[0][0]


# ------------------------------------------------------ streaming consumer
SQL = ("select o_custkey, count(*) c, sum(o_totalprice) s, min(o_orderdate) d "
       "from orders group by o_custkey")


def _partial_state_pages(session, chunks=8) -> List[Page]:
    root = plan_sql(session, SQL)
    (agg,) = [n for n in P.walk_plan(root) if isinstance(n, P.AggregationNode)]
    scan_page = Executor(session).execute(agg.source).compact()
    n = scan_page.num_rows
    step = max(1, n // chunks)
    partial = P.AggregationNode(agg.source, list(agg.group_channels), agg.aggregates,
                                step="partial")
    return [Executor(session).aggregate_partial(
        partial, scan_page.slice_rows(lo, min(n, lo + step))).compact()
        for lo in range(0, n, step)]


class FakeExchangeClient:
    """Serves pre-built pages and counts what it served."""

    instances: List["FakeExchangeClient"] = []
    pages_to_serve: List[Page] = []

    def __init__(self, locations, max_buffered_pages: int = 64, tracer=None, device="cpu",
                 owner=None, stall_key=None):
        self.served = 0
        self.pulled_seconds = 0.0
        self.stalled_seconds = 0.0
        FakeExchangeClient.instances.append(self)

    def start(self):
        pass

    def iter_pages(self):
        for p in FakeExchangeClient.pages_to_serve:
            self.served += 1
            yield p

    def pages(self):
        return list(self.iter_pages())


@pytest.fixture()
def patched_client(monkeypatch):
    import trino_tpu_torch.server.exchange_client as xc

    FakeExchangeClient.instances = []
    monkeypatch.setattr(xc, "ExchangeClient", FakeExchangeClient)
    yield FakeExchangeClient


def _wait(task, seconds=120):
    deadline = time.time() + seconds
    while task.state.get() not in ("FINISHED", "FAILED") and time.time() < deadline:
        time.sleep(0.05)
    assert task.state.get() == "FINISHED", task.failure


def _drain(task):
    frames, token = [], 0
    for _ in range(1000):
        got, token, complete, failure = task.output.poll(token, 0, max_pages=100, timeout=5.0)
        assert failure is None, failure
        frames.extend(got)
        if complete:
            return frames
    raise AssertionError("the task's output never completed")


def test_final_agg_fragment_streams_via_intermediate_fold(patched_client, monkeypatch):
    props = {**TINY, "gather_max_rows_per_device": 1}
    session = torch_session(props)
    frags = fragment_plan(plan_sql(session, SQL), session)
    hash_frag = next(f for f in frags if f.partitioning == "hash")
    assert isinstance(hash_frag.root, P.AggregationNode) and hash_frag.root.step == "final"
    pages = _partial_state_pages(session)
    assert len(pages) >= 6
    FakeExchangeClient.pages_to_serve = pages
    fold_sizes: List[int] = []
    orig = Executor.aggregate_intermediate

    def counting(self, node, page):
        fold_sizes.append(page.num_rows)
        return orig(self, node, page)

    monkeypatch.setattr(Executor, "aggregate_intermediate", counting)
    monkeypatch.setattr(SqlTask, "STREAM_BATCH_ROWS", 1)
    req = TaskRequest(task_id="t_fold", query_id="q_fold", fragment_root=hash_frag.root,
                      splits={}, upstream={hash_frag.root.source.fragment_id:
                                           [("http://fake", "up.0", 0)]},
                      session_properties=dict(props))
    task = SqlTask(req, session_factory=torch_session)
    task.start()
    _wait(task)
    assert len(fold_sizes) == len(pages)
    assert max(fold_sizes) < sum(p.num_rows for p in pages)
    out = [r for f in _drain(task) for r in deserialize_page(f).to_pylist()]
    assert sorted(out) == sorted(tuple(r) for r in jax_rows(SQL + " order by o_custkey"))


def test_rowlocal_chain_streams_output_before_input_exhausted(patched_client, monkeypatch):
    session = torch_session(TINY)
    root = plan_sql(session, "select o_custkey, o_totalprice from orders "
                             "where o_totalprice > 1000")
    (scan,) = [n for n in P.walk_plan(root) if isinstance(n, P.TableScanNode)]
    remote = RemoteSourceNode(fragment_id=7, types=list(scan.output_types),
                              names=list(scan.column_names))

    def reroot(node):
        if node is scan:
            return remote
        if hasattr(node, "source"):
            node.source = reroot(node.source)
        return node

    frag_root = reroot(root.source)
    scan_page = Executor(session).execute(scan).compact()
    n = scan_page.num_rows
    FakeExchangeClient.pages_to_serve = [scan_page.slice_rows(lo, min(n, lo + n // 10))
                                         for lo in range(0, n, n // 10)]
    monkeypatch.setattr(SqlTask, "STREAM_BATCH_ROWS", 1)
    req = TaskRequest(task_id="t_chain", query_id="q_chain", fragment_root=frag_root,
                      splits={}, upstream={7: [("http://fake", "up.1", 0)]},
                      session_properties=dict(TINY))
    task = SqlTask(req, session_factory=torch_session)
    first_output_after_serves: List[int] = []
    orig_enqueue = task.output.enqueue

    def recording_enqueue(pb, **kw):
        if FakeExchangeClient.instances:
            first_output_after_serves.append(FakeExchangeClient.instances[-1].served)
        return orig_enqueue(pb, **kw)

    task.output.enqueue = recording_enqueue
    task.start()
    _wait(task)
    assert first_output_after_serves
    assert first_output_after_serves[0] < len(FakeExchangeClient.pages_to_serve)
    total = sum(deserialize_page(f).num_rows for f in _drain(task))
    assert total == jax_rows("select count(*) from orders where o_totalprice > 1000")[0][0]


def test_scan_task_streams_split_at_a_time(monkeypatch):
    props = {**TINY, "task_output_chunk_bytes": 1 << 20, "sink_max_buffer_bytes": 64 << 20}
    session = torch_session(props)
    root = plan_sql(session, "select o_orderkey, o_totalprice from orders "
                             "where o_totalprice > 1000")
    (scan,) = [n for n in P.walk_plan(root) if isinstance(n, P.TableScanNode)]
    splits = session.catalogs["tpch"].get_splits("tiny", "orders", 6)
    assert len(splits) > 1
    enq_after_splits: List[int] = []
    seen_splits = [0]
    req = TaskRequest(task_id="t_splits", query_id="q_splits", fragment_root=root.source,
                      splits={scan.id: splits}, upstream={}, session_properties=props)
    task = SqlTask(req, session_factory=torch_session)
    orig_enqueue = task.output.enqueue

    def recording_enqueue(pb, **kw):
        enq_after_splits.append(seen_splits[0])
        return orig_enqueue(pb, **kw)

    task.output.enqueue = recording_enqueue
    from trino_tpu_torch.server import task as task_mod

    orig_fe = task_mod.FragmentExecutor

    class CountingFE(orig_fe):
        def __init__(self, *a, **kw):
            seen_splits[0] += 1
            super().__init__(*a, **kw)

    monkeypatch.setattr(task_mod, "FragmentExecutor", CountingFE)
    task.start()
    _wait(task)
    assert seen_splits[0] == len(splits)
    assert enq_after_splits and enq_after_splits[0] < len(splits)
    total = sum(deserialize_page(f).num_rows for f in _drain(task))
    assert total == jax_rows("select count(*) from orders where o_totalprice > 1000")[0][0]


# ------------------------------------------------------ true process tier
def test_two_worker_processes_run_q1():
    """The coordinator in this process and two worker subprocesses
    (``python -m trino_tpu_torch.server.worker --device cpu``): Q1's shape
    splits across both."""
    coord = CoordinatorServer(device="cpu")
    coord.start()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["TRINO_TPU_INTERNAL_SECRET"] = wire.get_secret()
    procs = []
    try:
        for i in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "trino_tpu_torch.server.worker", "--coordinator",
                 coord.base_url, "--node-id", f"proc{i}", "--device", "cpu"],
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
        assert coord.registry.wait_for_workers(2, timeout=120.0), \
            "worker subprocesses did not announce"
        sql = ("select l_returnflag, count(*) as c, sum(l_quantity) as q "
               "from lineitem group by l_returnflag order by l_returnflag")
        _, rows = run(coord, sql)
        assert rounded(rows) == rounded(jax_rows(sql))
        q = coord.queries[sorted(coord.queries)[-1]]
        assert len({loc.base_url for locs in q.fragment_tasks.values() for loc in locs}) == 2
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        coord.stop()


# ------------------------------------------------------ the SF1 plan file
SF1 = {"catalog": "tpch", "schema": "sf1", "fused_join_pallas": True}
EXPECTED_FILE = os.path.join(REPO, "trino_tpu_torch", "testdata", "distributed_sf1_expected.json")


def write_expected():
    """trino_tpu_torch/testdata/distributed_sf1_expected.json: the JAX
    package's EXPLAIN (TYPE DISTRIBUTED) text of the 22 TPC-H queries at
    SF1, by planning only (no table is generated). chip_smoke.py's phase
    distributed holds the port's plans to it."""
    import json

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpch_sql import QUERIES

    session = JaxSession(dict(SF1))
    queries = {}
    for q in sorted(QUERIES):
        lines = [r[0] for r in session.execute(f"explain (type distributed) {QUERIES[q]}").rows]
        queries[str(q)] = {"explain": lines,
                           "hash_fragments": sum(" [hash]" in line for line in lines)}
    with open(EXPECTED_FILE, "w") as f:
        json.dump({"scale": "sf1", "properties": SF1,
                   "writer": "trino_tpu (JAX, CPU) via tests/test_torch_cluster.py "
                             "--write-expected",
                   "queries": queries}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-expected"]:
        write_expected()
    else:
        sys.exit("usage: python tests/test_torch_cluster.py --write-expected")
