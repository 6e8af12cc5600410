"""The task -> stage -> query stats spine of the port
(trino_tpu_torch/exec/operator_stats.py, server/task.py,
server/coordinator.py) held against the JAX package's: the rollups over the
same seeded task entries, the live-then-frozen query stats of a running
query, the statement protocol's stats block, and distributed EXPLAIN
ANALYZE [VERBOSE] of TPC-H Q1 at ``tiny`` on a port CPU cluster beside a
JAX CPU cluster (two workers each, in this process).

The plan text is compared line for line with the host clocks masked
(``wall=``, ``execute=``, ``dispatch_overhead=`` and the header's times).
The header lines that read the phase timeline and flow ledger
(``Phase ledger``, ``Data flow``, ``Straggler``) are compared by name: their
numbers are host clocks and rates. The workers' URLs differ between the
clusters, so the per-node peak
line is compared as its sorted peaks. VERBOSE's ``bytes=``/``peak=`` and
the fragment device line's KiB are masked too: the reference's
``page_bytes`` leaves out a long decimal's high limb, which the port
counts (ROADMAP queue 3, reference fault 8), and Q1's sums are long
decimals. Every other number is exact.
"""
import copy
import json
import os
import re
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_cluster import start_cluster, stop_cluster  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
from trino_tpu.exec import operator_stats as jax_ops  # noqa: E402

from trino_tpu_torch.exec import operator_stats as torch_ops  # noqa: E402
from trino_tpu_torch.server import wire  # noqa: E402

TINY = {"catalog": "tpch", "schema": "tiny"}
STATES = ("RUNNING", "FLUSHING", "FINISHED", "FAILED", "CANCELED")


def _entry(rng, n_nodes=4, n_parts=3):
    ops = ("TableScan", "Filter", "Join", "Aggregation")
    state = STATES[int(rng.integers(0, len(STATES)))]
    stats = {
        "elapsedS": float(rng.random()), "deviceS": float(rng.random()),
        "completedSplits": int(rng.integers(0, 5)), "totalSplits": int(rng.integers(5, 9)),
        "inputRows": int(rng.integers(0, 10**6)), "outputRows": int(rng.integers(0, 10**6)),
        "outputBytes": int(rng.integers(0, 10**8)), "peakBytes": int(rng.integers(0, 10**9)),
        "spills": int(rng.integers(0, 3)), "deviceCacheHits": int(rng.integers(0, 3)),
        "deviceCacheMisses": int(rng.integers(0, 3)),
        "operatorStats": [torch_ops.OperatorStats(
            nid, ops[nid % 4], input_rows=int(rng.integers(0, 1000)),
            output_rows=int(rng.integers(0, 1000)), output_bytes=int(rng.integers(0, 10**6)),
            wall_s=float(rng.random()), device_s=float(rng.random()),
            peak_bytes=int(rng.integers(0, 10**6)), splits=int(rng.integers(0, 3)),
            invocations=int(rng.integers(1, 4))).to_dict()
            for nid in range(n_nodes) if rng.random() < 0.8],
        "kernelStats": [{"planNodeId": str(nid), "operator": ops[nid % 4], "tier": "eager",
                         "nodeId": "", "launches": int(rng.integers(1, 4)),
                         "wallS": float(rng.random()), "deviceS": float(rng.random()) / 2,
                         "inputBytes": int(rng.integers(0, 10**6)),
                         "outputBytes": int(rng.integers(0, 10**6)),
                         "estimated": bool(rng.random() < 0.5)}
                        for nid in range(n_nodes) if rng.random() < 0.7],
    }
    if rng.random() < 0.7:
        stats["partitionRows"] = rng.integers(0, 10**5, n_parts).tolist()
        stats["partitionBytes"] = rng.integers(0, 10**7, n_parts).tolist()
    return {"state": state, "stats": stats}


@pytest.mark.parametrize("seed", range(6))
def test_rollups_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    stages = {fid: [_entry(rng) for _ in range(int(rng.integers(1, 4)))] for fid in range(3)}
    for include in (True, False):
        mine = [torch_ops.rollup_tasks_to_stage(fid, copy.deepcopy(es), include_operators=include)
                for fid, es in stages.items()]
        ref = [jax_ops.rollup_tasks_to_stage(fid, copy.deepcopy(es), include_operators=include)
               for fid, es in stages.items()]
        assert mine == ref
        assert torch_ops.rollup_stages_to_query(mine) == jax_ops.rollup_stages_to_query(ref)
    lists = [e["stats"]["kernelStats"] for es in stages.values() for e in es]
    assert torch_ops.merge_kernel_lists(copy.deepcopy(lists)) == \
        jax_ops.merge_kernel_lists(copy.deepcopy(lists))


def test_stage_state_and_partition_sums():
    op = torch_ops.OperatorStats(3, "TableScan", input_rows=100, output_rows=100)

    def entry(state, **stats):
        return {"state": state, "stats": dict(stats, operatorStats=[op.to_dict()])}

    stage = torch_ops.rollup_tasks_to_stage(0, [
        entry("FINISHED", partitionRows=[1, 2], partitionBytes=[10, 20]),
        entry("FLUSHING", partitionRows=[3, 4], partitionBytes=[30, 40])])
    assert stage["state"] == "RUNNING" and stage["completedTasks"] == 1
    assert stage["partitionRows"] == [4, 6] and stage["partitionBytes"] == [40, 60]
    assert stage["operatorStats"][0]["inputRows"] == 200
    assert torch_ops.rollup_tasks_to_stage(1, [entry("FAILED"), entry("CANCELED")])["state"] \
        == "FAILED"
    assert torch_ops.rollup_tasks_to_stage(1, [entry("FINISHED"), entry("CANCELED")])["state"] \
        == "CANCELED"


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


def _execute(base_url, sql, props, jax=False):
    if jax:
        from trino_tpu.client.remote import StatementClient
    else:
        from trino_tpu_torch.client.remote import StatementClient
    client = StatementClient(base_url, dict(props))
    cols, rows = client.execute(sql, timeout=120.0)
    return client, cols, rows


def _drain(payload, deadline_s=120.0):
    rows = []
    deadline = time.monotonic() + deadline_s
    while True:
        assert "error" not in payload, payload["error"]
        rows.extend(payload.get("data", []))
        uri = payload.get("nextUri")
        if uri is None:
            return rows
        assert time.monotonic() < deadline
        status, body, _ = wire.http_request("GET", uri, timeout=60.0)
        assert status < 400
        payload = json.loads(body)


def test_query_stats_live_while_running_then_frozen(clusters, monkeypatch):
    """GET /v1/query/{id} serves the stage and query rollups while the
    query runs (the poller's reads), and the same numbers, clock stopped,
    once it finished. A plain query's tasks ship per-operator stats (on by
    default, as in the reference) and estimated kernel rows."""
    from trino_tpu_torch.server.task import SqlTask

    coord, _ = clusters
    body = SqlTask._run_body

    def slow(self):
        time.sleep(1.0)
        body(self)

    monkeypatch.setattr(SqlTask, "_run_body", slow)
    sql = "select l_returnflag, count(*) from lineitem group by l_returnflag"
    status, resp, _ = wire.http_request(
        "POST", f"{coord.base_url}/v1/statement", sql.encode(), "text/plain",
        headers={"X-Trino-Session-catalog": "tpch", "X-Trino-Session-schema": "tiny"})
    assert status < 400
    payload = json.loads(resp)
    qid = payload["id"]
    live = None
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        info = wire.json_request("GET", f"{coord.base_url}/v1/query/{qid}")
        if info["state"] == "RUNNING" and info["queryStats"]["totalSplits"]:
            live = info
            break
        assert info["state"] not in ("FINISHED", "FAILED", "CANCELED")
        time.sleep(0.05)
    assert live is not None, "never observed RUNNING queryStats"
    assert live["queryStats"]["totalSplits"] > 0 and live["stageStats"]
    assert live["queryStats"]["completedStages"] < live["queryStats"]["stages"]
    rows = _drain(payload)
    from trino_tpu.client.session import Session as JaxSession

    assert sorted(rows) == sorted(list(r) for r in JaxSession(dict(TINY)).execute(sql).rows)
    info = wire.json_request("GET", f"{coord.base_url}/v1/query/{qid}")
    assert info["state"] == "FINISHED"
    qs = info["queryStats"]
    assert qs["completedSplits"] == qs["totalSplits"] > 0
    # every stage's input: at least the scan's rows, which the counts sum
    assert qs["totalRows"] == sum(st["inputRows"] for st in info["stageStats"])
    assert qs["totalRows"] >= sum(r[1] for r in rows) > 0
    assert qs["completedStages"] == qs["stages"] == len(info["stageStats"])
    stage = info["stageStats"][0]
    assert stage["state"] == "FINISHED" and stage["operatorStats"]
    assert all(o["invocations"] > 0 for o in stage["operatorStats"])
    assert stage["kernelStats"] and all(r["estimated"] for r in stage["kernelStats"])
    assert info["planVersions"] == [] and qs["adaptations"] == 0
    time.sleep(0.05)
    frozen = wire.json_request("GET", f"{coord.base_url}/v1/query/{qid}")["queryStats"]
    assert frozen["elapsedMs"] == qs["elapsedMs"]  # the terminal clock stopped
    q = coord.get_query(qid)
    assert q._sweep_task_stats() == 0  # every slot frozen: the backoff signal
    assert q.status_polls > 0


# the reference's statement stats keys that read what the port does not
# have: none since the spooled result protocol was ported
UNPORTED_STATS_KEYS = set()


def test_statement_protocol_carries_the_reference_stats(clusters):
    coord, jcoord = clusters
    sql = "select count(*) from orders"
    seen = []
    from trino_tpu_torch.client.remote import StatementClient

    client = StatementClient(coord.base_url, dict(TINY))
    _cols, rows = client.execute(sql, on_stats=seen.append)
    jclient, _jcols, jrows = _execute(jcoord.base_url, sql, TINY, jax=True)
    assert rows == jrows == [[15000]] and seen
    stats, jstats = client.stats, jclient.stats
    assert set(jstats) - set(stats) == UNPORTED_STATS_KEYS
    assert set(stats) <= set(jstats)
    for key in ("state", "stages", "completedStages", "completedSplits", "totalSplits",
                "totalRows", "adaptations", "resultRows", "fastPath", "mvHits",
                "resourceGroup"):
        assert stats[key] == jstats[key], key
    # the phase ledger and the flow block: the same keys (their values are
    # host clocks and rates)
    assert set(stats["timeline"]) == set(jstats["timeline"])
    assert set(stats["timeline"]["phases"]) == set(jstats["timeline"]["phases"])
    assert set(stats["flows"]) == set(jstats["flows"])
    from trino_tpu_torch.client import dbapi

    with dbapi.connect(coord.base_url, catalog="tpch", schema="tiny") as conn:
        cur = conn.cursor()
        cur.execute("select count(*) from region")
        assert cur.fetchone() == (5,)
        assert cur.stats["state"] == "FINISHED" and cur.stats["adaptations"] == 0
        assert cur.stats["stages"] >= 1


_MS = re.compile(r"(wall|execute|dispatch_overhead)=\d+\.\dms")
_VERBOSE_BYTES = re.compile(r"(bytes|peak|output)=\d+(KiB)?")
_LEDGER_LINES = ("Phase ledger:", "Data flow:", "Straggler:")


def _masked(text, verbose):
    out = []
    for line in text.split("\n"):
        if line.startswith(_LEDGER_LINES):
            out.append(line.split(":", 1)[0] + ": ...")
            continue
        if line.startswith("Query wall time: "):
            out.append("Query wall time: ...")
            continue
        if line.startswith("Peak task memory by node: "):
            out.append(sorted(int(x) for x in re.findall(r" (\d+)KiB", line)))
            continue
        line = _MS.sub(r"\1=?ms", line)
        if verbose:
            line = _VERBOSE_BYTES.sub(r"\1=?", line)
        out.append(line)
    return out


@pytest.mark.parametrize("verbose", [False, True])
def test_distributed_explain_analyze_q1_equals_the_reference(clusters, verbose):
    coord, jcoord = clusters
    props = dict(TINY, gather_max_rows_per_device=1)
    sql = "explain analyze " + ("verbose " if verbose else "") + QUERIES[1]
    client, cols, rows = _execute(coord.base_url, sql, props)
    _jc, jcols, jrows = _execute(jcoord.base_url, sql, props, jax=True)
    assert cols == jcols == ["Query Plan"]
    text = "\n".join(r[0] for r in rows)
    jtext = "\n".join(r[0] for r in jrows)
    assert _masked(text, verbose) == _masked(jtext, verbose)
    assert "Fragment 0 [source] [tasks=2" in text
    scan = next(line for line in text.split("\n") if "TableScan tpch.tiny.lineitem" in line)
    assert "rows=59837" in scan and "splits=2" in scan
    if verbose:
        assert "launches=" in scan and "dispatch_overhead=" in scan
        assert "device: execute=" in text
    q = coord.get_query(client.query_id)
    assert q.fast_path == "distributed" and q._root_executor is not None
    assert q.cache_status == "BYPASS"
    # the root fragment's rows come from the coordinator's own executor
    final = next(line for line in text.split("\n") if "- Sort" in line)
    assert "rows=4" in final


def test_local_explain_analyze_through_the_coordinator(clusters):
    """A memory-catalog scan runs on the coordinator alone: EXPLAIN ANALYZE
    annotates from the coordinator's executor, as the reference's does."""
    coord, jcoord = clusters
    sqls = ("create table memory.default.ea as select * from tpch.tiny.nation",
            "explain analyze select n_regionkey, count(*) from memory.default.ea group by 1")
    texts = []
    for base, jax in ((coord.base_url, False), (jcoord.base_url, True)):
        _execute(base, sqls[0], TINY, jax=jax)
        _c, _cols, rows = _execute(base, sqls[1], TINY, jax=jax)
        texts.append("\n".join(r[0] for r in rows))
    assert _masked(texts[0], False) == _masked(texts[1], False)
    assert "Peak working set:" in texts[0] and "rows=25" in texts[0]


def test_plain_distributed_query_keeps_the_reference_operator_stats(clusters, monkeypatch):
    """Per-operator stats are on by default in both packages: a plain
    distributed aggregation (no EXPLAIN ANALYZE) leaves the same
    ``system.runtime.tasks`` operators and output rows a task, the same
    stage ``operatorStats`` lengths and ``trino_tpu_operator_rows_total``
    of the scan (orders at tiny, 15000 rows) in both. The compiled tier
    still collects none."""
    import trino_tpu.obs.metrics as JM

    import trino_tpu_torch.obs.metrics as TM
    from trino_tpu_torch import Session
    from trino_tpu_torch.exec import compiled
    from trino_tpu_torch.exec.query import plan_sql

    coord, jcoord = clusters
    sql = "select o_orderpriority, count(*) from orders group by 1 order by 1"
    got = {}
    for base, jax, M in ((coord.base_url, False, TM), (jcoord.base_url, True, JM)):
        scan0 = M.OPERATOR_ROWS.value("TableScan")
        client, _cols, rows = _execute(base, sql, TINY, jax=jax)
        # a task adds its series as its thread ends, just after its last page
        deadline = time.monotonic() + 10.0
        while M.OPERATOR_ROWS.value("TableScan") - scan0 < 15000 and time.monotonic() < deadline:
            time.sleep(0.01)
        scanned = M.OPERATOR_ROWS.value("TableScan") - scan0
        qid = client.query_id
        _c, _cols, tasks = _execute(
            base, "select stage_id, operators, output_rows from system.runtime.tasks "
                  f"where query_id = '{qid}' order by 1, 2, 3", TINY, jax=jax)
        info = wire.json_request("GET", f"{base}/v1/query/{qid}")
        stages = sorted((st["stageId"], len(st["operatorStats"])) for st in info["stageStats"])
        got["jax" if jax else "torch"] = (rows, scanned, tasks, stages)
    assert got["torch"] == got["jax"]
    _rows, scanned, tasks, stages = got["torch"]
    assert scanned == 15000 and tasks and all(t[1] > 0 for t in tasks)
    assert all(n > 0 for _sid, n in stages)
    seen = []
    body = compiled.PreloadedExecutor.execute

    def spy(self, node):
        seen.append(self)
        return body(self, node)

    monkeypatch.setattr(compiled.PreloadedExecutor, "execute", spy)
    s = Session(dict(TINY), device="cpu")
    cq = compiled.CompiledQuery.build(s, plan_sql(s, sql))
    assert cq.run().to_pylist() == [tuple(r) for r in got["torch"][0]]
    assert seen and all(not ex.collect_stats and ex.node_stats == {} for ex in seen)
