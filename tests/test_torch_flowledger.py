"""The port's flow ledger (trino_tpu_torch/obs/flowledger.py) and its
record sites, held against the JAX package on the CPU.

The cases of the reference's tests/test_flowledger.py. The units give the
same transfer and stall sequence, and the same task stats, to both
packages' ``FlowLedger`` and ``detect_stragglers``; rollups, rings, net
totals and verdicts must be exactly equal (the record timestamps aside).
The output buffer's full-wait runs in both packages. The cluster cases run
TPC-H Q3 at ``tiny`` on a port CPU cluster and a JAX CPU cluster (two
in-process workers each). In the port, the exchange-pull bytes of a query
equal the ``EXCHANGE_BYTES`` delta exactly, and the staging-transfer bytes
the ``STAGED_H2D_BYTES`` delta. Both clusters must show the same link
classes and owners, and the same payload keys of ``/flows``, the system
tables, the CLI's drain tag, EXPLAIN ANALYZE's "Data flow:" line and the
postmortem's flow block.

Left out by name: ``test_flow_docs_gate_green`` (tools/check_flow_docs.py
reads the README against the JAX package) and ``test_flows_check``
(microbench/flows.py, a gate of the JAX package). In their place,
``test_link_classes_equal_the_reference`` holds the port's link classes,
stall sites and causes to the reference's, and ``test_byte_conservation``
is exact where the reference asks for 95%. A cluster whose workers share
the coordinator's process counts the shared ledger once in the port
(``system_tables.cluster_rows``); the reference counts it once a server.
So ``/flows`` and ``system.runtime.transfers`` are compared by their link
and owner sets.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_obs_common import (BOTH, JAX, Q3_SQL, TINY, TORCH, both_clusters,  # noqa: E402
                              execute, get_json, query, wait_terminal)


def _strip(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def _both(fn):
    got, want = fn(TORCH), fn(JAX)
    assert got == want
    return got


# ----------------------------------------------------------- unit contract
def test_link_classes_equal_the_reference():
    for name in ("LINK_CLASSES", "STALL_SITES", "STRAGGLER_CAUSES", "DEFAULT_CAPACITY",
                 "STALL_CAPACITY", "DEFAULT_STRAGGLER_MULTIPLE",
                 "DEFAULT_STRAGGLER_MIN_ELAPSED_S"):
        assert getattr(TORCH.flow, name) == getattr(JAX.flow, name), name
    for attr in ("TRANSFER_BYTES", "TRANSFER_SECONDS", "BACKPRESSURE_STALL_SECONDS",
                 "STRAGGLER_TASKS", "EXCHANGE_REQUESTS", "EXCHANGE_RETRIES",
                 "EXCHANGE_OVERLAPPED", "OPERATOR_ROWS", "OPERATOR_WALL_SECONDS",
                 "OTLP_DROPPED", "FAST_PATH_QUERIES", "QUERY_PHASE_SECONDS"):
        mine, ref = getattr(TORCH.M, attr), getattr(JAX.M, attr)
        assert (mine.name, mine.type_name, mine.help, mine.labelnames) == (
            ref.name, ref.type_name, ref.help, ref.labelnames), attr
        assert TORCH.M.REGISTRY.get(mine.name) is mine


def test_transfer_ring_bounded_rollup_complete():
    def case(pkg):
        led = pkg.flow.FlowLedger(capacity=8)
        for _ in range(50):
            led.record_transfer("exchange-pull", "task:q.1", 10, 0.001, pages=1)
        return len(led), len(led.snapshot()), led.transfer_rows()

    n, snap, rows = _both(case)
    assert n == snap == 8
    row = next(r for r in rows if r["owner"] == "task:q.1")
    assert row["transfers"] == 50 and row["bytes"] == 500 and row["pages"] == 50


def test_unknown_link_and_stall_site_rejected():
    for pkg in BOTH:
        led = pkg.flow.FlowLedger()
        with pytest.raises(ValueError, match="unknown flow-ledger link"):
            led.record_transfer("carrier-pigeon", "task:q", 1, 0.0)
        with pytest.raises(ValueError, match="unknown flow-ledger stall site"):
            led.record_stall("disk-flush", 1, 0, 0.1)


def test_rollup_rates_net_totals_and_owner_bytes():
    def case(pkg):
        led = pkg.flow.FlowLedger(node_id="n1")
        led.record_transfer("exchange-pull", "task:qa.1", 4_000_000, 2.0, direction="recv")
        led.record_transfer("client-drain", "drain:qa", 1_000_000, 1.0, direction="send")
        led.record_transfer("exchange-pull", "task:qb.1", 500, 0.1)
        snap = led.flow_snapshot()
        snap["recent"] = _strip(snap["recent"])
        return (led.transfer_rows(), led.net_totals(), led.owner_bytes("task:qa."),
                led.owner_bytes("task:", links=("exchange-pull",)),
                led.owner_bytes("drain:qa"), snap)

    rows, net, qa, pulls, drain, snap = _both(case)
    assert next(r for r in rows if r["owner"] == "task:qa.1")["mbPerS"] == pytest.approx(2.0)
    assert net == {"sent": 1_000_000, "received": 4_000_500}
    assert (qa, pulls, drain) == (4_000_000, 4_000_500, 1_000_000)
    assert snap["nodeId"] == "n1" and snap["links"]["exchange-pull"]["bytes"] == 4_000_500


@pytest.mark.parametrize("seed", range(3))
def test_seeded_sequence_equals_the_reference(seed):
    """One seeded sequence of transfers (every link, both directions,
    retries, ring or not) and stalls through both ledgers."""
    rng = np.random.default_rng(seed)
    links = list(JAX.flow.LINK_CLASSES)
    ops = []
    for i in range(300):
        if rng.random() < 0.8:
            ops.append(("t", links[int(rng.integers(0, len(links)))],
                        f"task:q{int(rng.integers(0, 3))}.{int(rng.integers(0, 2))}",
                        int(rng.integers(0, 10**6)), float(rng.random()),
                        int(rng.integers(0, 9)), "send" if rng.random() < 0.3 else "recv",
                        int(rng.integers(0, 2)) * int(rng.integers(0, 4)),
                        str(int(rng.integers(200, 504))), bool(rng.random() < 0.8)))
        else:
            ops.append(("s", JAX.flow.STALL_SITES[int(rng.integers(0, 2))],
                        int(rng.integers(0, 4)), int(rng.integers(0, 3)),
                        float(rng.random()), int(rng.integers(0, 10**5))))

    def case(pkg):
        led = pkg.flow.FlowLedger(node_id="n", capacity=64, stall_capacity=32)
        for op in ops:
            if op[0] == "t":
                _, link, owner, nb, sec, pages, direction, retries, status, ring = op
                led.record_transfer(link, owner, nb, sec, pages=pages, direction=direction,
                                    retries=retries, status=status, ring=ring)
            else:
                _, site, stage, part, waited, depth = op
                led.record_stall(site, stage, part, waited, depth_bytes=depth,
                                 limit_bytes=1 << 20)
        return (led.transfer_rows(), led.stall_rows(), led.net_totals(),
                _strip(led.snapshot()), _strip(led.stall_samples(limit=10)),
                led.owner_bytes("task:q1."), len(led))

    _both(case)


# ------------------------------------------------- straggler detector matrix
def _task(tid, stage, elapsed, transfer=0.0, device=0.0, stall=0.0):
    return {"taskId": tid, "fragment": stage, "workerUri": f"http://w{tid}",
            "stats": {"elapsedS": elapsed, "transferS": transfer, "deviceS": device,
                      "stallS": stall, "completedSplits": 4}}


def _detect(tasks, **kw):
    return _both(lambda pkg: pkg.flow.detect_stragglers(tasks, **kw))


def test_uniform_stage_flags_nothing():
    assert _detect([_task(f"q.1.{i}", 1, 1.0 + 0.01 * i) for i in range(4)]) == []


@pytest.mark.parametrize("transfer,device,stall,cause", [
    (8.0, 1.0, 0.5, "transfer-bound"),
    (1.0, 8.0, 0.5, "device-bound"),
    (0.5, 1.0, 8.0, "queue-bound"),
])
def test_10x_task_flags_with_dominant_cause(transfer, device, stall, cause):
    tasks = [_task(f"q.1.{i}", 1, 1.0) for i in range(3)]
    tasks.append(_task("q.1.3", 1, 10.0, transfer, device, stall))
    flagged = _detect(tasks)
    assert len(flagged) == 1
    f = flagged[0]
    assert f["taskId"] == "q.1.3" and f["cause"] == cause
    assert f["ratio"] == pytest.approx(10.0) and f["stageMedianS"] == pytest.approx(1.0)


def test_one_task_stage_never_flags():
    assert _detect([_task("q.1.0", 1, 100.0)]) == []


def test_millisecond_stage_never_flags():
    tasks = [_task(f"q.1.{i}", 1, 0.002) for i in range(3)] + [_task("q.1.3", 1, 0.02)]
    assert _detect(tasks) == []


def test_stages_grouped_independently():
    tasks = ([_task(f"q.1.{i}", 1, 10.0) for i in range(2)]
             + [_task(f"q.2.{i}", 2, 1.0) for i in range(3)]
             + [_task("q.2.3", 2, 9.0, transfer=5.0)])
    flagged = _detect(tasks)
    assert [f["taskId"] for f in flagged] == ["q.2.3"] and flagged[0]["stageId"] == 2


@pytest.mark.parametrize("seed", range(3))
def test_seeded_task_stats_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    tasks = [_task(f"q.{s}.{i}", s, float(rng.exponential(1.0)), float(rng.random() * 5),
                   float(rng.random() * 5), float(rng.random() * 5))
             for s in range(4) for i in range(int(rng.integers(1, 6)))]
    _detect(tasks, multiple=float(rng.uniform(1.2, 3.0)), min_elapsed_s=0.05)
    _both(lambda pkg: [pkg.flow.straggler_cause(t["stats"]) for t in tasks])


def test_cause_ties_resolve_to_device_bound():
    assert _both(lambda pkg: (pkg.flow.straggler_cause({}), pkg.flow.straggler_cause(
        {"transferS": 1.0, "deviceS": 1.0}))) == ("device-bound", "device-bound")


# --------------------------------------------------- backpressure sampling
def test_buffer_full_wait_samples_stall_under_slow_consumer():
    for pkg in BOTH:
        buf = pkg.buffer.OutputBuffer(1, max_buffer_bytes=64, stall_key=("stall-ut", 7))
        page = b"x" * 64

        def produce():
            for _ in range(3):
                buf.enqueue(page, timeout=30.0)
            buf.set_complete()

        t = threading.Thread(target=produce)
        t.start()
        time.sleep(0.15)
        token, got = 0, 0
        while True:
            pages, token, complete, _ = buf.poll(token, timeout=1.0)
            got += len(pages)
            time.sleep(0.05)
            if complete and not pages:
                break
        t.join(timeout=10)
        assert got == 3 and buf.stalled_seconds > 0.1
        roll = next(r for r in pkg.flow.FLOW_LEDGER.stall_rows()
                    if r["site"] == "buffer-enqueue" and r["stage"] == "stall-ut")
        assert roll["partition"] == 7 and roll["waits"] >= 1 and roll["stallS"] > 0.1
        sample = next(s for s in pkg.flow.FLOW_LEDGER.stall_samples()
                      if s.get("stage") == "stall-ut")
        assert sample["depthBytes"] >= 64 and sample["limitBytes"] == 64


# ------------------------------------------------- acceptance, live cluster
@pytest.fixture(scope="module")
def clusters():
    yield from both_clusters("flow-w")


def _link_owners(rows, qid):
    """{(link, owner with the query id masked)} of one query's rows."""
    return {(r["link"], r["owner"].replace(qid, "Q")) for r in rows}


def test_byte_conservation(clusters):
    """Port: the exchange-pull bytes a query recorded equal its
    EXCHANGE_BYTES delta and its staging-transfer bytes its
    STAGED_H2D_BYTES delta, exactly (no other query runs in this
    process meanwhile). Both packages: the decoded wire bytes are covered
    by exchange-pull records (the reference's 95% bound)."""
    from trino_tpu_torch.obs import metrics as TM

    for pkg in BOTH:
        coord = clusters[pkg.name]
        led = pkg.flow.FLOW_LEDGER

        def pulls():
            return sum(r["bytes"] for r in led.transfer_rows() if r["link"] == "exchange-pull")

        def staged():
            return sum(r["bytes"] for r in led.transfer_rows() if r["link"] == "staging-transfer")

        def serde():
            return (pkg.M.SERDE_BYTES.value("decode", "zlib")
                    + pkg.M.SERDE_BYTES.value("decode", "none"))

        s0, p0, st0 = serde(), pulls(), staged()
        if pkg is TORCH:
            ex0, h2d0 = TM.EXCHANGE_BYTES.value(), TM.STAGED_H2D_BYTES.value()
        q = coord.submit(Q3_SQL, dict(TINY))
        assert wait_terminal(q) == "FINISHED", q.failure
        sd, pd = serde() - s0, pulls() - p0
        assert sd > 0 and pd >= 0.95 * sd, (pkg.name, pd, sd)
        assert led.owner_bytes(f"task:{q.query_id}.", links=("exchange-pull",)) > 0
        if pkg is TORCH:
            assert pd == TM.EXCHANGE_BYTES.value() - ex0
            assert staged() - st0 == TM.STAGED_H2D_BYTES.value() - h2d0 > 0
            flows = q.flows_dict()
            assert sum(r["bytes"] for r in flows["transfers"]
                       if r["link"] == "exchange-pull") == pd


def test_flows_endpoint_and_system_tables(clusters):
    out = {}
    for pkg in BOTH:
        coord = clusters[pkg.name]
        q = coord.submit(Q3_SQL, dict(TINY))
        assert wait_terminal(q) == "FINISHED", q.failure
        payload = get_json(pkg, coord, f"/v1/query/{q.query_id}/flows")
        assert payload["queryId"] == q.query_id
        assert {r["link"] for r in payload["transfers"]} >= {"exchange-pull"}
        for row in payload["transfers"]:
            assert (row["owner"].startswith(f"task:{q.query_id}.")
                    or row["owner"] in (f"query:{q.query_id}", f"drain:{q.query_id}"))
        assert payload["stragglers"] == []
        time.sleep(1.2)  # the announces deliver the workers' flow blocks
        _cols, rows = query(pkg, coord, "select node_id, link, owner, bytes, transfers from "
                                        "system.runtime.transfers where bytes > 0")
        links = {r[1] for r in rows}
        assert "exchange-pull" in links and "control" in links
        mine = [r for r in rows if q.query_id in r[2]]
        _cols, srows = query(pkg, coord, "select count(*) from system.runtime.stragglers")
        assert srows[0][0] == 0
        _cols, nrows = query(pkg, coord, "select node_id, net_bytes_sent, net_bytes_received "
                                         "from system.runtime.nodes")
        assert any(int(r[1] or 0) > 0 and int(r[2] or 0) > 0 for r in nrows), nrows
        out[pkg.name] = (sorted(payload), sorted(payload["transfers"][0]),
                         _link_owners(payload["transfers"], q.query_id),
                         {(r[1], r[2].replace(q.query_id, "Q")) for r in mine})
        if pkg is TORCH:
            # the table's link totals of this query equal /flows'
            by_link = {}
            for r in mine:
                by_link[r[1]] = by_link.get(r[1], 0) + r[3]
            want = {}
            for r in payload["transfers"]:
                want[r["link"]] = want.get(r["link"], 0) + r["bytes"]
            assert by_link == want
    assert out["torch"] == out["jax"]


def test_cli_summary_shows_drain_rate(clusters):
    for pkg in BOTH:
        c, _cols, rows = execute(pkg, clusters[pkg.name],
                                 "select o_orderkey, o_totalprice from orders "
                                 "where o_orderkey <= 8000")
        assert rows
        flows = (c.stats or {}).get("flows") or {}
        assert flows.get("drainBytes", 0) > 0 and flows.get("drainMbPerS") is not None
        summary = pkg.cli.render_summary(c.stats)
        assert "drain: " in summary and "MB/s" in summary
        assert "stragglers" not in summary


def test_explain_analyze_data_flow_section(clusters):
    for pkg in BOTH:
        _c, _cols, rows = execute(pkg, clusters[pkg.name], "explain analyze " + Q3_SQL)
        text = "\n".join(r[0] for r in rows)
        flow_line = next(line for line in text.split("\n") if "Data flow: " in line)
        assert "exchange-pull" in flow_line and "MB/s" in flow_line


def test_postmortem_carries_flow_snapshot(clusters):
    out = {}
    for pkg in BOTH:
        q = clusters[pkg.name].submit(Q3_SQL, dict(TINY))
        assert wait_terminal(q) == "FINISHED", q.failure
        pm = q.capture_postmortem(store=False)
        flows = pm["coordinator"]["flows"]
        assert set(flows) >= {"nodeId", "links", "net", "recent", "stalls"}
        assert flows["links"]
        assert pm["workers"]
        for w in pm["workers"]:
            if "error" not in w:
                assert "flows" in w
        out[pkg.name] = (sorted(pm), sorted(pm["coordinator"]), sorted(flows))
    assert out["torch"] == out["jax"]
