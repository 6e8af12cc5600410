"""The port's cluster memory management (trino_tpu_torch/server/
cluster_memory.py, the workers' memory announce and the coordinator's
low-memory killer) against the JAX package's, on the CPU.

The units of the reference's tests/test_cluster_memory.py run through both
packages' ``ClusterMemoryManager``: the kill policy, one kill a pressure
window, the staleness guard of the revocable bytes and the dispatch gate
over a cluster limit. Then, on a port cluster of two workers with 64 KiB
pools, ``test_oversized_query_killed_small_query_finishes``: the orders x
lineitem join FAILS with EXCEEDED_CLUSTER_MEMORY, its postmortem carries
the memory-ledger snapshot, and ``select count(*) from nation`` then gives
the JAX Session's rows. The reference's version races a 0.5 s announce
against the join; here every task of the join is held RUNNING at the end
of its body (the test patches ``SqlTask._prepare_out``, so the task keeps
its reservation) while the test feeds each worker's announce payload into
the coordinator's manager itself, so the kill does not depend on timing.
Last, the pool-overflow shed: a worker whose queries and warm device cache
overflow its pool sheds the cache (a ``pool-overflow`` ledger event), not
a query, and the announce carries the reference's memory fields.
"""
import threading
import time
import types

import pytest

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
from trino_tpu.client.session import Session as JaxSession

from trino_tpu_torch.devcache import DEVICE_CACHE, CacheKey
from trino_tpu_torch.obs.memledger import MEMORY_LEDGER
from trino_tpu_torch.server.coordinator import CoordinatorServer
from trino_tpu_torch.server.task import SqlTask
from trino_tpu_torch.server.worker import WorkerServer

TINY = {"catalog": "tpch", "schema": "tiny"}
POOL = 64 * 1024


def _package(name):
    import importlib

    root = "trino_tpu" if name == "jax" else "trino_tpu_torch"
    return types.SimpleNamespace(name=name,
                                 cm=importlib.import_module(f"{root}.server.cluster_memory"))


JAX = _package("jax")
TORCH = _package("torch")


def both(case, *args):
    want = case(JAX, *args)
    got = case(TORCH, *args)
    assert got == want, f"{case.__name__}: the port's {got} != the reference's {want}"
    return got


# ---------------------------------------------------------------- units
def _policy(pkg):
    kill = pkg.cm.total_reservation_killer
    return kill({"a": 10, "b": 99, "c": 5}), kill({})


def test_killer_policy_picks_largest_reservation():
    assert both(_policy) == ("b", None)


def _kill_once(pkg):
    killed = []
    mgr = pkg.cm.ClusterMemoryManager(kill=lambda q, r: killed.append((q, r)))
    mgr.update("w0", {"queryMemory": {"q1": 100, "q2": 900}, "memoryBytes": 1000,
                      "memoryLimit": 500})
    first = list(killed)
    # the victim's reservations are forgotten at once: the same pressure
    # window must not take a second victim
    mgr.update("w0", {"queryMemory": {"q1": 100}, "memoryBytes": 100, "memoryLimit": 500})
    return first, len(killed), mgr.kills, mgr.query_reservations()


def test_manager_kills_once_per_pressure_window():
    first, n, kills, reservations = both(_kill_once)
    assert [q for q, _ in first] == ["q2"] and n == 1
    assert "EXCEEDED_CLUSTER_MEMORY" in first[0][1] and kills == first
    assert reservations == {"q1": 100}


def _only_blocked_candidates(pkg):
    killed = []
    mgr = pkg.cm.ClusterMemoryManager(kill=lambda q, r: killed.append(q))
    # q-big holds the most cluster-wide, but on w1, which is under its pool;
    # the victim must hold memory on the over-limit node
    mgr.update("w1", {"queryMemory": {"q-big": 5000}, "memoryBytes": 5000,
                      "memoryLimit": 10_000})
    mgr.update("w0", {"queryMemory": {"q-small": 900}, "memoryBytes": 900,
                      "memoryLimit": 500})
    return killed


def test_killer_takes_a_query_holding_the_over_limit_node():
    assert both(_only_blocked_candidates) == ["q-small"]


def _staleness(pkg):
    mgr = pkg.cm.ClusterMemoryManager(kill=lambda q, r: None, heartbeat_interval_s=0.2)
    payload = {"queryMemory": {}, "memoryBytes": 0, "memoryLimit": None,
               "deviceCacheBytes": 4096, "hostCacheBytes": 1024}
    mgr.update("w0", payload)
    out = [mgr.revocable_bytes()]
    time.sleep(pkg.cm.ClusterMemoryManager.STALE_HEARTBEATS * 0.2 + 0.2)
    out.append(mgr.revocable_bytes())
    mgr.update("w0", payload)  # the worker comes back
    out.append(mgr.revocable_bytes())
    return out


def test_revocable_bytes_staleness_guard():
    """A dead worker's cache bytes stop counting as reclaimable headroom
    after STALE_HEARTBEATS missed heartbeats; a fresh announce restores
    them."""
    assert both(_staleness) == [5120, 0, 5120]


def _gate(pkg):
    mgr = pkg.cm.ClusterMemoryManager(kill=lambda q, r: None, cluster_limit_bytes=1000)
    out = [mgr.has_headroom(), mgr.effective_limit()]
    mgr.update("w0", {"queryMemory": {"q": 2000}, "memoryBytes": 2000, "memoryLimit": None})
    out.append(mgr.has_headroom())
    hw = pkg.cm.ClusterMemoryManager(kill=lambda q, r: None)
    out.append(hw.effective_limit())
    # a hardware-derived limit clamps each node's reservation at its
    # capacity; a node that announced none leaves the limit unknown
    hw.update("w0", {"queryMemory": {"q": 10**12}, "memoryBytes": 10**12, "memoryLimit": None,
                     "deviceMemoryBytes": 8 << 30})
    hw.update("w1", {"queryMemory": {}, "memoryBytes": 0, "memoryLimit": None,
                     "deviceMemoryBytes": 8 << 30})
    out += [hw.effective_limit(), hw.has_headroom(), hw.cluster_reserved()]
    hw.update("w2", {"queryMemory": {}, "memoryBytes": 0, "memoryLimit": None})
    out.append(hw.device_capacity_total())
    return out


def test_dispatch_gate_blocks_over_cluster_limit():
    assert both(_gate) == [True, 1000, False, None, 16 << 30, True, 10**12, None]


# ----------------------------------------------------- the killer, end to end
@pytest.fixture()
def tight_cluster():
    """Two workers whose pools are 64 KiB: any real scan overflows them."""
    coord = CoordinatorServer(device="cpu")
    coord.start()
    workers = [WorkerServer(coordinator_url=coord.base_url, node_id=f"mw{i}",
                            memory_limit_bytes=POOL, device="cpu") for i in range(2)]
    for w in workers:
        w.start()
    try:
        assert coord.registry.wait_for_workers(2, timeout=15.0)
        yield coord, workers
    finally:
        for w in workers:
            w.stop()
        coord.stop()


def test_oversized_query_killed_small_query_finishes(tight_cluster, monkeypatch):
    coord, workers = tight_cluster
    held = threading.Event()
    release = threading.Event()
    prepare_out = SqlTask._prepare_out

    def hold_then_prepare(task, out):
        # a task of the join holds its reservation RUNNING until released
        if "lineitem" in repr(task.request.fragment_root) or "orders" in repr(
                task.request.fragment_root):
            held.set()
            release.wait(60.0)
        return prepare_out(task, out)

    monkeypatch.setattr(SqlTask, "_prepare_out", hold_then_prepare)
    big = coord.submit(
        "select o_orderpriority, count(*) c, sum(l_quantity) q "
        "from orders, lineitem where o_orderkey = l_orderkey "
        "group by o_orderpriority order by o_orderpriority", dict(TINY))
    try:
        assert held.wait(60.0), (big.state.get(), big.failure)
        # feed the workers' live reservations into the manager while the
        # tasks hold them (an announce loop may get there first: same kill)
        deadline = time.time() + 60
        while not big.state.is_terminal() and time.time() < deadline:
            for w in workers:
                coord.cluster_memory.update(w.node_id, w.announce_payload())
            time.sleep(0.05)
    finally:
        release.set()
    assert big.state.wait_for_terminal(60.0) == "FAILED", big.state.get()
    assert "EXCEEDED_CLUSTER_MEMORY" in (big.failure or ""), big.failure
    # the one victim (an announce racing its cancel may name it again)
    assert {q for q, _ in coord.cluster_memory.kills} == {big.query_id}
    # the postmortem: the coordinator's flight recorder and memory-ledger
    # snapshot, and each worker's ring pulled over HTTP
    deadline = time.time() + 15
    while big.postmortem is None and time.time() < deadline:
        time.sleep(0.05)
    pm = big.postmortem
    assert pm and pm["state"] == "FAILED" and "EXCEEDED_CLUSTER_MEMORY" in pm["failure"]
    mem = pm["coordinator"]["memory"]
    assert set(mem) == {"nodeId", "pools", "topConsumers", "sheds"}
    assert mem["topConsumers"]  # someone held memory when the query died
    for rows in mem["topConsumers"].values():
        assert 0 < len(rows) <= 3
    # the killed query's reservation is in the process ledger (the top three
    # consumers are the process's, whichever queries ran before)
    assert any(r["owner"] == f"query:{big.query_id}" and r["peakBytes"] > POOL
               for r in MEMORY_LEDGER.owner_rows())
    assert {w["nodeId"] for w in pm["workers"]} <= {"mw0", "mw1"}
    assert all(set(w["memory"]) == set(mem) for w in pm["workers"])
    # the cluster stays usable: a small query finishes with the JAX rows
    small = coord.submit("select count(*) from nation", dict(TINY))
    assert small.state.wait_for_terminal(60.0) == "FINISHED", small.failure
    want = JaxSession(dict(TINY)).execute("select count(*) from nation").rows
    assert small.rows == want == [(25,)]


# ------------------------------------------------------- pool-overflow shed
def _events_since(marker):
    events = MEMORY_LEDGER.snapshot()
    for i in range(len(events) - 1, -1, -1):
        if events[i]["owner"] == marker:
            return events[i + 1:]
    return events


def test_pool_overflow_sheds_the_cache_not_the_query():
    """A worker's announce tick: queries that fit the pool, plus warm
    device-cache tables that do not, yield the cache down to the pool
    (one ``pool-overflow`` shed event); nothing is killed."""
    DEVICE_CACHE.invalidate_all()
    w = WorkerServer(node_id="ow0", memory_limit_bytes=10_000, device="cpu")
    w.start()
    try:
        for i in range(6):
            DEVICE_CACHE.lookup_or_stage(
                CacheKey("c", "s", f"ov{i}", "v1", "sig", "table", 1, "cpu"),
                lambda: (object(), 1, 3000, 1))
        assert DEVICE_CACHE.cached_bytes() == 18_000
        marker = f"test-marker:overflow:{time.time_ns()}"
        MEMORY_LEDGER.record_event("watermark", "device", marker, 0)
        payload = w.announce_payload()
        sheds = [e for e in _events_since(marker) if e["kind"] == "shed"]
        assert [(e["reason"], e["bytes"]) for e in sheds] == [("pool-overflow", 9000)]
        assert DEVICE_CACHE.cached_bytes() == 9000 <= w.memory_limit_bytes
        assert {"queryMemory", "memoryBytes", "memoryLimit", "deviceMemoryBytes",
                "deviceCacheBytes", "hostCacheBytes", "hostCacheHits", "memoryOwners",
                "rssBytes"} <= set(payload)
        assert payload["memoryLimit"] == 10_000 and payload["deviceCacheBytes"] == 9000
        owners = {(r["pool"], r["owner"]): r for r in payload["memoryOwners"]}
        assert owners[("device", "device-cache")]["bytes"] == 9000
        assert owners[("device", "total")]["bytes"] >= 9000
    finally:
        w.stop()
        DEVICE_CACHE.invalidate_all()


def test_memory_limit_from_the_environment(monkeypatch):
    monkeypatch.setenv("TRINO_TPU_WORKER_MEMORY_BYTES", "12345")
    monkeypatch.setenv("TRINO_TPU_HOST_MEMORY_LIMIT_BYTES", "678")
    w = WorkerServer(device="cpu")
    w.start()
    try:
        assert (w.memory_limit_bytes, w.host_memory_limit_bytes) == (12345, 678)
    finally:
        w.stop()
