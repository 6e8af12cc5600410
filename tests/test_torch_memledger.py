"""The port's memory ledger (trino_tpu_torch/obs/memledger.py) and its
producers against the JAX package's, on the CPU.

The cases of the reference's tests/test_memledger.py: the same event
sequences go through both packages' ``MemoryLedger`` and their
``snapshot``, ``owner_rows``, ``watermarks``, ``pool_peaks`` and
``memory_snapshot`` must be equal (timestamps masked); the shed-escalation
order of ``shed_revocable`` (host tier first, one ``shed`` event a tier),
a shed that frees nothing, ``MemoryContext(owner=...)`` reserve deltas and
its release, the staging scratch's reserve and release, and a postmortem
naming the shed tier and the top consumers, each through both packages'
caches, contexts and transfers. Then the port's own: the device cache's
ledger events carry their group as an owner suffix, evicted entries drop
their tensors, and ``device_memory_bytes`` is None without a card.
"""
import itertools
import types

import numpy as np
import pytest

import trino_tpu  # noqa: F401  (turns on JAX x64 first)

_marker_seq = itertools.count()


def _package(name):
    import importlib

    root = "trino_tpu" if name == "jax" else "trino_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    return types.SimpleNamespace(
        name=name, ml=mod("obs.memledger"), devcache=mod("devcache"),
        hostcache=mod("devcache.hostcache"), memory=mod("exec.memory"),
        staging=mod("exec.staging"), coordinator=mod("server.coordinator"),
        kw={"device": "cpu"} if name == "torch" else {})


JAX = _package("jax")
TORCH = _package("torch")


def both(case, *args):
    want = case(JAX, *args)
    got = case(TORCH, *args)
    assert got == want, f"{case.__name__}: the port's {got} != the reference's {want}"
    return got


@pytest.fixture(autouse=True)
def fresh_caches():
    for pkg in (JAX, TORCH):
        pkg.devcache.DEVICE_CACHE.invalidate_all()
        pkg.devcache.HOST_CACHE.invalidate_all()
    yield
    for pkg in (JAX, TORCH):
        pkg.devcache.DEVICE_CACHE.invalidate_all()
        pkg.devcache.HOST_CACHE.invalidate_all()


def _masked(records):
    """Records without their clocks."""
    return [{k: v for k, v in r.items() if k not in ("ts", "updatedAt")} for r in records]


def _mark(pkg) -> str:
    """A uniquely owned marker in the process ledger, so a case reads back
    its own events even after the shared ring wrapped."""
    owner = f"test-marker:{next(_marker_seq)}"
    pkg.ml.MEMORY_LEDGER.record_event("watermark", pkg.ml.POOL_DEVICE, owner, 0)
    return owner


def _events_since(pkg, marker):
    events = pkg.ml.MEMORY_LEDGER.snapshot()
    for i in range(len(events) - 1, -1, -1):
        if events[i]["owner"] == marker:
            return events[i + 1:]
    return events


# ----------------------------------------------------------- unit contract
def _bounded(pkg):
    led = pkg.ml.MemoryLedger(capacity=8)
    for _ in range(50):
        led.record_event("reserve", pkg.ml.POOL_DEVICE, "query:q", 1)
    return len(led), _masked(led.snapshot()), _masked(led.owner_rows())


def test_event_ring_is_bounded():
    n, snap, rows = both(_bounded)
    assert n == 8 and len(snap) == 8
    # owner accounting keeps the whole history after the ring wrapped
    assert rows == [{"pool": "device", "owner": "query:q", "bytes": 50, "peakBytes": 50,
                     "events": 50}]


def _unknown_kind(pkg):
    with pytest.raises(ValueError, match="unknown memory-ledger event kind") as ei:
        pkg.ml.MemoryLedger().record_event("borrow", pkg.ml.POOL_DEVICE, "query:q", 1)
    return str(ei.value), pkg.ml.EVENT_KINDS


def test_unknown_event_kind_rejected():
    both(_unknown_kind)


def _accounting(pkg):
    led = pkg.ml.MemoryLedger()
    led.record_event("reserve", pkg.ml.POOL_DEVICE, "query:a", 1000)
    led.record_event("admit", pkg.ml.POOL_DEVICE, "device-cache", 400)
    led.record_event("release", pkg.ml.POOL_DEVICE, "query:a", 600)
    first = _masked(led.owner_rows())
    led.record_event("evict", pkg.ml.POOL_DEVICE, "device-cache", 9999)  # never negative
    return first, _masked(led.owner_rows()), _masked(led.snapshot())


def test_live_and_peak_accounting():
    first, second, _events = both(_accounting)
    rows = {r["owner"]: r for r in first}
    assert rows["query:a"]["bytes"] == 400 and rows["query:a"]["peakBytes"] == 1000
    rows = {r["owner"]: r for r in second}
    assert rows["device-cache"]["bytes"] == 0 and rows["device-cache"]["peakBytes"] == 400


def _sync(pkg):
    led = pkg.ml.MemoryLedger()
    led.record_event("reserve", pkg.ml.POOL_DEVICE, "query:done", 500)
    led.record_event("reserve", pkg.ml.POOL_DEVICE, "query:live", 300)
    led.sync_pool(pkg.ml.POOL_DEVICE, {"query:live": 800}, prefix="query:")
    led.set_live(pkg.ml.POOL_HOST, "host-cache", 70)
    return _masked(led.owner_rows())


def test_sync_pool_reconciles_to_ground_truth():
    rows = {r["owner"]: r for r in both(_sync)}
    assert (rows["query:live"]["bytes"], rows["query:live"]["peakBytes"]) == (800, 800)
    assert (rows["query:done"]["bytes"], rows["query:done"]["peakBytes"]) == (0, 500)


def _watermarks(pkg):
    led = pkg.ml.MemoryLedger(watermark_capacity=4)
    for total in (100, 900, 300):
        led.sample_watermarks({pkg.ml.POOL_DEVICE: total, pkg.ml.POOL_HOST: total // 2},
                              rss_bytes=10_000, device_total_bytes=80 << 30)
    out = [led.pool_peaks(), _masked(led.watermarks()),
           _masked(r for r in led.owner_rows() if r["owner"] == pkg.ml.TOTAL_OWNER)]
    for _ in range(10):
        led.sample_watermarks({pkg.ml.POOL_DEVICE: 1})
    out.append(len(led.watermarks()))
    return out


def test_watermark_sampling_tracks_pool_peaks():
    peaks, samples, totals, bounded = both(_watermarks)
    assert peaks == {"device": 900, "host": 450}
    assert samples[-1] == {"device": 300, "host": 150, "rssBytes": 10_000,
                           "deviceTotalBytes": 80 << 30}
    assert {r["pool"]: (r["bytes"], r["peakBytes"]) for r in totals}["device"] == (300, 900)
    assert bounded == 4


def _snapshot(pkg):
    led = pkg.ml.MemoryLedger(node_id="n1")
    for owner, peak in (("query:a", 100), ("query:b", 900), ("query:c", 500),
                        ("query:d", 300)):
        led.record_event("reserve", pkg.ml.POOL_DEVICE, owner, peak)
    led.sample_watermarks({pkg.ml.POOL_DEVICE: 1800})
    led.record_event("shed", pkg.ml.POOL_HOST, "host-cache", 64, reason="host-pressure")
    snap = led.memory_snapshot(top=3)
    snap["topConsumers"] = {p: _masked(rows) for p, rows in snap["topConsumers"].items()}
    snap["sheds"] = _masked(snap["sheds"])
    return snap


def test_memory_snapshot_ranks_top_consumers():
    snap = both(_snapshot)
    assert snap["nodeId"] == "n1" and snap["pools"]["device"]["peakBytes"] == 1800
    assert [r["owner"] for r in snap["topConsumers"]["device"]] == [
        "query:b", "query:c", "query:d"]
    assert snap["sheds"][-1]["reason"] == "host-pressure"


def _mirror(pkg):
    class FakeRecorder:
        def __init__(self):
            self.records = []

        def record(self, category, name, **attrs):
            self.records.append((category, name, attrs))

    led = pkg.ml.MemoryLedger()
    rec = FakeRecorder()
    led.attach_recorder(rec)
    led.record_event("reserve", pkg.ml.POOL_DEVICE, "query:q", 10)  # not mirrored
    led.record_event("shed", pkg.ml.POOL_DEVICE, "device-cache", 2048, reason="spill")
    return rec.records


def test_shed_events_mirror_into_flight_recorder():
    assert both(_mirror) == [("memory", "memory/shed", {
        "pool": "device", "owner": "device-cache", "bytes": 2048, "reason": "spill"})]


# ------------------------------------------------- shed-escalation ordering
def _key(pkg, *parts):
    extra = ("cpu",) if pkg.name == "torch" else ()
    return pkg.devcache.CacheKey(*parts, *extra)


def _fill_both_tiers(pkg):
    for i in range(4):
        pkg.devcache.HOST_CACHE.lookup_or_stage(
            _key(pkg, "c", "s", f"h{i}", "v1", "sig", f"host:{i}", 1),
            lambda: (object(), 1, 1000, 1))
        pkg.devcache.DEVICE_CACHE.lookup_or_stage(
            _key(pkg, "c", "s", f"d{i}", "v1", "sig", "table", 1),
            lambda: (object(), 1, 1000, 1))


def _escalation(pkg, monkeypatch):
    monkeypatch.setattr(pkg.hostcache, "_device_memory_host_backed", lambda: True)
    _fill_both_tiers(pkg)
    out = []
    for request in (2500, 3000, 2000):
        mark = _mark(pkg)
        freed = pkg.devcache.shed_revocable(request)
        sheds = [(s["pool"], s["owner"], s["bytes"], s["reason"])
                 for s in _events_since(pkg, mark) if s["kind"] == "shed"]
        out.append((freed, sheds))
    return out


def test_shed_escalation_order_in_ledger(monkeypatch):
    """Host pressure sheds the host tier first (``host-pressure``) and the
    device tier only for the rest (``rss-escalation``), one event a tier;
    once both are empty a shed frees nothing and records nothing."""
    got = both(_escalation, monkeypatch)
    assert got == [
        (3000, [("host", "host-cache", 3000, "host-pressure")]),
        (3000, [("host", "host-cache", 1000, "host-pressure"),
                ("device", "device-cache", 2000, "rss-escalation")]),
        (2000, [("device", "device-cache", 2000, "rss-escalation")]),
    ]
    mark = _mark(TORCH)
    assert TORCH.devcache.shed_revocable(1000) == 0
    assert [r for r in _events_since(TORCH, mark) if r["kind"] == "shed"] == []


def test_cuda_cache_is_not_host_backed(monkeypatch):
    """Where the device cache holds card memory, host pressure never
    reaches it: only the host tier sheds."""
    assert TORCH.devcache.DEVICE_CACHE.max_bytes  # the budget, before the patch
    monkeypatch.setattr(TORCH.devcache.cache, "_device_memory_cell", [80 << 30])
    assert not TORCH.hostcache._device_memory_host_backed()
    _fill_both_tiers(TORCH)
    assert TORCH.devcache.shed_revocable(6000) == 4000
    assert TORCH.devcache.DEVICE_CACHE.cached_bytes() == 4000
    monkeypatch.setattr(TORCH.devcache.cache, "_device_memory_cell", [None])
    assert TORCH.hostcache._device_memory_host_backed()


# -------------------------------------------------- per-query attribution
def _context(pkg):
    owner = f"query:ledger-ut-{pkg.name}"
    ctx = pkg.memory.MemoryContext(owner=owner)
    mark = _mark(pkg)
    ctx.observe(1000)
    ctx.observe(700)    # below the peak: no new reservation
    ctx.observe(1500)   # the +500 delta only
    events = [(e["kind"], e["bytes"]) for e in _events_since(pkg, mark) if e["owner"] == owner]
    row = next(r for r in pkg.ml.MEMORY_LEDGER.owner_rows() if r["owner"] == owner)
    live = (row["bytes"], row["peakBytes"])
    ctx.release()
    row = next(r for r in pkg.ml.MEMORY_LEDGER.owner_rows() if r["owner"] == owner)
    return events, live, (row["bytes"], row["peakBytes"])


def test_memory_context_owner_deltas_never_double_count():
    events, live, after = both(_context)
    assert events == [("reserve", 1000), ("reserve", 500)]
    assert live == (1500, 1500) and after == (0, 1500)


def _scratch(pkg):
    if pkg.name == "torch":
        transfer = pkg.staging.blocked_transfer("cpu", block_bytes=1024)
    else:
        transfer = pkg.staging.blocked_transfer(block_bytes=1024)
    mark = _mark(pkg)
    out = transfer(np.arange(1024, dtype=np.int64))
    events = [(e["kind"], e["bytes"]) for e in _events_since(pkg, mark)
              if e["owner"] == "staging"]
    row = next(r for r in pkg.ml.MEMORY_LEDGER.owner_rows()
               if r["owner"] == "staging" and r["pool"] == "device")
    return np.asarray(out).tolist() == list(range(1024)), events, row["bytes"]


def test_staging_scratch_attributed_and_released():
    """A transfer past two blocks holds device scratch for its lifetime:
    one reserve, one release of the same bytes, 0 live after."""
    ok, events, live = both(_scratch)
    assert ok and events == [("reserve", 8192), ("release", 8192)] and live == 0


def test_spill_yield_is_a_spill_shed():
    """The spill decision's cache yield is one ``spill`` shed, charged to
    the query's context."""
    cache = TORCH.devcache.DEVICE_CACHE
    for i in range(4):
        cache.lookup_or_stage(_key(TORCH, "c", "s", f"sp{i}", "v1", "sig", "table", 1),
                              lambda: (object(), 1, 1000, 1))
    ctx = TORCH.memory.MemoryContext(budget_bytes=1000, owner="query:spill-ut")
    mark = _mark(TORCH)
    parts = ctx.spill_partitions(4000)
    sheds = [(e["owner"], e["bytes"], e["reason"]) for e in _events_since(TORCH, mark)
             if e["kind"] == "shed"]
    assert parts == 4 and sheds == [("device-cache", 1000, "spill")]
    assert (ctx.shed_bytes, ctx.yields) == (1000, 1)


# ------------------------------------------------------------- postmortem
def _postmortem(pkg):
    for i in range(3):
        pkg.devcache.HOST_CACHE.lookup_or_stage(
            _key(pkg, "c", "s", f"pm{i}", "v1", "sig", f"host:{i}", 1),
            lambda: (object(), 1, 1000, 1))
    assert pkg.devcache.shed_revocable(1500) >= 1500  # a forced pressure shed
    coord = pkg.coordinator.CoordinatorServer(**pkg.kw)
    coord.start()
    try:
        ex = coord.submit("select count(*) from nation",
                          {"catalog": "tpch", "schema": "tiny", "short_query_fast_path": "true"})
        assert ex.state.wait_for_terminal(60.0) == "FINISHED", ex.failure
        pm = ex.capture_postmortem(store=False)
    finally:
        coord.stop()
    mem = pm["coordinator"]["memory"]
    shed = next(s for s in reversed(mem["sheds"]) if s["reason"] == "host-pressure")
    host_top = mem["topConsumers"].get("host") or []
    return (sorted(mem), (shed["pool"], shed["owner"]), len(host_top) <= 3,
            any(r["owner"] == "host-cache" and r["peakBytes"] >= 3000 for r in host_top),
            pm["state"], sorted(pm))


def test_postmortem_names_shed_tier_and_top_consumers():
    got = both(_postmortem)
    assert got[:5] == (["nodeId", "pools", "sheds", "topConsumers"], ("host", "host-cache"),
                       True, True, "FINISHED")


# ------------------------------------------------------- the port's own
def test_grouped_cache_events_carry_the_group():
    from trino_tpu_torch.server import resource_groups as rg

    cache = TORCH.devcache.cache.DeviceTableCache(max_bytes=1000)
    mark = _mark(TORCH)
    tok = rg.set_current_group("global.t")
    try:
        for i in range(3):
            cache.lookup_or_stage(_key(TORCH, "c", "s", f"g{i}", "v1", "sig", "table", 1),
                                  lambda: (object(), 1, 400, 1))
    finally:
        rg.reset_current_group(tok)
    cache.lookup_or_stage(_key(TORCH, "c", "s", "u", "v1", "sig", "table", 1),
                          lambda: (object(), 1, 100, 1))
    assert cache.evict_to(500, reason="trim") == 400
    events = [(e["kind"], e["owner"], e["bytes"], e.get("reason"))
              for e in _events_since(TORCH, mark)]
    assert events == [
        ("admit", "device-cache:global.t", 400, None),
        ("admit", "device-cache:global.t", 400, None),
        ("evict", "device-cache:global.t", 400, "lru"),
        ("admit", "device-cache:global.t", 400, None),
        ("admit", "device-cache", 100, None),
        ("evict", "device-cache:global.t", 400, "trim"),
    ]
    assert cache.group_bytes() == {"global.t": 400, None: 100}


def test_evicted_entries_drop_their_tensors():
    """An evicted entry's tensors are no longer referenced by the cache, so
    the allocator gets their bytes back (on the card, memory_allocated
    falls; chip_smoke.py checks that)."""
    import gc
    import weakref

    import torch

    cache = TORCH.devcache.cache.DeviceTableCache(max_bytes=10_000)
    t = torch.zeros(1000, dtype=torch.int64)
    ref = weakref.ref(t)
    cache.lookup_or_stage(_key(TORCH, "c", "s", "tt", "v1", "sig", "table", 1),
                          lambda: (t, 1000, 8000, 1))
    del t
    gc.collect()
    assert ref() is not None
    assert cache.yield_bytes(1) == 8000
    gc.collect()
    assert ref() is None


def test_device_memory_is_none_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert TORCH.devcache.device_memory_bytes() is None
    # and the announce carries it as such (the worker samples the same)
    led = TORCH.ml.MemoryLedger()
    led.sample_watermarks({"device": 1}, device_total_bytes=TORCH.devcache.device_memory_bytes())
    assert "deviceTotalBytes" not in led.watermarks()[-1]
