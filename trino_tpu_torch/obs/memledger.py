"""Cluster memory ledger: typed per-process ring of memory events (a copy
of trino_tpu/obs/memledger.py; the device total it samples is the CUDA
card's, from ``devcache.device_memory_bytes``).

Reference role: the observability half of Trino's memory contract
(``memory/QueryContext`` reservations rolling up to ``MemoryPool`` +
``ClusterMemoryManager``) — the admission side already exists here
(exec/memory.py, server/cluster_memory.py); this module makes every HBM
and host byte *attributable* the way the phase ledger (obs/timeline.py)
made every millisecond attributable.

Design mirrors the flight recorder (obs/flightrecorder.py): one bounded
ring per process, O(1) append under a short lock, safe on the hot path.
Three stores per ledger:

- an **event ring** of typed records — every reservation, release, cache
  admission/eviction and pressure shed, each naming its *pool* (``device``
  or ``host``), its *owner* (``query:<id>`` / ``device-cache`` /
  ``host-cache`` / ``staging`` / ``mv-storage``) and, for evict/shed, the
  reclaiming *reason*;
- a **live/peak owner table** — bytes currently held and the high-water
  mark per (pool, owner), fed both by events and by ``sync_pool`` (the
  announce loop pushes ground-truth live numbers each heartbeat, so the
  table never drifts from the sources it summarizes);
- a **watermark ring** — per-pool totals + process RSS + the card's
  memory sampled on the announce loop into a bounded time series.

``record_event`` must never be called while holding a lock: the append
itself takes the ledger lock, and shed events fan out to the metrics
registry and the flight recorder.

This module imports only the standard library at import time.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

DEFAULT_CAPACITY = 512
# announce loop samples every 0.5 s -> ~2 minutes of per-node history
WATERMARK_CAPACITY = 240

# every kind a ledger event may carry
EVENT_KINDS = ("reserve", "release", "admit", "evict", "shed", "watermark")

# kinds that grow the owner's live bytes / shrink them
_GROW_KINDS = ("reserve", "admit")
_SHRINK_KINDS = ("release", "evict", "shed")

POOL_DEVICE = "device"
POOL_HOST = "host"

# the synthetic per-pool owner row carrying the pool watermark (so
# attribution = sum(named owners) / total is computable from one table)
TOTAL_OWNER = "total"


class MemoryLedger:
    """One process's memory ledger. Events are plain dicts:
    ``{"ts", "kind", "pool", "owner", "bytes", ["reason", ...]}``."""

    def __init__(self, node_id: str = "", capacity: int = DEFAULT_CAPACITY,
                 watermark_capacity: int = WATERMARK_CAPACITY):
        self.node_id = node_id
        self._ring: "deque[dict]" = deque(maxlen=capacity)
        self._watermarks: "deque[dict]" = deque(maxlen=watermark_capacity)
        self._lock = threading.Lock()
        # (pool, owner) -> live bytes / peak bytes / event count
        self._live: Dict[tuple, int] = {}
        self._peak: Dict[tuple, int] = {}
        self._events: Dict[tuple, int] = {}
        self._updated: Dict[tuple, float] = {}
        # pool -> peak of the sampled pool total (bench + queryStats)
        self._pool_peak: Dict[str, int] = {}
        self._recorder = None

    # ------------------------------------------------------------ wiring
    def attach_recorder(self, recorder) -> None:
        """Mirror shed events into the process flight recorder so OOM
        postmortems name the shed tier without a second capture path."""
        self._recorder = recorder

    # ------------------------------------------------------------ append
    def record_event(self, kind: str, pool: str, owner: str, nbytes: int,
                     reason: Optional[str] = None, **attrs) -> None:
        """Append one typed event, O(1) under a short lock.

        MUST be called with no locks held (lock-discipline rule
        ``ledger-append-under-lock``): shed events fan out to the metrics
        registry and the flight recorder beyond the ledger's own lock.
        """
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown memory-ledger event kind: {kind!r}")
        nbytes = int(nbytes)
        rec = {"ts": time.time(), "kind": kind, "pool": pool,
               "owner": owner, "bytes": nbytes}
        if reason is not None:
            rec["reason"] = reason
        rec.update(attrs)
        key = (pool, owner)
        with self._lock:
            self._ring.append(rec)
            self._events[key] = self._events.get(key, 0) + 1
            self._updated[key] = rec["ts"]
            if kind in _GROW_KINDS:
                live = self._live.get(key, 0) + nbytes
                self._live[key] = live
                if live > self._peak.get(key, 0):
                    self._peak[key] = live
            elif kind in _SHRINK_KINDS:
                self._live[key] = max(0, self._live.get(key, 0) - nbytes)
        # fan-out OUTSIDE the ledger lock: metrics + recorder take their
        # own locks, and no append may run under any held lock
        if kind == "shed":
            try:
                from trino_tpu_torch.obs import metrics as M

                M.MEMORY_PRESSURE_EVENTS.inc(1, reason or "shed")
            except Exception:  # noqa: BLE001 — accounting never fails work
                pass
            if self._recorder is not None:
                self._recorder.record(
                    "memory", "memory/shed", pool=pool, owner=owner,
                    bytes=nbytes, reason=reason or "shed")

    # --------------------------------------------------------- live sync
    def set_live(self, pool: str, owner: str, nbytes: int) -> None:
        """Set an owner's live bytes from a ground-truth source (announce
        loop / executor registration), keeping the peak monotone."""
        key = (pool, owner)
        nbytes = max(0, int(nbytes))
        with self._lock:
            self._live[key] = nbytes
            if nbytes > self._peak.get(key, 0):
                self._peak[key] = nbytes
            self._updated[key] = time.time()

    def sync_pool(self, pool: str, owners: Dict[str, int],
                  prefix: Optional[str] = None) -> None:
        """Replace live bytes for ``pool`` from a ground-truth snapshot:
        every owner in ``owners`` gets its value; existing owners matching
        ``prefix`` but absent from the snapshot drop to 0 (a finished
        query stops holding bytes but keeps its peak/event history)."""
        now = time.time()
        with self._lock:
            if prefix is not None:
                for key in list(self._live):
                    if (key[0] == pool and key[1].startswith(prefix)
                            and key[1] not in owners):
                        self._live[key] = 0
            for owner, nbytes in owners.items():
                key = (pool, owner)
                nbytes = max(0, int(nbytes))
                self._live[key] = nbytes
                if nbytes > self._peak.get(key, 0):
                    self._peak[key] = nbytes
                self._updated[key] = now

    def sample_watermarks(self, pools: Dict[str, int],
                          rss_bytes: Optional[int] = None,
                          device_total_bytes: Optional[int] = None) -> None:
        """One announce-loop tick: record per-pool totals (+RSS, +device
        capacity) into the time-series ring and the synthetic ``total``
        owner rows, keeping per-pool peaks for bench/queryStats."""
        now = time.time()
        sample = {"ts": now}
        with self._lock:
            for pool, nbytes in pools.items():
                nbytes = max(0, int(nbytes))
                sample[pool] = nbytes
                key = (pool, TOTAL_OWNER)
                self._live[key] = nbytes
                if nbytes > self._peak.get(key, 0):
                    self._peak[key] = nbytes
                self._updated[key] = now
                if nbytes > self._pool_peak.get(pool, 0):
                    self._pool_peak[pool] = nbytes
            if rss_bytes is not None:
                sample["rssBytes"] = int(rss_bytes)
            if device_total_bytes is not None:
                sample["deviceTotalBytes"] = int(device_total_bytes)
            self._watermarks.append(sample)

    # ------------------------------------------------------------- reads
    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """Oldest-first copy of the event ring."""
        with self._lock:
            records = list(self._ring)
        if limit is not None and len(records) > limit:
            records = records[-limit:]
        return records

    def watermarks(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            samples = list(self._watermarks)
        if limit is not None and len(samples) > limit:
            samples = samples[-limit:]
        return samples

    def owner_rows(self) -> List[dict]:
        """Per-(pool, owner) live/peak/event rows — the
        ``system.runtime.memory`` source. Owners with no live bytes AND no
        peak are skipped (sync churn), the synthetic ``total`` rows ride
        along so attribution is computable from the table alone."""
        with self._lock:
            keys = set(self._live) | set(self._peak) | set(self._events)
            rows = []
            for pool, owner in sorted(keys):
                key = (pool, owner)
                live = self._live.get(key, 0)
                peak = self._peak.get(key, 0)
                if live <= 0 and peak <= 0:
                    continue
                rows.append({
                    "pool": pool, "owner": owner, "bytes": live,
                    "peakBytes": peak,
                    "events": self._events.get(key, 0),
                    "updatedAt": self._updated.get(key, 0.0),
                })
        return rows

    def pool_peaks(self) -> Dict[str, int]:
        """Peak sampled total per pool (bench + queryStats.memory)."""
        with self._lock:
            return dict(self._pool_peak)

    def memory_snapshot(self, top: int = 3) -> dict:
        """The postmortem block: pool watermarks, the top ``top``
        named consumers per pool by peak bytes, and the newest shed
        events (which name the shed tier + reclaiming reason)."""
        rows = self.owner_rows()
        pools: Dict[str, dict] = {}
        consumers: List[dict] = []
        for row in rows:
            if row["owner"] == TOTAL_OWNER:
                pools[row["pool"]] = {"bytes": row["bytes"],
                                      "peakBytes": row["peakBytes"]}
            else:
                consumers.append(row)
        consumers.sort(key=lambda r: (r["peakBytes"], r["bytes"]),
                       reverse=True)
        by_pool: Dict[str, List[dict]] = {}
        for row in consumers:
            bucket = by_pool.setdefault(row["pool"], [])
            if len(bucket) < top:
                bucket.append(row)
        sheds = [r for r in self.snapshot() if r["kind"] == "shed"][-8:]
        return {"nodeId": self.node_id, "pools": pools,
                "topConsumers": by_pool, "sheds": sheds}

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# the per-process ledger (coordinator AND every worker — same pattern as
# the per-process metrics registry); servers stamp node_id at startup
MEMORY_LEDGER = MemoryLedger()
