"""Cluster memory management: pool aggregation + the low-memory killer (a
copy of trino_tpu/server/cluster_memory.py).

Reference: ``memory/ClusterMemoryManager.java:89`` (aggregates every node's
pool usage from node status, enforces query.max-memory cluster-wide, and
invokes a pluggable LowMemoryKiller when nodes run out) with
``TotalReservationOnBlockedNodesQueryLowMemoryKiller`` as the default
policy. Here the node status ride-along is the worker announce payload
(queryMemory / memoryBytes / memoryLimit, server/worker.py), and the killer
fires when any worker reports usage over its declared pool.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

# policy: {query_id: total_reserved_bytes_across_cluster} -> victim query id
KillerPolicy = Callable[[Dict[str, int]], Optional[str]]


def total_reservation_killer(query_mem: Dict[str, int]) -> Optional[str]:
    """Default policy: kill the query holding the most cluster memory
    (reference: TotalReservationLowMemoryKiller)."""
    if not query_mem:
        return None
    return max(query_mem.items(), key=lambda kv: kv[1])[0]


class ClusterMemoryManager:
    """Aggregates per-worker announce payloads; blocks dispatch over the
    cluster limit; kills the policy's victim when a worker is over its
    pool."""

    # worker announce cadence (server/worker.py announce loop)
    HEARTBEAT_INTERVAL_S = 0.5
    # announces older than this many missed heartbeats are STALE: a dead
    # worker's cache bytes must not keep counting as reclaimable headroom
    STALE_HEARTBEATS = 3

    def __init__(self, kill, cluster_limit_bytes: Optional[int] = None,
                 policy: KillerPolicy = total_reservation_killer,
                 heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S):
        # kill(query_id, reason) — provided by the coordinator
        self._kill = kill
        self.cluster_limit_bytes = cluster_limit_bytes
        self.policy = policy
        self.heartbeat_interval_s = heartbeat_interval_s
        self._lock = threading.Lock()
        # node_id -> {"queryMemory": {...}, "memoryBytes": n, "memoryLimit": n|None}
        self._nodes: Dict[str, dict] = {}
        self.kills: list = []  # (query_id, reason) history for tests/UI

    # ------------------------------------------------------------- ingest
    def update(self, node_id: str, payload: dict) -> None:
        with self._lock:
            self._nodes[node_id] = {
                "queryMemory": dict(payload.get("queryMemory") or {}),
                "memoryBytes": int(payload.get("memoryBytes") or 0),
                "memoryLimit": payload.get("memoryLimit"),
                # real accelerator capacity (HBM bytes) when the worker
                # could discover it — sizes admission from hardware
                # instead of a flat default (devcache/)
                "deviceMemoryBytes": payload.get("deviceMemoryBytes"),
                # warm-table bytes the worker holds in its device cache:
                # REVOCABLE (the worker sheds them under pressure), so
                # admission never counts them against headroom
                "deviceCacheBytes": int(payload.get("deviceCacheBytes") or 0),
                # host-RAM columnar tier (devcache/hostcache.py): the
                # SECOND revocable tier — the worker sheds it before the
                # HBM tier (devcache.shed_revocable), and admission
                # ignores it for the same reason
                "hostCacheBytes": int(payload.get("hostCacheBytes") or 0),
                # per-pool, per-owner memory-ledger rows + process RSS
                # (the system.runtime.memory per-node source)
                "memoryOwners": list(payload.get("memoryOwners") or ()),
                "rssBytes": payload.get("rssBytes"),
                "at": time.monotonic(),
            }
        self._maybe_kill()

    # ----------------------------------------------------------- accessors
    def query_reservations(self) -> Dict[str, int]:
        """Cluster-wide reserved bytes per query."""
        with self._lock:
            out: Dict[str, int] = {}
            for info in self._nodes.values():
                for qid, b in info["queryMemory"].items():
                    out[qid] = out.get(qid, 0) + int(b)
            return out

    def cluster_reserved(self) -> int:
        with self._lock:
            return sum(i["memoryBytes"] for i in self._nodes.values())

    def device_capacity_total(self) -> Optional[int]:
        """Sum of worker-announced accelerator capacities (HBM bytes), or
        None unless EVERY tracked worker announced one — a partial sum
        would understate the cluster and spuriously refuse admission on
        mixed fleets (some workers cannot discover their capacity)."""
        with self._lock:
            caps = [i.get("deviceMemoryBytes") for i in self._nodes.values()]
        if not caps or any(not c for c in caps):
            return None
        return sum(int(c) for c in caps)

    def revocable_bytes(self) -> int:
        """Cluster-wide revocable bytes across BOTH cache tiers —
        reclaimable on demand (workers shed host-RAM pages first, then
        warm-HBM tables, for running queries' benefit). STALE announces
        (older than STALE_HEARTBEATS missed heartbeats) are skipped: a
        dead worker's cache cannot actually be reclaimed, so its bytes
        must not be promised as headroom."""
        horizon = self.STALE_HEARTBEATS * self.heartbeat_interval_s
        now = time.monotonic()
        with self._lock:
            return sum(int(i.get("deviceCacheBytes") or 0)
                       + int(i.get("hostCacheBytes") or 0)
                       for i in self._nodes.values()
                       if now - i["at"] <= horizon)

    def memory_rows(self) -> list:
        """(node_id, owner-row) pairs from the newest announce of every
        tracked node — the coordinator's system.runtime.memory feed (its
        own process ledger supplies the coordinator rows)."""
        with self._lock:
            return [(nid, dict(row))
                    for nid, info in sorted(self._nodes.items())
                    for row in info.get("memoryOwners") or ()]

    def effective_limit(self) -> Optional[int]:
        """The admission ceiling: the configured cluster limit when set,
        else the REAL announced hardware capacity (reference role:
        query.max-memory sized by ops guesswork, replaced by the workers'
        own HBM reports); None = unlimited (nothing known)."""
        if self.cluster_limit_bytes is not None:
            return self.cluster_limit_bytes
        return self.device_capacity_total()

    def has_headroom(self) -> bool:
        """Dispatch gate: admit new work only under the effective limit
        (reference: ClusterMemoryManager's query.max-memory admission).
        Device-cache bytes never count against headroom — they are the
        revocable tier and yield before a query would be refused. When the
        limit is hardware-derived, each node's counted reservation is
        CLAMPED at that node's announced capacity: reservations are
        projected peaks (a spilling join reports its pre-partition
        projection, exec/memory.py), and a single projection beyond one
        node's HBM must not consume the whole cluster's headroom. Blocked
        dispatch queues (coordinator waits for headroom); reservations
        decay when task bodies finish."""
        limit = self.effective_limit()
        if limit is None:
            return True
        if self.cluster_limit_bytes is not None:
            # the operator chose this ceiling deliberately: gate on raw
            # reservations exactly as configured
            return self.cluster_reserved() < limit
        with self._lock:
            reserved = sum(
                min(int(i["memoryBytes"]),
                    int(i.get("deviceMemoryBytes") or 0) or i["memoryBytes"])
                for i in self._nodes.values())
        return reserved < limit

    # -------------------------------------------------------------- killer
    def _maybe_kill(self) -> None:
        over = []
        with self._lock:
            for nid, info in self._nodes.items():
                limit = info["memoryLimit"]
                if limit is not None and info["memoryBytes"] > int(limit):
                    over.append(nid)
        if not over:
            return
        # candidates = queries actually HOLDING memory on an over-limit
        # node (killing anything else frees nothing there — the
        # "OnBlockedNodes" half of the reference policy's name); the
        # policy then ranks candidates by their CLUSTER-wide reservation
        with self._lock:
            blocked = set()
            for nid in over:
                blocked.update(
                    q for q, b in self._nodes[nid]["queryMemory"].items()
                    if int(b) > 0)
        candidates = {
            q: b for q, b in self.query_reservations().items() if q in blocked
        }
        victim = self.policy(candidates)
        if victim is None:
            return
        reason = (
            f"Query exceeded distributed memory limit: worker(s) "
            f"{','.join(sorted(over))} over their memory pool; killed as the "
            f"largest reservation (EXCEEDED_CLUSTER_MEMORY)")
        self.kills.append((victim, reason))
        # forget the victim's reservations immediately so one announce
        # cannot kill two queries for the same pressure window
        with self._lock:
            for info in self._nodes.values():
                info["queryMemory"].pop(victim, None)
                info["memoryBytes"] = sum(info["queryMemory"].values())
        self._kill(victim, reason)
