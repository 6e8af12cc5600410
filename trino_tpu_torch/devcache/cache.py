"""Warm device table cache: the port of trino_tpu/devcache/cache.py.

The unit of caching is a fully staged device artifact (an assembled scan
``Page`` or a join's ``SortedBuild``), so a warm query skips the whole
host pipeline: connector scan, dynamic-domain pruning, dictionary merge
and the host->device copy.

Correctness comes from the connector's ``data_version()`` token, which
rides inside every key: INSERT/UPDATE/DELETE/DROP/CTAS move the version,
so a stale entry can never be served again (a lookup also drops the
same-table entries whose version moved). Unversioned connectors bypass
the cache.

The key also carries the torch device: the pool is process-wide, and a
CPU session and a CUDA session must never share an entry.

Memory discipline: a byte-budgeted LRU (a quarter of the card's memory,
256 MiB for the CPU), single-flight admission (concurrent stagings of one
key run one loader), and ``yield_bytes``, which a query about to spill
calls to reclaim cache bytes first (exec/memory.py). Cached tensors are
shared by every later query and must never be written in place.

Not ported: the resource-group carve-outs and the memory-ledger events
(their server modules are not ported).
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from trino_tpu_torch.devcache.flight import _Flight
from trino_tpu_torch.obs import metrics as M

# budget when no CUDA device is present (CPU sessions)
DEFAULT_DEVICE_CACHE_BYTES = 256 << 20
# the cache may hold this fraction of the card's memory; running queries
# own the rest (and the cache yields even its share under pressure)
DEVICE_MEMORY_FRACTION = 4

_device_memory_cell: List = []  # computed once per process


def device_memory_bytes() -> Optional[int]:
    """The card's total memory in bytes, or None without a CUDA device."""
    if not _device_memory_cell:
        import torch

        _device_memory_cell.append(
            int(torch.cuda.mem_get_info(torch.cuda.current_device())[1])
            if torch.cuda.is_available() else None)
    return _device_memory_cell[0]


def _default_budget() -> int:
    cap = device_memory_bytes()
    if cap:
        return max(cap // DEVICE_MEMORY_FRACTION, 64 << 20)
    return DEFAULT_DEVICE_CACHE_BYTES


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """Identity of one staged artifact. ``signature`` digests the
    projection, pushdown handle, effective constraint and host-applied
    dynamic domains (devcache/keys.py); ``shard`` distinguishes artifact
    shapes of one table (the whole-table page, a sorted build, a host
    split); ``conn_token`` keeps process-local connectors apart;
    ``device`` is the torch device the artifact lives on ("host" for the
    host tier)."""

    catalog: str
    schema: str
    table: str
    data_version: str
    signature: str
    shard: str
    conn_token: int = 0
    device: str = ""

    def table_id(self) -> Tuple[str, str, str, int, str]:
        return (self.catalog, self.schema, self.table, self.conn_token, self.device)


@dataclasses.dataclass
class CacheEntry:
    """One resident entry: ``value`` is the staged artifact, ``rows`` the
    rows it holds, ``nbytes`` its exact bytes."""

    key: Optional[CacheKey]
    value: object
    rows: int
    nbytes: int
    splits: int = 0
    hits: int = 0
    created_at: float = 0.0
    last_used_at: float = 0.0


class DeviceTableCache:
    """Byte-budgeted LRU of staged tables with single-flight admission and
    version-based invalidation. The metric hooks are class attributes so
    the host tier (devcache/hostcache.py) reuses the whole machinery under
    its own counters."""

    # followers give a slow leader this long before staging themselves
    FLIGHT_WAIT_S = 600.0

    M_HITS = M.DEVICE_CACHE_HITS
    M_MISSES = M.DEVICE_CACHE_MISSES
    M_EVICTIONS = M.DEVICE_CACHE_EVICTIONS
    M_BYTES = M.DEVICE_CACHE_BYTES

    def __init__(self, max_bytes: Optional[int] = None):
        self._max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: "OrderedDict[CacheKey, CacheEntry]" = OrderedDict()
        self._bytes = 0
        self._flights: Dict[CacheKey, _Flight] = {}
        # table_id -> resident keys: the stale-version sweep of a lookup
        # stays O(entries of this table)
        self._by_table: Dict[tuple, set] = {}
        self._hit_count = 0

    def _default_max_bytes(self) -> int:
        """Budget when the constructor did not pin one (subclass hook)."""
        return _default_budget()

    # ---------------------------------------------------------- inspection
    @property
    def max_bytes(self) -> int:
        if self._max_bytes is None:
            self._max_bytes = self._default_max_bytes()
        return self._max_bytes

    def hit_count(self) -> int:
        with self._lock:
            return self._hit_count

    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self) -> List[CacheEntry]:
        """Resident entries, MRU first."""
        with self._lock:
            return list(reversed(self._entries.values()))

    def snapshot(self) -> List[dict]:
        """Row-shaped entry list, MRU first."""
        return [
            {
                "catalog": e.key.catalog,
                "schema": e.key.schema,
                "table": e.key.table,
                "version": e.key.data_version,
                "shard": e.key.shard,
                "signature": e.key.signature,
                "device": e.key.device,
                "bytes": e.nbytes,
                "rows": e.rows,
                "hits": e.hits,
                "createdAt": e.created_at,
                "lastUsedAt": e.last_used_at,
            }
            for e in self.entries()
        ]

    # ----------------------------------------------------------- lifecycle
    def lookup_or_stage(
        self, key: CacheKey, loader: Callable[[], Tuple[object, int, int, int]],
        admit_bytes: Optional[int] = None, wait: bool = True,
    ) -> Tuple[Optional[CacheEntry], str]:
        """``(entry, "hit"|"miss")``. ``loader() -> (value, rows, nbytes,
        splits)`` runs outside the cache lock; concurrent callers of one
        key single-flight: one loader runs, followers are served its entry
        as hits. A failed leader wakes followers empty-handed and they
        race again.

        ``wait=False``: when another caller is already staging this key,
        return ``(None, "inflight")`` at once instead of parking as a
        follower, so a shared pool thread is never pinned behind another
        staging's flight (exec/staging.py); the caller resolves in-flight
        keys on its own thread afterwards."""
        while True:
            inflight = False
            with self._lock:
                self._drop_stale_locked(key)
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    ent.hits += 1
                    ent.last_used_at = time.time()
                    self._hit_count += 1
                    self.M_HITS.inc()
                else:
                    flight = self._flights.get(key)
                    if flight is None:
                        flight = self._flights[key] = _Flight()
                        lead = True
                    else:
                        if not wait:
                            inflight = True
                        lead = False
            if ent is not None:
                return ent, "hit"
            if inflight:
                return None, "inflight"
            if not lead:
                if not flight.wait(self.FLIGHT_WAIT_S):
                    # the leader is alive but stuck (e.g. blocked in a
                    # connector read): stage privately rather than hang
                    # every query of the table behind it
                    value, rows, nbytes, splits = loader()
                    now = time.time()
                    self.M_MISSES.inc()
                    return CacheEntry(key, value, rows, int(nbytes), splits,
                                      created_at=now, last_used_at=now), "miss"
                if flight.ok and flight.value is not None:
                    ent = flight.value
                    with self._lock:
                        ent.hits += 1
                        ent.last_used_at = time.time()
                        self._hit_count += 1
                    self.M_HITS.inc()
                    return ent, "hit"
                continue  # the leader failed: race for leadership
            try:
                value, rows, nbytes, splits = loader()
            except BaseException:
                with self._lock:
                    flight = self._flights.pop(key, None)
                if flight is not None:
                    flight._resolve(None, ok=False)
                raise
            now = time.time()
            ent = CacheEntry(key, value, rows, int(nbytes), splits,
                             created_at=now, last_used_at=now)
            self._admit(ent, admit_bytes)
            with self._lock:
                flight = self._flights.pop(key, None)
            if flight is not None:
                flight._resolve(ent, ok=True)
            self.M_MISSES.inc()
            return ent, "miss"

    def peek(self, key: CacheKey) -> Optional[CacheEntry]:
        """The resident entry for ``key`` (counted and LRU-bumped as a
        hit), or None, without staging and without joining a flight."""
        with self._lock:
            self._drop_stale_locked(key)
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
                ent.hits += 1
                ent.last_used_at = time.time()
                self._hit_count += 1
        if ent is None:
            return None
        self.M_HITS.inc()
        return ent

    def _admit(self, ent: CacheEntry, admit_bytes: Optional[int]) -> None:
        """Admit under the budget. ``admit_bytes`` (the session's cap) is a
        per-entry size filter only: an entry over it is returned to the
        caller but not retained; eviction always targets the shared
        budget."""
        cap = (self.max_bytes if admit_bytes is None
               else min(self.max_bytes, int(admit_bytes)))
        if ent.nbytes > cap:
            return
        with self._lock:
            self._remove_locked(ent.key)
            while self._bytes + ent.nbytes > self.max_bytes and self._entries:
                self._evict_lru_locked()
            self._entries[ent.key] = ent
            self._bytes += ent.nbytes
            self._by_table.setdefault(ent.key.table_id(), set()).add(ent.key)
            self.M_BYTES.set(self._bytes)

    def _remove_locked(self, key: CacheKey) -> Optional[CacheEntry]:
        ent = self._entries.pop(key, None)
        if ent is None:
            return None
        self._bytes -= ent.nbytes
        keys = self._by_table.get(key.table_id())
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_table[key.table_id()]
        return ent

    def _evict_lru_locked(self) -> int:
        victim = self._remove_locked(next(iter(self._entries)))
        self.M_EVICTIONS.inc()
        self.M_BYTES.set(self._bytes)
        return victim.nbytes

    def _drop_stale_locked(self, key: CacheKey) -> int:
        """Drop every entry of the same table whose data_version differs
        from the one the caller just observed: a mutation moved it, so
        those artifacts can never be served again. Returns bytes freed."""
        keys = self._by_table.get(key.table_id())
        if not keys:
            return 0
        freed = 0
        for k in [k for k in keys if k.data_version != key.data_version]:
            victim = self._remove_locked(k)
            if victim is not None:
                freed += victim.nbytes
            self.M_EVICTIONS.inc()
        if freed:
            self.M_BYTES.set(self._bytes)
        return freed

    # ------------------------------------------------------------ pressure
    def yield_bytes(self, nbytes: int) -> int:
        """Shed at least ``nbytes`` of cached artifacts (LRU first) for a
        running query's benefit; returns the bytes freed. Never blocks on
        staging flights."""
        if nbytes <= 0:
            return 0
        freed = 0
        with self._lock:
            while freed < nbytes and self._entries:
                freed += self._evict_lru_locked()
        return freed

    def invalidate_all(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_table.clear()
            self._bytes = 0
            self.M_BYTES.set(0)


# the process-wide pool: every session of this process shares one budget
DEVICE_CACHE = DeviceTableCache()


# --------------------------------------------------- connector identity
# process-local connectors (``coordinator_only``: the memory connector,
# whose version counter is instance state) get a per-instance token so two
# sessions' private catalogs never alias; ids are never reused, and a
# collected connector's entries age out by LRU
_conn_tokens: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_conn_token_lock = threading.Lock()
_conn_token_next = [1]


def instance_token(conn) -> int:
    """0 for connectors whose data_version is globally meaningful (the
    immutable generators); a unique per-instance token for process-local
    ones."""
    if not getattr(conn, "coordinator_only", False):
        return 0
    with _conn_token_lock:
        tok = _conn_tokens.get(conn)
        if tok is None:
            tok = _conn_tokens[conn] = _conn_token_next[0]
            _conn_token_next[0] += 1
        return tok
