"""Coordinator result cache + logical-plan cache (the port of
trino_tpu/cache/result_cache.py).

Reference role: the result/plan caches fronting systems put before Trino
(and the reference's own ``CachingTableStatsProvider`` /
``NonEvictableCache`` idioms for plan-time metadata). Two stores:

- ``ResultCache`` — final result pages (column names + Python rows) in a
  byte-budgeted LRU with per-entry TTL and SINGLE-FLIGHT de-duplication:
  the first query on a key executes (the leader), concurrent identical
  queries park on the flight and are served the leader's result as HITs —
  one execution, N answers (the role of request coalescing in any serving
  cache; reference analog: QueuedStatementResource de-duplicates nothing,
  which is exactly the tax this removes).
- ``PlanCache`` — optimized logical plans keyed by canonical SQL +
  session-property signature, validated against connector data versions
  at lookup (a stale plan may bake dropped tables or dead statistics).

Admission: entries above ``max_bytes / 4`` are never admitted (one giant
result must not wipe the working set); DML/DDL and uncachable plans never
reach ``begin`` at all (coordinator bypasses first).

Both stores are process-wide and thread-safe: every query thread on the
coordinator races through them.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import List, Optional

from trino_tpu_torch.devcache.flight import _Flight
from trino_tpu_torch.obs import metrics as M

DEFAULT_RESULT_CACHE_BYTES = 64 << 20


def estimate_result_bytes(columns: List[str], rows: List[tuple]) -> int:
    """Cheap size estimate of a materialized result (sampled: results can
    be millions of rows and admission must not cost a full scan)."""
    base = 256 + sum(len(c) + 49 for c in columns)
    n = len(rows)
    if n == 0:
        return base
    sample = rows[:: max(1, n // 200)][:200]
    per_row = sum(
        64 + sum(_value_bytes(v) for v in row) for row in sample
    ) / len(sample)
    return base + int(per_row * n)


def _value_bytes(v) -> int:
    if v is None:
        return 16
    if isinstance(v, bool):
        return 24
    if isinstance(v, int):
        return 28
    if isinstance(v, float):
        return 24
    if isinstance(v, (str, bytes)):
        return 49 + len(v)
    return 64  # dates, decimals, nested values


def session_user(session) -> str:
    """The session's authenticated principal (cache-key partition: plan
    and result reuse across users would bypass per-table access control,
    which is enforced at plan time)."""
    return getattr(getattr(session, "identity", None), "user", "") or ""


def _current_group() -> Optional[str]:
    """Resource group of the query on this thread (the dispatcher's lane
    sets it around execution), or None outside a lane."""
    from trino_tpu_torch.server.resource_groups import current_group

    return current_group()


class ResultCache:
    """Byte-budgeted LRU of final result pages with TTL + single-flight."""

    def __init__(self, max_bytes: int = DEFAULT_RESULT_CACHE_BYTES):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        # key -> (columns, rows, bytes, expires_at monotonic, group)
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._bytes = 0
        self._flights: dict = {}
        # resident bytes per resource group (None = ungrouped) — the
        # carve-out ground truth for over-share eviction preference
        self._group_bytes: dict = {}

    # ------------------------------------------------------------ inspection
    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def group_bytes(self) -> dict:
        """Resident bytes per owning resource group (None = ungrouped)."""
        with self._lock:
            return dict(self._group_bytes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _group_sub_locked(self, group, nbytes: int) -> None:
        remaining = self._group_bytes.get(group, 0) - nbytes
        if remaining > 0:
            self._group_bytes[group] = remaining
        else:
            self._group_bytes.pop(group, None)

    def _victim_key_locked(self, exclude=None):
        """Eviction victim: the oldest entry of a group over its
        configured cache share first (one tenant's burst reclaims its own
        over-share bytes before touching another's warm results), else
        the LRU head."""
        from trino_tpu_torch.server.resource_groups import CACHE_SHARES

        for k, ent in self._entries.items():  # LRU order
            if k == exclude:
                continue
            group = ent[4]
            if CACHE_SHARES.over_share(group, self._group_bytes.get(group, 0),
                                       self.max_bytes):
                return k
        return next(iter(self._entries))

    # ------------------------------------------------------------- lifecycle
    def begin(self, key: str):
        """One atomic admission step. Returns
        ``("hit", (columns, rows))`` — a live entry was found;
        ``("wait", flight)``        — another query is computing this key;
        ``("lead", None)``          — caller must execute, then call
        ``complete`` (success) or ``abandon`` (failure)."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                columns, rows, nbytes, expires_at, group = ent
                if time.monotonic() < expires_at:
                    self._entries.move_to_end(key)
                    return "hit", (columns, rows)
                del self._entries[key]
                self._bytes -= nbytes
                self._group_sub_locked(group, nbytes)
                M.RESULT_CACHE_BYTES.set(self._bytes)
            flight = self._flights.get(key)
            if flight is not None:
                return "wait", flight
            self._flights[key] = _Flight()
            return "lead", None

    def complete(self, key: str, columns: List[str], rows: List[tuple],
                 ttl_ms: int, max_bytes: Optional[int] = None) -> None:
        """Leader publishes its result: waiters wake with the value, and
        the entry is admitted (budget and per-entry cap permitting).
        ``max_bytes`` is the session's admission budget for THIS entry —
        it tightens the per-entry cap but never resizes the shared
        server-wide cache (one tenant must not flush the others)."""
        value = (columns, rows)
        nbytes = estimate_result_bytes(columns, rows)
        group = _current_group()
        with self._lock:
            flight = self._flights.pop(key, None)
            budget = (self.max_bytes if max_bytes is None
                      else min(self.max_bytes, max_bytes))
            if nbytes <= budget // 4:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._bytes -= old[2]
                    self._group_sub_locked(old[4], old[2])
                self._entries[key] = (
                    columns, rows, nbytes,
                    time.monotonic() + ttl_ms / 1e3, group)
                self._bytes += nbytes
                self._group_bytes[group] = (
                    self._group_bytes.get(group, 0) + nbytes)
                while self._bytes > self.max_bytes and len(self._entries) > 1:
                    vk = self._victim_key_locked(exclude=key)
                    _c, _r, b, _e, g = self._entries.pop(vk)
                    self._bytes -= b
                    self._group_sub_locked(g, b)
                    M.RESULT_CACHE_EVICTIONS.inc()
                M.RESULT_CACHE_BYTES.set(self._bytes)
        if flight is not None:
            flight._resolve(value, ok=True)

    def peek(self, key: str):
        """Read-only lookup: ``(columns, rows)`` of a live entry, else None.
        Never starts a flight: the dispatcher's serving index
        (server/dispatch.py) consults it on the HTTP thread, where leading a
        flight (and later having to abandon it) would be wrong."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            columns, rows, nbytes, expires_at, group = ent
            if time.monotonic() >= expires_at:
                del self._entries[key]
                self._bytes -= nbytes
                self._group_sub_locked(group, nbytes)
                M.RESULT_CACHE_BYTES.set(self._bytes)
                return None
            self._entries.move_to_end(key)
            return columns, rows

    def abandon(self, key: str) -> None:
        """Leader failed: wake waiters empty-handed (they re-execute)."""
        with self._lock:
            flight = self._flights.pop(key, None)
        if flight is not None:
            flight._resolve(None, ok=False)

    def invalidate_all(self) -> None:
        with self._lock:
            self._entries.clear()
            self._group_bytes.clear()
            self._bytes = 0
            M.RESULT_CACHE_BYTES.set(0)


class PlanCache:
    """Optimized-plan LRU keyed by canonical SQL + session-property
    signature, revalidated against connector data versions per lookup."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        # key -> (root, [((catalog, schema, table), version), ...] | None)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()

    @staticmethod
    def key_for(session, sql: str) -> tuple:
        props = tuple(sorted(
            (k, str(v)) for k, v in session.properties.items()))
        # SQL routines inline at plan time (sql/routines.py expand_udfs):
        # a CREATE OR REPLACE FUNCTION must not resurrect a plan holding
        # the old body, so the routine store participates in the key
        udfs = getattr(session, "udfs", None) or {}
        udf_sig = tuple(sorted((name, repr(d)) for name, d in udfs.items()))
        # access control fires inside Planner.plan (check_can_select):
        # reusing another principal's plan would skip it, so the cache is
        # partitioned per user (reference: per-identity cache keying)
        return (sql.strip(), session_user(session), props, udf_sig)

    def get(self, session, sql: str):
        """``(root, current_versions)`` for a still-valid entry, or None.
        A version mismatch (or an unversioned scanned table) invalidates
        the entry in place. The freshly captured versions are returned so
        the caller's result-cache lookup doesn't re-stat every table."""
        from trino_tpu_torch.cache.plan_key import capture_versions

        key = self.key_for(session, sql)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            self._entries.move_to_end(key)
        root, versions = ent
        current = capture_versions(session, root)
        if current != versions:
            with self._lock:
                self._entries.pop(key, None)
            return None
        return root, current

    def put(self, session, sql: str, root, versions=None) -> None:
        """``versions``: the capture the caller already did at plan time
        (avoids a duplicate per-table data_version pass); computed here
        when omitted."""
        from trino_tpu_torch.cache.plan_key import capture_versions

        if versions is None:
            versions = capture_versions(session, root)
        if versions is None:
            return  # unversioned tables can't be revalidated: never cache
        key = self.key_for(session, sql)
        with self._lock:
            self._entries[key] = (root, versions)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def invalidate_all(self) -> None:
        with self._lock:
            self._entries.clear()


class QueryCache:
    """The coordinator's cache facade: one logical-plan cache + one result
    cache, shared by every query the server runs."""

    def __init__(self, result_max_bytes: int = DEFAULT_RESULT_CACHE_BYTES,
                 plan_max_entries: int = 256):
        self.plans = PlanCache(plan_max_entries)
        self.results = ResultCache(result_max_bytes)
