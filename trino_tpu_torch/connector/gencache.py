"""Scan-range generation cache for the stateless table generators.

Reference role: the buffer-pool / page-cache layer under a scan (the
reference reads ORC/Parquet through OS page cache + connector caches, so
re-scanning a table costs IO once). Our generators ARE the storage tier;
without a cache every scan of the same table re-synthesizes it — Q18 reads
lineitem twice (HAVING subquery + main join), TPC-DS q95 reads web_sales
three times. Entries key on (table, sf, lo, hi) and accumulate columns on
demand; the cache holds a byte-budgeted LRU — least-recently-scanned
ranges evict individually when the budget is exceeded (generation is
always correct, the cache is purely a cost optimization). Hit/miss/
eviction counters land in the typed metrics registry
(``trino_tpu_gencache_*``, obs/metrics.py).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict

import numpy as np

MAX_CACHE_BYTES = 4 << 30
MAX_ENTRY_BYTES = 2 << 30


class GenCache:
    def __init__(self, generate_fn: Callable,
                 max_bytes: int = MAX_CACHE_BYTES,
                 max_entry_bytes: int = MAX_ENTRY_BYTES):
        self._generate = generate_fn
        self.max_bytes = max_bytes
        self.max_entry_bytes = max_entry_bytes
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self._entry_bytes: Dict[tuple, int] = {}
        self._bytes = 0
        # workers scan concurrently; generation runs OUTSIDE the lock (it
        # can take seconds at scale), only map surgery is serialized
        self._lock = threading.Lock()

    @staticmethod
    def _cd_bytes(cd) -> int:
        total = 0
        for a in (cd.values, cd.nulls):
            arr = np.asarray(a) if a is not None else None
            if arr is not None and arr.ndim:
                total += arr.nbytes
        return total

    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def clear(self) -> None:
        """Drop every cached range (benchmark isolation: a cold-staging
        arm must not be served a previous arm's generated columns)."""
        with self._lock:
            self._entries.clear()
            self._entry_bytes.clear()
            self._bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _evict_over_budget(self, keep: tuple) -> None:
        """LRU eviction down to the byte budget, never evicting ``keep``
        (its already-cached columns are part of the result being built).
        Caller holds the lock."""
        from trino_tpu_torch.obs import metrics as M

        while self._bytes > self.max_bytes and len(self._entries) > 1:
            key = next(iter(self._entries))
            if key == keep:
                # keep is oldest: rotate it to MRU and evict the next-oldest
                self._entries.move_to_end(key)
                key = next(iter(self._entries))
                if key == keep:
                    break
            self._entries.pop(key)
            self._bytes -= self._entry_bytes.pop(key, 0)
            M.GENCACHE_EVICTIONS.inc()

    def generate(self, table: str, sf: float, lo: int, hi: int, columns):
        from trino_tpu_torch.obs import metrics as M

        need = set(columns)
        key = (table, float(sf), int(lo), int(hi))
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                self._entries.move_to_end(key)
            missing = need - set(ent or ())
            if ent is not None and not missing:
                M.GENCACHE_HITS.inc()
                return {c: ent[c] for c in columns}
            # snapshot the columns already present: generation happens
            # outside the lock and a concurrent eviction must not lose them
            have = dict(ent or {})
        M.GENCACHE_MISSES.inc()
        fresh = self._generate(table, sf, lo, hi,
                               need if not have else missing)
        size = sum(self._cd_bytes(cd) for cd in fresh.values())
        if size > self.max_entry_bytes:
            # a range bigger than the per-entry cap is served uncached
            out = dict(have)
            out.update(fresh)
            return {c: out[c] for c in columns}
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = dict(have)
                self._entries[key] = ent
                self._entry_bytes[key] = sum(
                    self._cd_bytes(cd) for cd in ent.values())
                self._bytes += self._entry_bytes[key]
            added = {c: cd for c, cd in fresh.items() if c not in ent}
            ent.update(added)
            grow = sum(self._cd_bytes(cd) for cd in added.values())
            self._entry_bytes[key] = self._entry_bytes.get(key, 0) + grow
            self._bytes += grow
            self._entries.move_to_end(key)
            self._evict_over_budget(keep=key)
            out = dict(ent)
        # the pre-lock snapshot + fresh columns always cover the request,
        # even if a concurrent thread evicted and rebuilt the entry
        out = {**have, **out, **fresh}
        return {c: out[c] for c in columns}
