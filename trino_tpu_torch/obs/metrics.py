"""Process-wide counters for the port's local path.

A small stand-in for the reference's metrics registry
(trino_tpu/obs/metrics.py): plain labelled counters with the same
``inc(amount, *labels)`` / ``value(*labels)`` surface, and no exposition
format. The tests and ``chip_smoke.py`` read them to show which join tier a
query took, and what the staging and device-cache plane moved.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple


class Counter:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1, *labelvalues) -> None:
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + amount

    def value(self, *labelvalues) -> float:
        with self._lock:
            return self._children.get(tuple(str(v) for v in labelvalues), 0)


class Gauge(Counter):
    """A counter that can also be set (the last value wins)."""

    def set(self, value: float, *labelvalues) -> None:
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            self._children[key] = value


PLAN_VALIDATION_FAILURES = Counter("plan_validation_failures_total")
GENCACHE_HITS = Counter("tpch_gencache_hits_total")
GENCACHE_MISSES = Counter("tpch_gencache_misses_total")
GENCACHE_EVICTIONS = Counter("tpch_gencache_evictions_total")
# join kernel selections by the executor's tier gate (tier = dense | fused
# | merge-sorted | merge-pallas | legacy)
FUSED_JOIN_SELECTIONS = Counter("fused_join_selections_total")
SPANS_DROPPED = Counter("trace_spans_dropped_total")

# the staging plane (exec/staging.py): rows staged from connectors into
# device pages, bytes copied host->device for scanned columns, and the
# staging wall by sub-phase (scan | decode | transfer | host-cache)
STAGED_ROWS = Counter("staged_rows_total")
STAGED_H2D_BYTES = Counter("staged_h2d_bytes_total")
STAGING_SECONDS = Counter("staging_seconds_total")
STAGING_PHASE_SECONDS = Counter("staging_phase_seconds_total")

# the warm device table cache (devcache/cache.py): hits include
# single-flight followers; evictions count LRU pressure, yields to a
# spilling query and stale data_version drops after DML
DEVICE_CACHE_HITS = Counter("device_cache_hits_total")
DEVICE_CACHE_MISSES = Counter("device_cache_misses_total")
DEVICE_CACHE_EVICTIONS = Counter("device_cache_evictions_total")
DEVICE_CACHE_BYTES = Gauge("device_cache_bytes")
# joins served a cached sorted build (also counted as hits above)
DEVICE_CACHE_BUILD_HITS = Counter("device_cache_build_hits_total")

# the host-RAM tier under it (devcache/hostcache.py): decoded split columns
HOST_CACHE_HITS = Counter("host_cache_hits_total")
HOST_CACHE_MISSES = Counter("host_cache_misses_total")
HOST_CACHE_EVICTIONS = Counter("host_cache_evictions_total")
HOST_CACHE_BYTES = Gauge("host_cache_bytes")
