"""Process-wide counters for the port's local path.

A small stand-in for the reference's metrics registry
(trino_tpu/obs/metrics.py): plain labelled counters with the same
``inc(amount, *labels)`` / ``value(*labels)`` surface, histograms with its
``observe`` / ``snapshot``, and no exposition format. The tests and
``chip_smoke.py`` read them to show which join tier a query took, what the
staging and device-cache plane moved, and what the result cache, the plan
cache and the materialized views decided.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple


# the reference's latency buckets, in seconds
LATENCY_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0, 300.0)


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


class Histogram:
    """Cumulative fixed-bucket histogram: ``observe(value, *labels)`` and
    ``snapshot(*labels) -> (bucket counts, sum, count)``, as the
    reference's."""

    def __init__(self, name: str, buckets=LATENCY_BUCKETS_S):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], tuple] = {}

    def observe(self, value: float, *labelvalues) -> None:
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            counts, total, n = self._children.get(key, ([0] * len(self.buckets), 0.0, 0))
            counts = [c + (value <= b) for c, b in zip(counts, self.buckets)]
            self._children[key] = (counts, total + value, n + 1)

    def snapshot(self, *labelvalues):
        with self._lock:
            counts, total, n = self._children.get(
                tuple(str(v) for v in labelvalues), ([0] * len(self.buckets), 0.0, 0))
            return list(counts), total, n


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

# host seconds of the scalar lowerings' passes over a vocabulary or a table
# of days (ops/expr_lower.py): string work run once a distinct value on the
# host, before one gather by code on the device
SCALAR_HOST_SECONDS = Counter("scalar_host_seconds_total")
# host seconds of the nested slice's host passes (exec/executor.py): the
# MATCH_RECOGNIZE matcher with its row conversions, and the ORDER BY of a
# page holding nested columns
NESTED_HOST_SECONDS = Counter("nested_host_seconds_total")

# the compiled tier (exec/compiled.py): a run that captures its body into a
# CUDA graph (warm-up, capture, first replay) is a miss and its wall goes to
# COMPILE_SECONDS; a replay of the captured graph is a hit and its wall goes
# to DEVICE_SECONDS. A build also charges its phase-1 dynamic-filter
# seconds to STAGING_SECONDS above (its scans charge their own loads)
COMPILE_CACHE_MISSES = Counter("compile_cache_misses_total")
COMPILE_CACHE_HITS = Counter("compile_cache_hits_total")
COMPILE_SECONDS = Counter("compile_seconds_total")
DEVICE_SECONDS = Counter("device_seconds_total")
# the device profiler (obs/devprofiler.py): launches and dispatch overhead
# (wall minus device seconds) by operator, bumped when a query's kernel rows
# fold, never per dispatch; compile seconds by tier and cache outcome, one
# observation a compile event (a replay's is 0)
KERNEL_LAUNCHES = Counter("kernel_launches_total")
KERNEL_DISPATCH_OVERHEAD = Counter("kernel_dispatch_overhead_seconds")
COMPILE_SECONDS_TIERED = Histogram("compile_seconds")

# adaptive execution (adaptive/): plan changes by rule, applied at a stage
# boundary by the re-planner (join-distribution | capacity-reseed |
# skew-mitigation) and by the compiled tier's capacity reseeding
# (adaptive/reseed.py, also "capacity-reseed"); join flips by direction
# (to_partitioned | to_broadcast); exchange sources stamped with actual
# stage rows; hot partitions salted
ADAPTIVE_ADAPTATIONS = Counter("adaptive_adaptations_total")
ADAPTIVE_JOIN_FLIPS = Counter("adaptive_join_flips_total")
ADAPTIVE_RESEEDED_SOURCES = Counter("adaptive_reseeded_sources_total")
ADAPTIVE_SKEW_HOT_PARTITIONS = Counter("adaptive_skew_hot_partitions_total")

# the distributed path (data/serde.py, server/): wire bytes by direction
# (encode | decode) and codec (zlib | none | logical, the uncompressed
# block bytes); host seconds of the serde by step (encode and decode in
# whole, device<->host copies included; compress and decompress, zlib's
# share of them) and of the producers' hash partitioning; exchange bytes
# pulled; tasks created on workers
SERDE_BYTES = Counter("serde_bytes_total")
SERDE_SECONDS = Counter("serde_seconds_total")
PARTITION_SECONDS = Counter("partition_seconds_total")
EXCHANGE_BYTES = Counter("exchange_bytes_total")
TASKS_TOTAL = Counter("tasks_total")
# the keep-alive pool of server/wire.py
HTTP_CONNECTIONS_OPENED = Counter("http_connections_opened_total")
HTTP_CONNECTION_REUSES = Counter("http_connection_reuses_total")

# the query caching subsystem (cache/): the coordinator's result cache
# (hits include single-flight followers served by a concurrent leader;
# bypasses are cache-enabled queries that may not use it: DML/DDL,
# non-deterministic functions, table functions, unversioned tables) and
# its logical-plan cache
RESULT_CACHE_HITS = Counter("result_cache_hits_total")
RESULT_CACHE_MISSES = Counter("result_cache_misses_total")
RESULT_CACHE_BYPASSES = Counter("result_cache_bypasses_total")
RESULT_CACHE_EVICTIONS = Counter("result_cache_evictions_total")
RESULT_CACHE_BYTES = Gauge("result_cache_bytes")
RESULT_CACHE_SINGLE_FLIGHT_WAITS = Counter("result_cache_single_flight_waits_total")
PLAN_CACHE_HITS = Counter("plan_cache_hits_total")
PLAN_CACHE_MISSES = Counter("plan_cache_misses_total")
# prepared statements (server/prepared.py): the registry's size and the
# per-EXECUTE bind seconds (constant folding plus the plan substitution)
PREPARED_STATEMENTS = Gauge("prepared_statements")
EXECUTE_BIND_SECONDS = Histogram("execute_bind_seconds")
# materialized views (matview/): substitution decisions by result
# (substituted | stale | access-denied | invalid), the REFRESH wall (plan,
# execute, storage swap and the device-cache warm), and the warm's rows
# staged onto the session's device and the warms that failed (a failed
# warm never fails its REFRESH, so it is counted here instead)
MV_SUBSTITUTIONS = Counter("mv_substitutions_total")
MV_REFRESH_SECONDS = Histogram("mv_refresh_seconds")
MV_WARM_ROWS = Counter("mv_warm_rows_total")
MV_WARM_FAILURES = Counter("mv_warm_failures_total")
