"""Process-wide metrics of the port, and their Prometheus text page.

The port of trino_tpu/obs/metrics.py. Every metric has the reference's
``inc(amount, *labels)`` / ``set`` / ``observe`` / ``value`` /
``snapshot`` surface. The series of the serving plane (dispatch, executor
lanes, resource groups, the coordinator's query gauges, the memory ledger's
pressure and peak series, the process self-metrics) are declared in
``REGISTRY`` with the reference's names, help strings and label names, and
``render_registry`` renders them as the Prometheus text page that
``GET /v1/metrics`` serves on the coordinator and the workers, so both
packages' pages carry the same series. The other counters are plain and
unregistered: the tests and ``chip_smoke.py`` read them to show which join
tier a query took, what the staging and device-cache plane moved, and what
the result cache, the plan cache and the materialized views decided.

Server-derived gauges are refreshed from the owning server just before a
render, under ``RENDER_LOCK`` (server/events.render_metrics), and cleared
afterwards, so a worker's render in the same process never re-exports a
coordinator's values.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple


# the reference's latency buckets, in seconds
LATENCY_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0, 300.0)


def escape_label_value(value: str) -> str:
    """Prometheus label escaping: backslash, double quote and newline."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _series(name: str, labels: Dict[str, str], value) -> str:
    if labels:
        inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels.items())
        return f"{name}{{{inner}}} {_format_value(value)}"
    return f"{name} {_format_value(value)}"


class Metric:
    """Name, help, label names and a thread-safe child map keyed by label
    values. A metric declared without label names (``labelnames=None``)
    takes any labels and is never rendered."""

    type_name = "untyped"

    def __init__(self, name: str, help: Optional[str] = None,
                 labelnames: Optional[Sequence[str]] = None):
        self.name = name
        self.help = help
        self.labelnames = None if labelnames is None else tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _labelkey(self, labelvalues) -> Tuple[str, ...]:
        if self.labelnames is not None and len(labelvalues) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected labels {self.labelnames}, "
                             f"got {labelvalues!r}")
        return tuple(str(v) for v in labelvalues)

    def clear(self) -> None:
        with self._lock:
            self._children.clear()

    def header(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.type_name}"]

    def samples(self) -> List[tuple]:
        """Every touched series as ``(sample name, labels, value)``."""
        with self._lock:
            children = dict(self._children)
        return [(self.name, dict(zip(self.labelnames or (), key)), float(v))
                for key, v in sorted(children.items())]

    def render(self) -> List[str]:
        """The header, then one line a touched series (a metric never
        touched renders no series)."""
        return self.header() + [_series(n, lab, v) for n, lab, v in self.samples()]


class Counter(Metric):
    type_name = "counter"

    def inc(self, amount: float = 1, *labelvalues) -> None:
        key = self._labelkey(labelvalues)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + amount

    def value(self, *labelvalues) -> float:
        with self._lock:
            return self._children.get(self._labelkey(labelvalues), 0)


class Gauge(Counter):
    """A counter that can also be set (the last value wins)."""

    type_name = "gauge"

    def set(self, value: float, *labelvalues) -> None:
        key = self._labelkey(labelvalues)
        with self._lock:
            self._children[key] = value


class Histogram(Metric):
    """Cumulative fixed-bucket histogram: ``observe(value, *labels)`` and
    ``snapshot(*labels) -> (bucket counts, sum, count)``, as the
    reference's."""

    type_name = "histogram"

    def __init__(self, name: str, help: Optional[str] = None,
                 labelnames: Optional[Sequence[str]] = None, buckets=LATENCY_BUCKETS_S):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, *labelvalues) -> None:
        key = self._labelkey(labelvalues)
        with self._lock:
            counts, total, n = self._children.get(key, ([0] * len(self.buckets), 0.0, 0))
            counts = [c + (value <= b) for c, b in zip(counts, self.buckets)]
            self._children[key] = (counts, total + value, n + 1)

    def snapshot(self, *labelvalues):
        with self._lock:
            counts, total, n = self._children.get(
                self._labelkey(labelvalues), ([0] * len(self.buckets), 0.0, 0))
            return list(counts), total, n

    def samples(self) -> List[tuple]:
        """One cumulative ``_bucket`` sample a bound (``+Inf`` = the count),
        ``_sum`` and ``_count``, a label set."""
        with self._lock:
            children = {k: (list(c), t, n) for k, (c, t, n) in self._children.items()}
        out: List[tuple] = []
        for key, (counts, total, n) in sorted(children.items()):
            base = dict(zip(self.labelnames or (), key))
            for b, c in zip(self.buckets, counts):
                out.append((f"{self.name}_bucket", {**base, "le": _format_value(b)}, float(c)))
            out.append((f"{self.name}_bucket", {**base, "le": "+Inf"}, float(n)))
            out.append((f"{self.name}_sum", dict(base), float(total)))
            out.append((f"{self.name}_count", dict(base), float(n)))
        return out


# serializes refresh + render across every renderer of the process (the
# coordinator's gauge refresh and a worker's render); reentrant, since
# render_metrics holds it around its refresh while it calls render_registry
RENDER_LOCK = threading.RLock()


class MetricsRegistry:
    """The declared metrics in declaration order; renders the page."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _register(self, metric: Metric) -> Metric:
        with self._lock:
            return self._metrics.setdefault(metric.name, metric)

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(self, name, help, labelnames=(), buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))

    def names(self) -> List[str]:
        with self._lock:
            return list(self._metrics)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        with RENDER_LOCK:
            lines: List[str] = []
            for m in metrics:
                lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()

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


# ------------------------------------------------ the declared series
# coordinator state gauges, refreshed per render (server/events.py)
QUERIES = REGISTRY.gauge(
    "trino_tpu_queries", "tracked queries by lifecycle state", ("state",))
QUERIES_TOTAL = REGISTRY.counter(
    "trino_tpu_queries_total", "queries submitted since server start")
RESULT_ROWS = REGISTRY.gauge(
    "trino_tpu_result_rows", "result rows held by FINISHED tracked queries")
WORKERS = REGISTRY.gauge(
    "trino_tpu_workers", "alive workers in the discovery registry")
UPTIME_SECONDS = REGISTRY.gauge(
    "trino_tpu_uptime_seconds", "seconds since server start")

# the dispatch plane (server/dispatch.py): the bounded queue between the
# HTTP front and the executor lanes, typed overload rejections, lane
# occupancy and which plane ran each query
DISPATCH_QUEUE_DEPTH = REGISTRY.gauge(
    "trino_tpu_dispatch_queue_depth",
    "queries waiting in the bounded dispatch queue (between the HTTP "
    "front and the executor lanes)")
DISPATCH_REJECTED = REGISTRY.counter(
    "trino_tpu_dispatch_rejected_total",
    "statements rejected by the dispatch plane with the typed 429 + "
    "Retry-After overload response (reason = queue-full)", ("reason",))
DISPATCH_CACHE_SERVED = REGISTRY.counter(
    "trino_tpu_dispatch_cache_served_total",
    "queries answered entirely on the dispatch plane by the serving "
    "index (result-cache hit revalidated against connector data "
    "versions — no executor lane, no queue slot, no planning)")
EXECUTOR_LANES_BUSY = REGISTRY.gauge(
    "trino_tpu_executor_lanes_busy",
    "executor lanes currently running a query (the fixed lane pool "
    "replaced per-query thread creation)")
EXECUTOR_PLANE_QUERIES = REGISTRY.counter(
    "trino_tpu_executor_plane_queries_total",
    "dequeued queries by executing plane (inline = a dispatch-side "
    "executor lane; process = forwarded to an executor process; "
    "bounced = an executor process declined ownership and the query "
    "re-ran inline)", ("plane",))

# resource groups (server/resource_groups.py)
RESOURCE_GROUP_QUEUED = REGISTRY.gauge(
    "trino_tpu_resource_group_queued",
    "queries parked in one resource group's queue", ("group",))
RESOURCE_GROUP_RUNNING = REGISTRY.gauge(
    "trino_tpu_resource_group_running",
    "queries running under one resource group (subtree rollup)",
    ("group",))
RESOURCE_GROUP_QUEUE_SECONDS = REGISTRY.histogram(
    "trino_tpu_resource_group_queue_seconds",
    "time a query waited in its resource group's queue before the "
    "weighted-fair drain admitted (or aged) it", ("group",))
RESOURCE_GROUP_REJECTED = REGISTRY.counter(
    "trino_tpu_resource_group_rejected_total",
    "queries a resource group said no to, by reason (queue-full = typed "
    "429 at submit; queue-timeout = typed EXCEEDED_QUEUE_TIMEOUT "
    "failure after aging out of the group queue)", ("group", "reason"))
RESOURCE_GROUP_SERVED = REGISTRY.counter(
    "trino_tpu_resource_group_served_total",
    "serving-index hits attributed to a resource group "
    "(concurrency-free: answered on the dispatch thread without "
    "occupying a group slot, counted so cached repeats stay auditable)",
    ("group",))

# latency distribution per terminal state
QUERY_SECONDS = REGISTRY.histogram(
    "trino_tpu_query_seconds",
    "query wall time by terminal state", ("state",))

# the coordinator's completed-query ring
QUERY_HISTORY_SIZE = REGISTRY.gauge(
    "trino_tpu_query_history_size",
    "completed-query records held by the coordinator history ring "
    "(system.runtime.queries coverage of finished queries)")
QUERY_HISTORY_EVICTIONS = REGISTRY.counter(
    "trino_tpu_query_history_evictions_total",
    "completed-query records evicted from the coordinator history ring "
    "(query_max_history / query_min_expire_age_ms retention)")

# process self-metrics, refreshed before every render
PROCESS_RSS_BYTES = REGISTRY.gauge(
    "trino_tpu_process_rss_bytes",
    "resident set size of this server process (VmRSS)")
PROCESS_OPEN_FDS = REGISTRY.gauge(
    "trino_tpu_process_open_fds",
    "open file descriptors held by this server process")
PROCESS_THREADS = REGISTRY.gauge(
    "trino_tpu_process_threads",
    "live Python threads in this server process")
PROCESS_GC_COLLECTIONS = REGISTRY.gauge(
    "trino_tpu_process_gc_collections",
    "Python GC collections per generation since process start "
    "(point-in-time read of gc.get_stats)", ("generation",))

# fixed byte buckets for memory-size histograms: 64 KiB .. 64 GiB in
# powers of four
MEMORY_BUCKETS_BYTES = (
    64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20,
    1 << 30, 4 << 30, 16 << 30, 64 << 30)

# the memory ledger (obs/memledger.py): per-pool occupancy sampled on the
# worker announce loop, pressure sheds by reclaiming action, and each
# terminal query's peak
MEMORY_POOL_BYTES = REGISTRY.gauge(
    "trino_tpu_memory_pool_bytes",
    "live memory-pool occupancy by pool and node, sampled on the worker "
    "announce loop (device = query reservations + warm-HBM cache [+ "
    "staging scratch]; host = host-RAM page cache [+ other tracked host "
    "owners])", ("pool", "node"))
MEMORY_PRESSURE_EVENTS = REGISTRY.counter(
    "trino_tpu_memory_pressure_events_total",
    "revocable-tier pressure sheds by reclaiming action (spill = a "
    "query's pre-spill cache yield; pool-overflow = device pool over its "
    "limit; host-pressure = process RSS over the node limit; "
    "rss-escalation = host pressure escalated into host-backed device "
    "entries; yield = direct cache yields)", ("action",))
QUERY_PEAK_MEMORY_BYTES = REGISTRY.histogram(
    "trino_tpu_query_peak_memory_bytes",
    "per-query peak device-pool bytes (max over tasks/stages), observed "
    "once per terminal query", ("state",),
    buckets=MEMORY_BUCKETS_BYTES)


def current_rss_bytes():
    """This process's current resident set (VmRSS), or None where /proc
    is unavailable: a caller that needs a live pressure signal (the
    worker's host-RAM shed) treats None as unknown, never as 0."""
    try:
        with open("/proc/self/status", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def refresh_process_gauges() -> None:
    """Sample the process self-metrics (Linux /proc, with a portable
    fallback for the RSS); a failure leaves the previous reading."""
    import gc
    import os

    rss = current_rss_bytes()
    if rss is not None:
        PROCESS_RSS_BYTES.set(rss)
    else:
        try:
            import resource
            import sys

            # ru_maxrss is the peak, in bytes on macOS and KiB elsewhere
            unit = 1 if sys.platform == "darwin" else 1024
            PROCESS_RSS_BYTES.set(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * unit)
        except Exception:  # noqa: BLE001 — self-metrics are best-effort
            pass
    try:
        PROCESS_OPEN_FDS.set(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass
    PROCESS_THREADS.set(threading.active_count())
    for gen, st in enumerate(gc.get_stats()):
        PROCESS_GC_COLLECTIONS.set(int(st.get("collections", 0)), str(gen))


def render_registry() -> str:
    """The process's Prometheus text page (a worker's ``/v1/metrics``, and
    the coordinator's once its gauges refreshed)."""
    refresh_process_gauges()
    return REGISTRY.render()
