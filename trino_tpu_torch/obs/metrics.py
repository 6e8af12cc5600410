"""Process-wide metrics of the port, and their Prometheus text page.

The port of trino_tpu/obs/metrics.py. Every metric has the reference's
``inc(amount, *labels)`` / ``set`` / ``observe`` / ``value`` /
``snapshot`` surface. The series of the serving plane (dispatch, executor
lanes, resource groups, the coordinator's query gauges, the memory ledger's
pressure and peak series, the process self-metrics) are declared in
``REGISTRY`` with the reference's names, help strings and label names, as
are those of the observability plane (the flow ledger's transfer, stall and
straggler series, the phase ledger's histogram, the exchange requests and
retries, the per-operator rollups, the fast-path paths and the OTLP drops)
and those of the fault-tolerant tier and the spooled result protocol (spool
reads, result segments, inline-result rejections), and the series the
reference registers for the join tiers, the staging, device-cache,
compile, serde, result-cache, plan-cache and view counters: the port's
registry has every series of the reference's, and a few of its own
(``PORT_SERIES``: the host seconds of planning, the eager executor, the
host passes, the compiled replay and the result rows' copies, the count of
substring passes by path, the seconds, host bytes and copied keys of the
executor's dynamic filters and the seconds of its windows and set operations).
``render_registry`` renders them as the Prometheus text page that
``GET /v1/metrics`` serves on the coordinator and the workers, and
``registry_samples`` as the rows of ``system.metrics.metrics``, so both
packages' pages carry the same series. The counters the reference has no
series for, and the port does not export, are plain and unregistered (the
host-to-device bytes, the serde's seconds, the views' warm rows): the tests
and ``chip_smoke.py`` read them.

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
        return _render_flat(self)


def _render_flat(metric: Metric) -> List[str]:
    """The header (the name is declared), then one line a touched series:
    a metric never touched renders no series, so a worker does not export
    the coordinator's gauges pinned at 0."""
    return metric.header() + [_series(n, lab, v) for n, lab, v in metric.samples()]


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

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

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

PLAN_VALIDATION_FAILURES = REGISTRY.counter(
    "trino_tpu_plan_validation_failures_total",
    "plan invariant violations raised by the plan-IR sanity checker", ('phase',))
GENCACHE_HITS = REGISTRY.counter(
    "trino_tpu_gencache_hits_total",
    "generator scan ranges served entirely from the datagen cache")
GENCACHE_MISSES = REGISTRY.counter(
    "trino_tpu_gencache_misses_total",
    "generator scan ranges that synthesized at least one column")
GENCACHE_EVICTIONS = REGISTRY.counter(
    "trino_tpu_gencache_evictions_total",
    "datagen cache entries evicted by the LRU byte budget")
# join kernel selections by the executor's tier gate (tier = dense | fused
# | merge-sorted | merge-pallas | legacy)
FUSED_JOIN_SELECTIONS = REGISTRY.counter(
    "trino_tpu_fused_join_selections_total",
    "join kernel selections by the fused-tier cost gate (tier = dense | "
    "fused | merge-sorted | merge-pallas | legacy); in the compiled/SPMD "
    "tiers a selection is counted per program TRACE, not per cached-"
    "executable run", ('tier',))
SPANS_DROPPED = REGISTRY.counter(
    "trino_tpu_spans_dropped_total",
    "spans dropped by the per-tracer span cap (TRINO_TPU_TRACE_MAX_SPANS, "
    "default 4096)")

# the staging plane (exec/staging.py): rows staged from connectors into
# device pages, bytes copied host->device for scanned columns, and the
# staging wall by sub-phase (scan | decode | transfer | host-cache)
STAGED_ROWS = REGISTRY.counter(
    "trino_tpu_staged_rows_total",
    "rows staged from connectors into pages")
STAGED_H2D_BYTES = Counter("staged_h2d_bytes_total")
STAGING_SECONDS = REGISTRY.counter(
    "trino_tpu_staging_seconds_total",
    "host-side staging seconds charged to queries: the compiled tier "
    "charges dynamic-filter resolution + host domain application (bench's "
    "staging_df_s — the host work a run repeats without the device cache; "
    "CUMULATIVE across scan threads under the pipelined fan-out, so it can "
    "exceed the staging wall); the worker tier charges the per-split "
    "scan+assemble wall of FRESH stagings (device-cache hits charge "
    "nothing)")
STAGING_PHASE_SECONDS = REGISTRY.counter(
    "trino_tpu_staging_phase_seconds_total",
    "staging pipeline wall seconds by sub-phase: scan (parallel split "
    "read+decode fan-out), decode (host assembly: concat + dictionary merge"
    " + physical narrowing), transfer (double-buffered host->device "
    "blocks), host-cache (host-tier probe)", ('phase',))

# the warm device table cache (devcache/cache.py): hits include
# single-flight followers; evictions count LRU pressure, yields to a
# spilling query and stale data_version drops after DML
DEVICE_CACHE_HITS = REGISTRY.counter(
    "trino_tpu_device_cache_hits_total",
    "table stagings served from the device cache (including single-flight "
    "followers served by a concurrent leader's transfer)")
DEVICE_CACHE_MISSES = REGISTRY.counter(
    "trino_tpu_device_cache_misses_total",
    "cache-eligible table stagings that transferred host pages to device "
    "and (budget permitting) filled the cache")
DEVICE_CACHE_EVICTIONS = REGISTRY.counter(
    "trino_tpu_device_cache_evictions_total",
    "device-cache entries dropped (LRU byte budget, revocable-tier yield to"
    " a running query, or a stale data_version after DML)")
DEVICE_CACHE_BYTES = REGISTRY.gauge(
    "trino_tpu_device_cache_bytes",
    "device bytes held by the warm-HBM table cache (the revocable tier)")
# joins served a cached sorted build (also counted as hits above)
DEVICE_CACHE_BUILD_HITS = REGISTRY.counter(
    "trino_tpu_device_cache_build_hits_total",
    "joins served a SORTED build-side artifact from the device cache (the "
    "warm repeated join skipped the build sort entirely; these also count "
    "in the general device-cache hit counter — the artifacts share the "
    "revocable-tier pool and byte budget)")

# the host-RAM tier under it (devcache/hostcache.py): decoded split columns
HOST_CACHE_HITS = REGISTRY.counter(
    "trino_tpu_host_cache_hits_total",
    "split stagings served decoded columns from the host-RAM page cache "
    "(including single-flight followers served by a concurrent leader's "
    "scan) — the staging pipeline skipped the connector scan and decode")
HOST_CACHE_MISSES = REGISTRY.counter(
    "trino_tpu_host_cache_misses_total",
    "cache-eligible split stagings that ran the connector scan+decode and "
    "(budget permitting) filled the host-RAM page cache")
HOST_CACHE_EVICTIONS = REGISTRY.counter(
    "trino_tpu_host_cache_evictions_total",
    "host-cache entries dropped (LRU byte budget, revocable-tier shed, or a"
    " stale data_version after DML)")
HOST_CACHE_BYTES = REGISTRY.gauge(
    "trino_tpu_host_cache_bytes",
    "host RAM held by the columnar page cache (the second revocable tier — "
    "sheds before the warm-HBM tier under node pressure)")

# the port's own host-time series, each fed at one boundary together with
# its span (obs/trace.py ``timed``; the outermost span of a family counts):
# planning (the ``parse``, ``analyze/plan``, ``optimize`` and
# ``plan/mv-substitute`` spans), the eager executor's run (``exec/run``),
# the scalar lowerings' passes over a vocabulary or a table of days
# (ops/expr_lower.py: string work run once a distinct value on the host,
# before one gather by code on the device) and the nested slice's host
# passes (exec/executor.py: the MATCH_RECOGNIZE matcher with its row
# conversions, the ORDER BY of a page holding nested columns), both
# ``exec/host-pass``; the compiled tier's replay path (``device/execute``)
# and its wait for the replay (``device/flag-read``); the result rows'
# device-to-host copies (``rows/copy``). The reference has no such series
PLAN_SECONDS = REGISTRY.counter(
    "trino_tpu_plan_seconds_total",
    "host seconds parsing, analyzing, planning and optimizing statements "
    "(and substituting materialized views), nested planning counted once")
EXECUTOR_SECONDS = REGISTRY.counter(
    "trino_tpu_executor_seconds_total",
    "wall seconds of eager executor runs (Executor.execute_checked: the "
    "plan's dispatch, its host passes, the error flags and the batched "
    "stats read), a run nested in another counted once")
SCALAR_HOST_SECONDS = REGISTRY.counter(
    "trino_tpu_scalar_host_seconds_total",
    "host seconds of the scalar lowerings' passes over a dictionary's "
    "vocabulary or a table of days")
NESTED_HOST_SECONDS = REGISTRY.counter(
    "trino_tpu_nested_host_seconds_total",
    "host seconds of the nested slice's host passes (the MATCH_RECOGNIZE "
    "matcher, the ORDER BY of a page holding nested columns)")
COMPILED_RUN_SECONDS = REGISTRY.counter(
    "trino_tpu_compiled_run_seconds_total",
    "wall seconds of compiled-query replays (CompiledQuery.run on a "
    "captured graph: enqueue, flag read, ledger, output clone)")
REPLAY_WAIT_SECONDS = REGISTRY.counter(
    "trino_tpu_replay_wait_seconds_total",
    "host seconds compiled-query replays waited for the card (the read of "
    "the fired error flags)")
ROWS_COPY_SECONDS = REGISTRY.counter(
    "trino_tpu_rows_copy_seconds_total",
    "host seconds of the result rows' device-to-host copies (the selection "
    "and every column, before the Python conversion)")
# substring's host passes by path (ops/expr_lower.py ``_lower_substring``,
# the ``path`` attribute of their ``exec/host-pass`` spans): one numpy pass
# over an ASCII vocabulary's bytes, or one call a vocabulary entry where a
# character is not a byte or an entry holds a NUL
SUBSTRING_VECTOR_PASSES = REGISTRY.counter(
    "trino_tpu_substring_vector_passes_total",
    "substring host passes run as one vectorized pass over an ASCII "
    "vocabulary's bytes")
SUBSTRING_ENTRY_PASSES = REGISTRY.counter(
    "trino_tpu_substring_entry_passes_total",
    "substring host passes run once a vocabulary entry (a vocabulary with a "
    "non-ASCII character or a NUL)")
# the eager executor's dynamic filters (exec/executor.py
# ``_collect_dynamic_filters``, the ``exec/dynamic-filter`` spans: each build
# key reduced on the device to its live count, min and max, its domain a set
# of its live rows copied to the host or a range),
# its windows (``exec/window``, ``window_over_page``) and its set operations
# (``exec/set-op``: UNION ALL's concatenation, ``set_op_pages``); each inside
# an ``exec/run`` span, so their seconds are also executor seconds
DYNAMIC_FILTER_SECONDS = REGISTRY.counter(
    "trino_tpu_dynamic_filter_seconds_total",
    "host seconds of the eager executor's dynamic filters (the build-side "
    "keys' reductions, their reads to the host and their set or range)")
DYNAMIC_FILTER_HOST_BYTES = REGISTRY.counter(
    "trino_tpu_dynamic_filter_host_bytes_total",
    "bytes the eager executor's dynamic filters copied from the device to "
    "the host (each build key's live count, min and max, and the live "
    "values of a key that forms a set)")
DYNAMIC_FILTER_COPIED_KEYS = REGISTRY.counter(
    "trino_tpu_dynamic_filter_copied_keys_total",
    "build keys whose live rows the eager executor's dynamic filters copied "
    "to the host (a set of at most 1024 values)")
WINDOW_SECONDS = REGISTRY.counter(
    "trino_tpu_window_seconds_total",
    "host seconds of the eager executor's window operators (the layout and "
    "every window call's dispatch)")
SET_OP_SECONDS = REGISTRY.counter(
    "trino_tpu_set_op_seconds_total",
    "host seconds of the eager executor's set operations (UNION ALL's "
    "concatenation, INTERSECT and EXCEPT)")
# the series above, which only the port registers
PORT_SERIES = (PLAN_SECONDS.name, EXECUTOR_SECONDS.name, SCALAR_HOST_SECONDS.name,
               NESTED_HOST_SECONDS.name, COMPILED_RUN_SECONDS.name,
               REPLAY_WAIT_SECONDS.name, ROWS_COPY_SECONDS.name,
               SUBSTRING_VECTOR_PASSES.name, SUBSTRING_ENTRY_PASSES.name,
               DYNAMIC_FILTER_SECONDS.name, DYNAMIC_FILTER_HOST_BYTES.name,
               DYNAMIC_FILTER_COPIED_KEYS.name,
               WINDOW_SECONDS.name, SET_OP_SECONDS.name)

# the compiled tier (exec/compiled.py): a run that captures its body into a
# CUDA graph (warm-up, capture, first replay) is a miss and its wall goes to
# COMPILE_SECONDS; a replay of the captured graph is a hit and its wall goes
# to DEVICE_SECONDS. A build also charges its phase-1 dynamic-filter
# seconds to STAGING_SECONDS above (its scans charge their own loads)
COMPILE_CACHE_MISSES = REGISTRY.counter(
    "trino_tpu_compile_cache_misses_total",
    "compiled-query runs that traced+compiled (first run or capacity "
    "regrowth)")
COMPILE_CACHE_HITS = REGISTRY.counter(
    "trino_tpu_compile_cache_hits_total",
    "compiled-query runs reusing an already-built XLA executable")
COMPILE_SECONDS = REGISTRY.counter(
    "trino_tpu_compile_seconds_total",
    "wall seconds of compiled-query runs that traced+compiled (kept out of "
    "device seconds so one-time compiles don't skew throughput math)")
DEVICE_SECONDS = REGISTRY.counter(
    "trino_tpu_device_seconds_total",
    "device execution wall seconds (fragment bodies / compiled runs)")
# the device profiler (obs/devprofiler.py): launches and dispatch overhead
# (wall minus device seconds) by operator, bumped when a query's kernel rows
# fold, never per dispatch; compile seconds by tier and cache outcome, one
# observation a compile event (a replay's is 0)
KERNEL_LAUNCHES = REGISTRY.counter(
    "trino_tpu_kernel_launches_total",
    "device dispatches by operator kind, folded from the kernel ledger at "
    "query completion", ('operator',))
KERNEL_DISPATCH_OVERHEAD = REGISTRY.counter(
    "trino_tpu_kernel_dispatch_overhead_seconds",
    "per-operator wall minus device seconds (host dispatch overhead — the "
    "number fragment megakernels must beat), folded from the kernel ledger "
    "at query completion", ('operator',))
COMPILE_SECONDS_TIERED = REGISTRY.histogram(
    "trino_tpu_compile_seconds",
    "per-event jit/Pallas compile seconds by execution tier and compile-"
    "cache outcome (hit events observe ~0)", ('tier', 'cache'))

# adaptive execution (adaptive/): plan changes by rule, applied at a stage
# boundary by the re-planner (join-distribution | capacity-reseed |
# skew-mitigation) and by the compiled tier's capacity reseeding
# (adaptive/reseed.py, also "capacity-reseed"); join flips by direction
# (to_partitioned | to_broadcast); exchange sources stamped with actual
# stage rows; hot partitions salted
ADAPTIVE_ADAPTATIONS = REGISTRY.counter(
    "trino_tpu_adaptive_adaptations_total",
    "plan changes applied by the adaptive re-planner at stage boundaries", ('rule',))
ADAPTIVE_JOIN_FLIPS = REGISTRY.counter(
    "trino_tpu_adaptive_join_flips_total",
    "join-distribution switches (actual build rows contradicted the "
    "estimate across join_max_broadcast_rows)", ('direction',))
ADAPTIVE_RESEEDED_SOURCES = REGISTRY.counter(
    "trino_tpu_adaptive_reseeded_sources_total",
    "exchange sources stamped with actual upstream stage rows before their "
    "consumer fragment scheduled")
ADAPTIVE_SKEW_HOT_PARTITIONS = REGISTRY.counter(
    "trino_tpu_adaptive_skew_hot_partitions_total",
    "hot partitions salted by the adaptive skew mitigation (spread on the "
    "probe producer, replicated on the build producer)")

# the distributed path (data/serde.py, server/): wire bytes by direction
# (encode | decode) and codec (zlib | none | logical, the uncompressed
# block bytes); host seconds of the serde by step (encode and decode in
# whole, device<->host copies included; compress and decompress, zlib's
# share of them) and of the producers' hash partitioning; exchange bytes
# pulled; tasks created on workers
SERDE_BYTES = REGISTRY.counter(
    "trino_tpu_serde_bytes_total",
    "page serde column-block bytes by direction and codec (codec = zlib "
    "compressed-wire | none raw-stored | logical uncompressed input/output;"
    " ratio = (zlib + none) / logical)", ('direction', 'codec'))
SERDE_SECONDS = Counter("serde_seconds_total")
PARTITION_SECONDS = Counter("partition_seconds_total")
EXCHANGE_BYTES = REGISTRY.counter(
    "trino_tpu_exchange_bytes_total",
    "serialized page bytes pulled from upstream task buffers")
TASKS_TOTAL = REGISTRY.counter(
    "trino_tpu_tasks_total",
    "tasks created on this node")
# the keep-alive pool of server/wire.py
HTTP_CONNECTIONS_OPENED = REGISTRY.counter(
    "trino_tpu_http_connections_opened_total",
    "fresh TCP connections opened by the keep-alive HTTP client pool")
HTTP_CONNECTION_REUSES = REGISTRY.counter(
    "trino_tpu_http_connection_reuses_total",
    "HTTP requests served over a pooled keep-alive connection (no TCP "
    "connect paid)")

# the query caching subsystem (cache/): the coordinator's result cache
# (hits include single-flight followers served by a concurrent leader;
# bypasses are cache-enabled queries that may not use it: DML/DDL,
# non-deterministic functions, table functions, unversioned tables) and
# its logical-plan cache
RESULT_CACHE_HITS = REGISTRY.counter(
    "trino_tpu_result_cache_hits_total",
    "queries answered from the coordinator result cache (including single-"
    "flight followers served by a concurrent leader)")
RESULT_CACHE_MISSES = REGISTRY.counter(
    "trino_tpu_result_cache_misses_total",
    "cache-eligible queries that executed and (re)filled the result cache")
RESULT_CACHE_BYPASSES = REGISTRY.counter(
    "trino_tpu_result_cache_bypasses_total",
    "cache-enabled queries that bypassed the result cache (DML/DDL, non-"
    "deterministic functions, table functions, unversioned tables)")
RESULT_CACHE_EVICTIONS = REGISTRY.counter(
    "trino_tpu_result_cache_evictions_total",
    "result-cache entries evicted by the LRU byte budget")
RESULT_CACHE_BYTES = REGISTRY.gauge(
    "trino_tpu_result_cache_bytes",
    "estimated bytes of result pages held by the coordinator result cache")
RESULT_CACHE_SINGLE_FLIGHT_WAITS = REGISTRY.counter(
    "trino_tpu_result_cache_single_flight_waits_total",
    "queries that parked on a concurrent identical query's in-flight "
    "execution instead of executing themselves")
PLAN_CACHE_HITS = REGISTRY.counter(
    "trino_tpu_plan_cache_hits_total",
    "queries that reused a cached optimized logical plan (skipping "
    "parse/analyze/plan/optimize)")
PLAN_CACHE_MISSES = REGISTRY.counter(
    "trino_tpu_plan_cache_misses_total",
    "plan-cache lookups that planned from scratch (first sight, changed "
    "session properties, or a data-version mismatch)")
# prepared statements (server/prepared.py): the registry's size and the
# per-EXECUTE bind seconds (constant folding plus the plan substitution)
PREPARED_STATEMENTS = REGISTRY.gauge(
    "trino_tpu_prepared_statements",
    "prepared statements held by the coordinator registry (all users)")
EXECUTE_BIND_SECONDS = REGISTRY.histogram(
    "trino_tpu_execute_bind_seconds",
    "EXECUTE parameter bind time: constant-folding the USING expressions + "
    "substituting them into the cached parameterized plan")
# materialized views (matview/): substitution decisions by result
# (substituted | stale | access-denied | invalid), the REFRESH wall (plan,
# execute, storage swap and the device-cache warm), and the warm's rows
# staged onto the session's device and the warms that failed (a failed
# warm never fails its REFRESH, so it is counted here instead)
MV_SUBSTITUTIONS = REGISTRY.counter(
    "trino_tpu_mv_substitutions_total",
    "materialized-view substitution decisions by the planner pass (result ="
    " substituted | stale | access-denied | invalid): 'substituted' rewrote"
    " a matched plan subtree into a storage-table scan; every other result "
    "fell back to the base plan", ('result',))
MV_REFRESH_SECONDS = REGISTRY.histogram(
    "trino_tpu_mv_refresh_seconds",
    "REFRESH MATERIALIZED VIEW wall time: plan + execute the definition + "
    "atomic storage swap (+ the optional device-cache warm staging)")
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

# the distributed path's exchange requests and retries (server/
# exchange_client.py), the per-operator rollups fed at task completion
# (server/task.py), and the control-plane path of each SELECT
EXCHANGE_REQUESTS = REGISTRY.counter(
    "trino_tpu_exchange_requests_total",
    "exchange pull HTTP requests issued")
EXCHANGE_RETRIES = REGISTRY.counter(
    "trino_tpu_exchange_retries_total",
    "exchange pull attempts retried after transient failures")
OPERATOR_WALL_SECONDS = REGISTRY.histogram(
    "trino_tpu_operator_wall_seconds",
    "per-task operator wall time by operator kind, observed at task "
    "completion", ("operator",))
OPERATOR_ROWS = REGISTRY.counter(
    "trino_tpu_operator_rows_total",
    "rows output by operator kind, accumulated at task completion",
    ("operator",))
# declared as the reference's; the port has no SPMD exchange to count
EXCHANGE_OVERLAPPED = REGISTRY.counter(
    "trino_tpu_exchange_overlapped_total",
    "probe-side exchanges compiled as double-buffered send-block pipelines "
    "(all-to-all of block k+1 overlapped with join compute on block k); "
    "counted per program trace, not per run", ("blocks",))
FAST_PATH_QUERIES = REGISTRY.counter(
    "trino_tpu_fast_path_queries_total",
    "SELECT executions by control-plane path (fast-path = single-stage "
    "plan run coordinator-local, skipping task round-trips; distributed = "
    "fragment/schedule/execute across workers; local-catalog = forced "
    "coordinator-local by a process-local catalog)", ("path",))

# the fault-tolerant tier's spool reads (server/exchange_client.py), the
# spooled result protocol's segments (server/segments.py: written, served,
# reclaimed by ack, TTL or orphan sweep) and queries, and the inline-result
# guard's rejections (server/coordinator.py)
SPOOL_READS = REGISTRY.counter(
    "trino_tpu_spool_reads_total",
    "task outputs served from the durable spool instead of a live buffer")
SPOOL_BYTES = REGISTRY.counter(
    "trino_tpu_spool_bytes_total",
    "page bytes read from durable spool files (kept separate from "
    "exchange bytes, which count network pulls from live buffers)")
RESULT_SEGMENTS_WRITTEN = REGISTRY.counter(
    "trino_tpu_result_segments_written_total",
    "spooled result segments written to this process's segment store")
RESULT_SEGMENT_BYTES = REGISTRY.counter(
    "trino_tpu_result_segment_bytes_total",
    "spooled result segment bytes by direction (written = rolled into "
    "the segment store; served = read out by segment GETs)",
    ("direction",))
RESULT_SEGMENTS_RECLAIMED = REGISTRY.counter(
    "trino_tpu_result_segments_reclaimed_total",
    "result segments deleted, by reason (ack = client fetched and acked; "
    "ttl = expired un-acked, including failed queries' early drops; "
    "orphan = stale files swept at server start)", ("reason",))
RESULT_SEGMENT_RECLAIMED_BYTES = REGISTRY.counter(
    "trino_tpu_result_segment_reclaimed_bytes_total",
    "bytes reclaimed by result-segment deletion, by reason "
    "(ack | ttl | orphan)", ("reason",))
SPOOLED_RESULT_QUERIES = REGISTRY.counter(
    "trino_tpu_spooled_result_queries_total",
    "queries whose results were served as a spooled segment manifest, by "
    "mode (worker-direct = root-fragment producers wrote the segments "
    "and the coordinator never touched the data; coordinator = the "
    "coordinator spooled from its own segment store)", ("mode",))
INLINE_RESULT_REJECTIONS = REGISTRY.counter(
    "trino_tpu_inline_result_rejections_total",
    "queries failed by the inline-result memory guard "
    "(inline_result_max_bytes exceeded with spooled results disabled — "
    "the coordinator refuses to materialize, instead of OOMing the "
    "dispatch plane)")

# the phase ledger (obs/timeline.py): each terminal query's exclusive
# wall by phase
QUERY_PHASE_SECONDS = REGISTRY.histogram(
    "trino_tpu_query_phase_seconds",
    "exclusive query wall seconds attributed to each phase by the "
    "completion-time phase ledger (queued | dispatch-queue | dispatch | "
    "parse-analyze | plan-optimize | prepare-bind | schedule | "
    "device-staging | device-execute | exchange-wait | "
    "result-serialization | segment-fetch | client-drain | "
    "unattributed)", ("phase",))

# OTLP export (obs/otlp.py): what the background exporter dropped
# instead of blocking the query path, by reason
OTLP_DROPPED = REGISTRY.counter(
    "trino_tpu_otlp_dropped_total",
    "OTLP export spans/metric batches dropped instead of blocking "
    "(reason = overflow: bounded queue full; send-error: collector "
    "unreachable or non-2xx)", ("reason",))

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


# the data-plane flow ledger (obs/flowledger.py): every cross-boundary
# byte by link class, the producers' and consumers' backpressure stalls,
# and the straggler detector's verdicts at query completion
TRANSFER_BYTES = REGISTRY.counter(
    "trino_tpu_transfer_bytes_total",
    "bytes moved across a data-plane link, by link class (exchange-pull "
    "| spool-write | segment-fetch | staging-transfer | client-drain | "
    "control) and direction (send | recv, from this process's "
    "viewpoint)", ("link", "direction"))
TRANSFER_SECONDS = REGISTRY.counter(
    "trino_tpu_transfer_seconds",
    "wall seconds spent moving bytes on a data-plane link (cumulative "
    "across concurrent transfers, so bytes/seconds is the per-stream "
    "effective rate, not the aggregate)", ("link",))
BACKPRESSURE_STALL_SECONDS = REGISTRY.counter(
    "trino_tpu_backpressure_stall_seconds_total",
    "seconds producers spent blocked on full output buffers plus "
    "consumers spent on empty exchange polls, by stage", ("stage",))
STRAGGLER_TASKS = REGISTRY.counter(
    "trino_tpu_straggler_tasks_total",
    "tasks flagged by the straggler detector at query completion, by "
    "dominant cause (transfer-bound | device-bound | queue-bound)",
    ("cause",))


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


def registry_samples() -> List[tuple]:
    """Every touched series as ``(name, type, labels, value, help)``: the
    row view of the Prometheus page that ``system.metrics`` serves, built
    from the same per-metric ``samples()`` the text rendering reads, so
    the table and ``/v1/metrics`` cannot diverge."""
    refresh_process_gauges()
    with REGISTRY._lock:
        metrics = list(REGISTRY._metrics.values())
    out: List[tuple] = []
    with RENDER_LOCK:
        for m in metrics:
            out.extend((name, m.type_name, labels, value, m.help)
                       for name, labels, value in m.samples())
    return out
