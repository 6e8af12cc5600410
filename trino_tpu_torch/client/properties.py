"""Typed session properties.

Reference: ``SystemSessionProperties.java`` (1,985 lines, ~200 typed
properties) + ``SessionPropertyManager`` — every knob is declared with a
type, default, and description; setting an unknown property or a
badly-typed value is an error at set time, not a silent no-op at use time.

The registry here covers the knobs the engine actually reads; add an entry
when a new subsystem grows a switch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class PropertyMetadata:
    name: str
    description: str
    py_type: type
    default: Any
    validate: Optional[Callable[[Any], Optional[str]]] = None  # -> error | None


def _positive(v) -> Optional[str]:
    return None if v > 0 else "must be positive"


SYSTEM_SESSION_PROPERTIES: Dict[str, PropertyMetadata] = {
    p.name: p
    for p in [
        PropertyMetadata("catalog", "default catalog", str, "tpch"),
        PropertyMetadata("schema", "default schema", str, "tiny"),
        PropertyMetadata(
            "query_max_device_memory",
            "per-query device working-set budget in bytes; exceeding it "
            "spills joins/aggregations to host-partitioned passes "
            "(reference: query.max-memory-per-node)",
            int, None, lambda v: _positive(v) if v is not None else None,
        ),
        PropertyMetadata(
            "dynamic_filtering_enabled",
            "collect build-side join key domains at runtime to narrow probe "
            "scans (reference: enable_dynamic_filtering)",
            bool, True,
        ),
        PropertyMetadata(
            "spill_enabled",
            "allow over-budget joins/aggregations to run as host-partitioned "
            "passes instead of failing (reference: spill_enabled)",
            bool, True,
        ),
        PropertyMetadata(
            "device_profiling",
            "bracket every device dispatch with block_until_ready so the "
            "kernel ledger measures device seconds (off: zero-sync "
            "counting only — device seconds estimated from wall)",
            bool, False,
        ),
        PropertyMetadata(
            "slow_injection",
            "straggler injection for speculative-execution tests: "
            "'<task-id-substring>:<seconds>' sleeps matching tasks "
            "(reference: FailureInjector)",
            str, "",
        ),
        PropertyMetadata(
            "phased_execution",
            "delay probe-side fragments until their leaf join-build "
            "fragments finish executing (reference: "
            "execution-policy=phased / PhasedExecutionSchedule)",
            bool, True,
        ),
        PropertyMetadata(
            "target_result_page_rows",
            "rows per result page on the client protocol",
            int, 10_000, _positive,
        ),
        PropertyMetadata(
            "join_max_broadcast_rows",
            "estimated build-side rows above which a distributed join "
            "co-partitions both sides by key hash instead of broadcasting "
            "the build (reference: join_max_broadcast_table_size)",
            int, 1 << 17, _positive,
        ),
        PropertyMetadata(
            "sink_max_buffer_bytes",
            "producer-blocking watermark of a task's output buffer "
            "(reference: sink.max-buffer-size) — the streaming flow-control "
            "bound between producer serialization and consumer pulls",
            int, 32 << 20, _positive,
        ),
        PropertyMetadata(
            "task_output_chunk_bytes",
            "target serialized bytes per task output page: task results "
            "stream to consumers in chunks of this size (reference role: "
            "PagesSerde / output-buffer page size targets)",
            int, 4 << 20, _positive,
        ),
        PropertyMetadata(
            "retry_policy",
            "NONE = pipelined all-at-once scheduling; TASK = fault-tolerant "
            "stage-by-stage execution with per-task retries over spooled "
            "outputs (reference: retry-policy / RetryPolicy.java)",
            str, "NONE",
            lambda v: None if v.upper() in ("NONE", "TASK") else "must be NONE or TASK",
        ),
        PropertyMetadata(
            "gather_max_rows_per_device",
            "estimated rows per device above which distributed windows/"
            "set-ops/sorts repartition (hash or range exchange) instead of "
            "gathering the whole input to every device (reference role: "
            "the AddExchanges distribution thresholds)",
            int, 1 << 16, _positive,
        ),
        PropertyMetadata(
            "slow_query_log_threshold_ms",
            "queries whose wall time reaches this many milliseconds are "
            "logged by SlowQueryLogListener with their slowest trace spans "
            "(obs/listeners.py); overrides the listener/server default",
            int, None, lambda v: _positive(v) if v is not None else None,
        ),
        PropertyMetadata(
            "result_cache_enabled",
            "serve repeated deterministic SELECTs from the coordinator "
            "result cache (trino_tpu/cache/): keyed on the canonical "
            "optimized plan + connector data versions, single-flighted, "
            "disposition surfaced via the X-Trino-Tpu-Cache header",
            bool, False,
        ),
        PropertyMetadata(
            "result_cache_ttl_ms",
            "lifetime of a result-cache entry in milliseconds; version-"
            "based invalidation usually fires first, the TTL bounds "
            "staleness for unversioned edge cases and reclaims dead keys",
            int, 60_000, _positive,
        ),
        PropertyMetadata(
            "result_cache_max_bytes",
            "per-query admission budget against the coordinator result "
            "cache: results above a quarter of min(this, the server "
            "budget) are not cached (the server-wide LRU budget itself is "
            "fixed at server scope — one session cannot resize it)",
            int, 64 << 20, _positive,
        ),
        PropertyMetadata(
            "logical_plan_cache_enabled",
            "reuse cached optimized logical plans on canonical-SQL repeat "
            "(skipping parse/analyze/plan/optimize), revalidated against "
            "connector data versions at lookup",
            bool, True,
        ),
        PropertyMetadata(
            "device_cache_enabled",
            "serve repeated table stagings from the device-resident table "
            "cache (trino_tpu/devcache/): staged scan pages stay warm in "
            "device memory keyed by connector data_version, so an "
            "unchanged table's second query pays zero host->device scan "
            "transfer; unversioned connectors always bypass",
            bool, False,
        ),
        PropertyMetadata(
            "device_cache_max_bytes",
            "per-staging admission cap against the device table cache: "
            "entries above min(this, the server-wide budget) are staged "
            "but not retained (the shared budget itself is fixed at "
            "process scope — one session cannot resize it)",
            int, 1 << 30, _positive,
        ),
        PropertyMetadata(
            "staging_parallelism",
            "fan-out width of the pipelined staging engine "
            "(exec/staging.py): split scan+decode run with this many in "
            "flight on the shared staging pool, overlapping the "
            "host->device transfer; 1 = the serial path (the microbench "
            "baseline), 0 = auto (min(8, cpu count))",
            int, 0, lambda v: None if v >= 0 else "must be >= 0",
        ),
        PropertyMetadata(
            "staging_split_bytes",
            "target estimated bytes per scan split: staging derives its "
            "get_splits target from estimated table bytes / this, so "
            "tiny tables stay single-split (no fan-out overhead) and "
            "huge tables parallelize (adaptive split sizing, "
            "exec/staging.py)",
            int, 64 << 20, _positive,
        ),
        PropertyMetadata(
            "host_cache_max_bytes",
            "per-split admission cap against the host-RAM columnar page "
            "cache (trino_tpu/devcache/hostcache.py): decoded split "
            "column sets above min(this, the server-wide budget) are "
            "staged but not retained (the shared budget itself is fixed "
            "at process scope — one session cannot resize it)",
            int, 256 << 20, _positive,
        ),
        PropertyMetadata(
            "fused_join_enabled",
            "run N:1 lookup joins and semi/anti membership through the "
            "fused sort-merge tier (ops/fused_join.py): build and probe "
            "keys sort TOGETHER in one compiled region — no SortedBuild "
            "intermediate, no separate build sort; dense integer-keyed "
            "builds keep the direct-address fast path either way (the "
            "cost gate, see README 'Join kernels')",
            bool, True,
        ),
        PropertyMetadata(
            "fused_join_pallas",
            "run the merge step of sorted-build joins as the Pallas tiled "
            "two-pointer merge kernel (ops/merge_pallas.py) when its "
            "contract holds (single int32 key, sentinel provably "
            "unreachable); OPT-IN: unset/false keeps the XLA rank merge "
            "(the kernel graduates to a default after a hardware bench "
            "round validates it); true engages it — compiled on TPU, "
            "interpret mode elsewhere (test meshes)",
            bool, None,
        ),
        PropertyMetadata(
            "exchange_overlap_blocks",
            "split the probe side of SPMD partitioned joins into this many "
            "double-buffered send blocks so the ICI all-to-all of block "
            "k+1 overlaps join compute on block k "
            "(parallel/exchange.repartition_page_overlapped); results are "
            "bit-identical to the unoverlapped exchange; 0 or 1 disables "
            "the pipeline (one exchange-then-compute barrier)",
            int, 0, lambda v: None if v >= 0 else "must be >= 0",
        ),
        PropertyMetadata(
            "short_query_fast_path",
            "run SELECTs whose optimized plan would fragment into at most "
            "one distributed stage (point lookups, small scans, single-"
            "step aggregations) on the coordinator's own engine — same "
            "admission, caches, stats, and spans, zero task HTTP round-"
            "trips (server/fastpath.py; reference role: the dispatch/"
            "execution split of QueuedStatementResource); the decision is "
            "visible in query info (fastPath) and EXPLAIN ANALYZE",
            bool, False,
        ),
        PropertyMetadata(
            "fast_path_max_scan_rows",
            "estimated total scan rows above which a single-stage plan "
            "still executes distributed (the coordinator must not absorb "
            "big scans serially just because they fragment simply)",
            int, 4_000_000, _positive,
        ),
        PropertyMetadata(
            "adaptive_execution_enabled",
            "re-plan not-yet-scheduled downstream fragments between stage "
            "completions using the runtime operator-stats rollups (master "
            "switch for trino_tpu/adaptive/; reference: AdaptivePlanner + "
            "FTE adaptive partitioning)",
            bool, True,
        ),
        PropertyMetadata(
            "adaptive_join_distribution",
            "flip broadcast<->partitioned join distribution at the stage "
            "boundary when a build side's ACTUAL rows contradict the "
            "estimate across join_max_broadcast_rows (reference: "
            "DetermineJoinDistributionType re-fired on runtime stats)",
            bool, True,
        ),
        PropertyMetadata(
            "adaptive_capacity_reseed",
            "replace static capacity-hint guesses with runtime truth: "
            "staged-scan histograms size expansion joins and hash exchanges "
            "at build time (compiled/SPMD tiers), and completed upstream "
            "stage rows stamp exchange sources on the coordinator — "
            "eliminating the double-and-recompile loop",
            bool, False,
        ),
        PropertyMetadata(
            "adaptive_skew_threshold",
            "hot-partition ROW ratio — a partition is hot when its output "
            "rows exceed this many times the mean of the OTHER partitions "
            "(serialized bytes lie under compression) and a 4096-row "
            "floor; the adaptive re-planner then salts the repartition "
            "join: the probe producer re-runs spreading hot partitions "
            "across all tasks while the build producer replicates them "
            "everywhere; 0 disables skew mitigation",
            int, 8, lambda v: None if v >= 0 else "must be >= 0",
        ),
        PropertyMetadata(
            "plan_validation",
            "run the plan-IR sanity checker (sql/planner/sanity.py) after "
            "initial planning, after each optimizer pass, after "
            "fragmentation, and after every adaptive re-plan — a bad "
            "rewrite fails loudly at plan time instead of corrupting "
            "results (reference: PlanSanityChecker between optimizer "
            "stages); default (unset) = AUTO: on under pytest, off "
            "otherwise",
            bool, None,
        ),
        PropertyMetadata(
            "query_max_history",
            "completed-query records the coordinator history ring retains "
            "for system.runtime.queries and the /ui recent-queries table "
            "(reference: query.max-history); applied when THIS query "
            "completes, and only ever GROWS retention — values below the "
            "server default are clamped up (the ring is shared state; one "
            "session must not shrink other users' history)",
            int, 100, _positive,
        ),
        PropertyMetadata(
            "query_min_expire_age_ms",
            "minimum age in milliseconds before a completed-query record "
            "may be evicted from the history ring even when over "
            "query_max_history (reference: query.min-expire-age); values "
            "below the server default are clamped up, and a hard "
            "server-side cap still bounds the ring",
            int, 15_000, lambda v: None if v >= 0 else "must be >= 0",
        ),
        PropertyMetadata(
            "spooled_results_enabled",
            "serve large SELECT results as a spooled segment manifest "
            "instead of inline rows: the producers write serde-encoded "
            "result segments (workers directly for export-shaped plans, "
            "the coordinator's own segment store otherwise), the "
            "statement response carries segment URIs, and clients fetch "
            "them in parallel — the coordinator leaves the data path "
            "(reference: Trino 455's spooled client protocol)",
            bool, False,
        ),
        PropertyMetadata(
            "spooled_results_threshold_bytes",
            "estimated result bytes at/above which an enabled spooled-"
            "results query answers with a segment manifest; smaller "
            "results stay inline (the protocol decision, not a cap)",
            int, 8 << 20, _positive,
        ),
        PropertyMetadata(
            "spooled_results_segment_bytes",
            "target serialized bytes per spooled result segment — the "
            "unit of client-side parallel fetch (reference role: the "
            "spooled protocol's segment sizing)",
            int, 8 << 20, _positive,
        ),
        PropertyMetadata(
            "result_segment_ttl_ms",
            "lifetime of an un-acked spooled result segment in "
            "milliseconds; client acks (DELETE /v1/segment/{id}) delete "
            "sooner, the TTL bounds the leak when a client vanishes "
            "mid-fetch",
            int, 300_000, _positive,
        ),
        PropertyMetadata(
            "inline_result_max_bytes",
            "hard cap on result bytes the coordinator will materialize "
            "in process memory for the inline protocol: over it, the "
            "query auto-spools when spooled_results_enabled, else FAILS "
            "loudly (one export query must not OOM the dispatch plane)",
            int, 256 << 20, _positive,
        ),
        PropertyMetadata(
            "materialized_view_substitution",
            "transparently rewrite query plan subtrees that match a "
            "FRESH registered materialized view's definition (canonical "
            "plan fingerprint, exact or select-item-prefix) into a scan "
            "of the precomputed storage table (trino_tpu/matview/); a "
            "stale view always falls back to the base plan — never "
            "wrong rows",
            bool, True,
        ),
        PropertyMetadata(
            "materialized_view_refresh_on_create",
            "run the initial REFRESH as part of CREATE MATERIALIZED "
            "VIEW so the view is born fresh; false registers the "
            "definition only (the first REFRESH populates it)",
            bool, True,
        ),
        PropertyMetadata(
            "materialized_view_storage_catalog",
            "catalog hosting materialized-view storage tables when the "
            "view's own catalog is not writable (e.g. a view over the "
            "immutable tpch generator); must support CREATE TABLE",
            str, "memory",
        ),
        PropertyMetadata(
            "resource_group",
            "admission routing hint matched by resource-group selectors' "
            "session_property field (server/resource_groups.py): a "
            "selector configured on this property routes the query into "
            "its named group subtree before user/source matching is "
            "consulted; empty means only user/source selectors apply",
            str, "",
        ),
        PropertyMetadata(
            "failure_injection",
            "inject a task failure when this substring matches a task id, "
            "e.g. '.<fragment>.<worker>.a<attempt>' (reference: "
            "FailureInjector.java:41-69; test-only)",
            str, "",
        ),
        PropertyMetadata(
            "straggler_multiple",
            "flow-ledger straggler detector sensitivity: a task is "
            "flagged when its elapsed exceeds this multiple of its "
            "stage's median task elapsed (obs/flowledger.py; read "
            "surfaces: system.runtime.stragglers, "
            "GET /v1/query/{id}/flows, EXPLAIN ANALYZE)",
            float, 3.0,
        ),
    ]
}


def validate_property(name: str, value: Any) -> Any:
    """Coerce + validate one property; raises ValueError with the known-name
    list on unknown properties (the reference's 'Session property X does not
    exist' error)."""
    meta = SYSTEM_SESSION_PROPERTIES.get(name)
    if meta is None:
        known = ", ".join(sorted(SYSTEM_SESSION_PROPERTIES))
        raise ValueError(f"session property '{name}' does not exist (known: {known})")
    if value is None:
        if meta.default is None:
            return None
        raise ValueError(f"session property '{name}' cannot be null")
    if meta.py_type is bool and isinstance(value, str):
        if value.lower() in ("true", "1"):
            value = True
        elif value.lower() in ("false", "0"):
            value = False
        else:
            raise ValueError(f"session property '{name}': expected boolean, got {value!r}")
    elif meta.py_type is int and isinstance(value, str):
        try:
            value = int(value)
        except ValueError:
            raise ValueError(f"session property '{name}': expected integer, got {value!r}")
    elif meta.py_type is float and isinstance(value, (str, int)):
        try:
            value = float(value)
        except ValueError:
            raise ValueError(f"session property '{name}': expected number, got {value!r}")
    if not isinstance(value, meta.py_type):
        raise ValueError(
            f"session property '{name}': expected {meta.py_type.__name__},"
            f" got {type(value).__name__}"
        )
    if meta.validate is not None:
        err = meta.validate(value)
        if err:
            raise ValueError(f"session property '{name}': {err}")
    return value


def defaulted(properties: Dict[str, Any]) -> Dict[str, Any]:
    """Validated property map with registry defaults filled in."""
    out = {
        name: meta.default
        for name, meta in SYSTEM_SESSION_PROPERTIES.items()
        if meta.default is not None
    }
    for k, v in properties.items():
        out[k] = validate_property(k, v)
    return out
