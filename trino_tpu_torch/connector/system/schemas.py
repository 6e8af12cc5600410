"""System-catalog table schemas — the single source of truth
(a copy of trino_tpu/connector/system/schemas.py).

Reference: ``core/trino-main/.../connector/system/`` — every system table
declares its ``ConnectorTableMetadata`` statically (``QuerySystemTable``,
``TaskSystemTable``, ``NodeSystemTable``) while its ROWS materialize at
scan time from live coordinator state. Here the declarations live in a
dependency-free module (types as strings, parsed by the connector with
``T.parse_type``) so the docs drift gate (``tools/
check_system_table_docs.py``) can load them without pulling in jax, the
same standalone-file trick the metric and session-property gates use.

``SYSTEM_TABLES`` maps ``(schema, table)`` to an ordered column tuple of
``(name, type_string)``. The ``metrics`` schema follows the single-table-
schema convention (``metrics.metrics``) so the two-part spelling
``system.metrics`` resolves (sql/planner/planner.py's catalog fallback).
"""
from __future__ import annotations

SYSTEM_CATALOG = "system"

SYSTEM_TABLES = {
    # every query the coordinator tracks: live (QUEUED..RUNNING) from the
    # query registry, completed from the bounded history ring
    ("runtime", "queries"): (
        ("query_id", "varchar"),
        ("state", "varchar"),
        ("user", "varchar"),
        ("query", "varchar"),
        ("created_at", "double"),      # epoch seconds
        ("ended_at", "double"),        # epoch seconds; NULL while running
        ("elapsed_ms", "bigint"),
        ("device_seconds", "double"),
        ("total_splits", "bigint"),
        ("completed_splits", "bigint"),
        ("input_rows", "bigint"),
        ("output_bytes", "bigint"),
        ("peak_bytes", "bigint"),
        ("shed_bytes", "bigint"),      # revocable-cache bytes shed on this
                                       # query's behalf (memory ledger)
        ("yield_events", "bigint"),    # revocable-yield events (spill-path
                                       # cache yields) this query triggered
        ("result_rows", "bigint"),
        ("cache_status", "varchar"),   # HIT | MISS | BYPASS; NULL early
        ("adaptations", "bigint"),
        ("plan_versions", "bigint"),
        ("failure", "varchar"),
        ("fast_path", "varchar"),      # fast-path | distributed |
                                       # local-catalog; NULL for non-SELECT
                                       # and for SELECTs served straight
                                       # from the result cache (no
                                       # execution path was taken)
        # phase-ledger rollups (obs/timeline.py), computed at completion
        # from the merged span tree; NULL while the query still runs.
        # planning = dispatch + parse-analyze + plan-optimize +
        # prepare-bind; execution = schedule + device-staging +
        # device-execute + exchange-wait + result-serialization; the
        # full per-phase breakdown rides queryStats.timeline.
        ("queued_ms", "double"),
        ("planning_ms", "double"),
        ("execution_ms", "double"),
        ("unattributed_ms", "double"),
        ("resource_group", "varchar"),  # full dotted group path that
                                        # admitted the query; NULL under
                                        # a legacy injected flat gate
    ),
    # the resource-group admission tree (server/resource_groups.py): one
    # row per live group node — limits from the validated config, live
    # occupancy/queue depth, the ledger-backed memory rollup, and the
    # fairness knobs (weight, cache_share, queue_timeout_ms)
    ("runtime", "resource_groups"): (
        ("name", "varchar"),            # full dotted path (global.adhoc.u1)
        ("state", "varchar"),           # can-run | full | blocked-memory
        ("queued", "bigint"),
        ("running", "bigint"),          # subtree rollup
        ("served", "bigint"),           # concurrency-free serving-index hits
        ("hard_concurrency_limit", "bigint"),
        ("max_queued", "bigint"),
        ("memory_limit_bytes", "bigint"),   # NULL = unlimited
        ("memory_bytes", "bigint"),     # live ledger bytes of running queries
        ("weight", "bigint"),           # weighted-fair drain share
        ("cache_share", "double"),      # carve-out fraction; NULL = none
        ("queue_timeout_ms", "bigint"),  # aging deadline; NULL = never
    ),
    # prepared statements held by the coordinator registry
    # (server/prepared.py): one row per (user, name), live until
    # DEALLOCATE or LRU eviction
    ("runtime", "prepared_statements"): (
        ("user", "varchar"),
        ("name", "varchar"),
        ("statement", "varchar"),      # the inner (post-FROM) SQL text
        ("parameters", "bigint"),      # number of ? markers
        ("created_at", "double"),      # epoch seconds
        ("executions", "bigint"),
        ("last_executed_at", "double"),  # epoch seconds; NULL before first
    ),
    # the serving plane's shared-state ownership table (server/
    # dispatch.py): one row per shared structure of the dispatch/executor
    # split — which process owns it, in which plane mode, and how full
    # it is — so the ownership story is introspectable over SQL
    ("runtime", "serving"): (
        ("structure", "varchar"),      # dispatch_queue | executor_lanes
                                       # | serving_index | result_cache |
                                       # plan_cache | prepared_statements
                                       # | materialized_views
                                       # | query_registry | query_history
                                       # | device
        ("owner", "varchar"),          # dispatch-process |
                                       # executor-process (sticky shard)
        ("plane", "varchar"),          # thread | process
        ("entries", "bigint"),         # occupancy (NULL where not sized)
        ("bytes", "bigint"),           # byte footprint (NULL unknown)
        ("detail", "varchar"),         # capacity / ownership note
    ),
    # per-slot task records of live queries (worker-reported stats rollup)
    ("runtime", "tasks"): (
        ("query_id", "varchar"),
        ("task_id", "varchar"),
        ("stage_id", "bigint"),
        ("state", "varchar"),
        ("worker_uri", "varchar"),
        ("total_splits", "bigint"),
        ("completed_splits", "bigint"),
        ("input_rows", "bigint"),
        ("output_rows", "bigint"),
        ("output_bytes", "bigint"),
        ("peak_bytes", "bigint"),
        ("elapsed_seconds", "double"),
        ("device_seconds", "double"),
        ("operators", "bigint"),       # distinct plan nodes with stats
    ),
    # discovery registry + the workers' announce payloads
    ("runtime", "nodes"): (
        ("node_id", "varchar"),
        ("http_uri", "varchar"),
        ("state", "varchar"),          # active | dead (announce aged out)
        ("version", "varchar"),
        ("tasks", "bigint"),
        ("memory_used_bytes", "bigint"),
        ("memory_limit_bytes", "bigint"),
        ("device_memory_bytes", "bigint"),  # announced HBM capacity; NULL
                                            # when not discoverable (CPU)
        ("device_cache_bytes", "bigint"),   # warm-table bytes (revocable)
        ("heartbeat_age_ms", "bigint"),
        ("host_cache_bytes", "bigint"),     # host-RAM columnar tier bytes
                                            # (second revocable tier —
                                            # sheds before the HBM tier)
        ("host_cache_hits", "bigint"),      # lifetime host-tier hits
        ("net_bytes_sent", "bigint"),       # flow-ledger lifetime bytes
                                            # sent across every link
        ("net_bytes_received", "bigint"),   # ...and received
    ),
    # the staged-table caches (trino_tpu/devcache/): one row per resident
    # entry of THIS process's pools — the warm-HBM tier (tier='hbm') and
    # the host-RAM columnar tier under it (tier='host', per-split decoded
    # column sets) — the coordinator's when a provider is attached; any
    # process can inspect its own
    ("runtime", "device_cache"): (
        ("catalog", "varchar"),
        ("schema_name", "varchar"),
        ("table_name", "varchar"),
        ("data_version", "varchar"),
        ("shard", "varchar"),          # table | splits:N:... | spmd:N |
                                       # host:splits:1:... (host tier)
        ("signature", "varchar"),      # projection/pruning digest
        ("entry_bytes", "bigint"),
        ("rows", "bigint"),
        ("hits", "bigint"),
        ("created_at", "double"),      # epoch seconds
        ("last_used_at", "double"),
        ("tier", "varchar"),           # hbm | host
    ),
    # the cluster memory ledger (trino_tpu/obs/memledger.py): one row per
    # (node, pool, owner) — live attributed bytes, the owner's peak, and
    # how many ledger events it produced. Owners: query:<id> |
    # device-cache | host-cache | staging | mv-storage | total (the
    # per-pool watermark row, so attribution coverage = sum(named owners)
    # / total is computable from this table alone). Coordinator rows come
    # from its own process ledger; worker rows ride the announce payload.
    ("runtime", "memory"): (
        ("node_id", "varchar"),
        ("pool", "varchar"),           # device | host
        ("owner", "varchar"),
        ("bytes", "bigint"),           # live attributed bytes
        ("peak_bytes", "bigint"),      # this owner's high-water mark
        ("events", "bigint"),          # ledger events this owner produced
    ),
    # the kernel ledger (trino_tpu/obs/devprofiler.py): one row per
    # (query, plan node, operator, tier, node) — device dispatches with
    # wall vs device seconds split, so dispatch overhead is an explicit
    # per-operator number. Terminal queries read the folded profiler
    # store; RUNNING queries merge their live task rollups.
    ("runtime", "kernels"): (
        ("query_id", "varchar"),
        ("node_id", "varchar"),        # worker uri or "coordinator"
        ("plan_node_id", "varchar"),
        ("operator", "varchar"),       # TableScan | Join | CompiledBody...
        ("tier", "varchar"),           # eager | compiled | spmd
        ("launches", "bigint"),
        ("wall_seconds", "double"),
        ("device_seconds", "double"),  # measured under device_profiling,
                                       # estimated from wall otherwise
        ("dispatch_overhead_seconds", "double"),  # wall − device
        ("input_bytes", "bigint"),
        ("output_bytes", "bigint"),
        ("estimated", "boolean"),      # true = no-sync estimate
    ),
    # the compile ledger (trino_tpu/obs/devprofiler.py): one row per
    # jit/Pallas compile event cluster-wide — plan fingerprint + shape
    # signature name WHAT compiled, cache says hit or miss. Worker rows
    # ride the announce payload (compileEvents); coordinator rows come
    # from its own process ring.
    ("runtime", "compiles"): (
        ("node_id", "varchar"),
        ("query_id", "varchar"),       # empty for bench/local compiles
        ("tier", "varchar"),           # eager | compiled | spmd
        ("fingerprint", "varchar"),    # plan fingerprint (cache/plan_key)
        ("shape_signature", "varchar"),
        ("compile_seconds", "double"),
        ("cache", "varchar"),          # hit | miss
        ("created_at", "double"),      # epoch seconds
    ),
    # the data-plane flow ledger (trino_tpu/obs/flowledger.py): one row
    # per (node, link, owner) transfer rollup — bytes in motion typed by
    # link class (exchange-pull | spool-write | segment-fetch |
    # staging-transfer | client-drain | control) with derived effective
    # MB/s. Worker rows ride the announce payload (flows); coordinator
    # rows come from its own process ledger (announce rows win for a
    # shared in-process ledger).
    ("runtime", "transfers"): (
        ("node_id", "varchar"),
        ("link", "varchar"),           # link class (see above)
        ("owner", "varchar"),          # task:<id> | query:<id> |
                                       # drain:<id> | staging | control
        ("bytes", "bigint"),
        ("pages", "bigint"),
        ("transfers", "bigint"),       # records folded into this row
        ("seconds", "double"),         # transfer wall attributed here
        ("mb_per_s", "double"),        # bytes/seconds; NULL if no wall
        ("retries", "bigint"),
        ("last_status", "varchar"),    # last HTTP status / path marker
    ),
    # the straggler detector (trino_tpu/obs/flowledger.py): one row per
    # flagged task — elapsed exceeded the configurable multiple of its
    # stage median (straggler_multiple session property), attributed to
    # its dominant cause (transfer-bound | device-bound | queue-bound).
    # RUNNING queries detect live; terminal queries read frozen verdicts.
    ("runtime", "stragglers"): (
        ("query_id", "varchar"),
        ("stage_id", "bigint"),
        ("task_id", "varchar"),
        ("worker_uri", "varchar"),
        ("elapsed_seconds", "double"),
        ("stage_median_seconds", "double"),
        ("ratio", "double"),           # elapsed / stage median
        ("multiple", "double"),        # threshold multiple in force
        ("cause", "varchar"),          # dominant ledger seconds bucket
        ("completed_splits", "bigint"),
    ),
    # registered materialized views (trino_tpu/matview/): definitions,
    # storage location, and LIVE freshness (recomputed at scan time from
    # the connectors' current data versions vs the versions recorded at
    # the last REFRESH)
    ("metadata", "materialized_views"): (
        ("catalog", "varchar"),
        ("schema_name", "varchar"),
        ("name", "varchar"),
        ("owner", "varchar"),
        ("definition", "varchar"),      # the defining query's SQL text
        ("storage_table", "varchar"),   # catalog.schema.table holding rows
        ("fresh", "boolean"),           # substitutable right now?
        ("stale_reason", "varchar"),    # NULL when fresh
        ("last_refresh", "double"),     # epoch seconds; NULL never run
        ("base_versions", "varchar"),   # c.s.t@version, ... at REFRESH
        ("hit_count", "bigint"),        # plans substituted so far
        ("refresh_count", "bigint"),
    ),
    # every touched series of the typed metrics registry as rows — the jmx
    # connector's role; /v1/metrics stays the Prometheus surface
    ("metrics", "metrics"): (
        ("name", "varchar"),
        ("type", "varchar"),           # counter | gauge | histogram
        ("labels", "varchar"),         # k="v",... rendered label set
        ("value", "double"),
        ("help", "varchar"),
    ),
}

# procedures the system connector registers (CALL surface); listed here so
# the docs gate can require each to be documented alongside the tables
SYSTEM_PROCEDURES = (
    ("runtime", "kill_query"),
    ("runtime", "sync_materialized_view"),
)
