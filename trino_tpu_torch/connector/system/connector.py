"""System catalog connector: SQL-queryable runtime introspection.

Reference: ``core/trino-main/.../connector/system/`` — the ``system``
catalog whose ``system.runtime.queries/tasks/nodes`` tables are fed LIVE
from coordinator state (``QuerySystemTable``, ``TaskSystemTable``,
``NodeSystemTable``), plus the ``jmx`` connector's every-metric-as-a-
relation role collapsed into ``system.metrics``. Rows materialize at SCAN
time through a :class:`~trino_tpu_torch.connector.spi.LiveTableProvider` the
owning server injects (``server/system_tables.py``); without a provider
(standalone sessions, worker processes) the runtime tables are empty and
``system.metrics`` falls back to this process's own registry — the
metadata surface (SHOW TABLES, information_schema) works everywhere.

Cache interaction: ``data_version`` returns None (live tables are
unversioned ⇒ plan/result caches never admit them, and the device cache
stages them afresh on every scan) and the determinism machinery
(``cache/determinism.py``) additionally flags any ``system`` scan as
uncachable, so introspection queries are provably never served stale.

The port of trino_tpu/connector/system/connector.py: a scan returns host
columns (``column_data_from_python``), which the executor stages onto the
session's device (the card unless the session asks for the CPU).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import spi
from trino_tpu_torch.connector.system.schemas import (
    SYSTEM_CATALOG, SYSTEM_PROCEDURES, SYSTEM_TABLES)

__all__ = ["SystemConnector", "SYSTEM_CATALOG", "SYSTEM_TABLES",
           "SYSTEM_PROCEDURES", "device_cache_rows", "metric_sample_rows"]


def device_cache_rows() -> List[tuple]:
    """THIS process's staged-table cache entries as
    ``system.runtime.device_cache`` rows (column order:
    connector/system/schemas.py): the warm-HBM pool (tier='hbm') plus the
    host-RAM columnar tier under it (tier='host'). The pools are
    process-global, so the coordinator provider and the providerless
    fallback (a standalone session, or a worker inspecting itself) share
    this one materializer."""
    from trino_tpu_torch.devcache import DEVICE_CACHE, HOST_CACHE

    return [
        (e["catalog"], e["schema"], e["table"], e["version"], e["shard"],
         e["signature"], int(e["bytes"]), int(e["rows"]), int(e["hits"]),
         float(e["createdAt"]), float(e["lastUsedAt"]), tier)
        for tier, pool in (("hbm", DEVICE_CACHE), ("host", HOST_CACHE))
        for e in pool.snapshot()
    ]


def metric_sample_rows() -> List[tuple]:
    """Every touched series of this process's typed registry as
    ``(name, type, labels, value, help)`` rows — histogram buckets expand
    to ``_bucket``/``_sum``/``_count`` rows exactly like the Prometheus
    exposition (obs/metrics.registry_samples)."""
    from trino_tpu_torch.obs.metrics import registry_samples

    def render_labels(labels: Dict[str, str]) -> Optional[str]:
        if not labels:
            return None
        return ",".join(f'{k}="{v}"' for k, v in labels.items())

    return [
        (name, type_name, render_labels(labels), float(value), help_text)
        for name, type_name, labels, value, help_text in registry_samples()
    ]


class SystemConnector(spi.Connector):
    name = "system"
    # live state exists only on the process that injected the provider
    # (the coordinator): scans must never be distributed to workers
    coordinator_only = True
    # the metrics schema holds exactly one relation named like the schema,
    # so the two-part spelling ``system.metrics`` resolves through the
    # planner's single-table-schema fallback (gated on this declaration)
    single_table_schemas = True

    def __init__(self, provider: Optional[spi.LiveTableProvider] = None):
        self._provider = provider
        self._metadata: Dict[tuple, spi.TableMetadata] = {}
        for (schema, table), columns in SYSTEM_TABLES.items():
            self._metadata[(schema, table)] = spi.TableMetadata(
                schema, table,
                [spi.ColumnMetadata(n, T.parse_type(t)) for n, t in columns])

    # ----------------------------------------------------------- SPI hooks
    def attach_live_provider(self, provider: spi.LiveTableProvider) -> None:
        self._provider = provider

    def procedure(self, schema: str, name: str):
        if (schema, name) not in SYSTEM_PROCEDURES:
            return None
        if self._provider is None:
            raise ValueError(
                f"procedure system.{schema}.{name} requires a coordinator "
                "(no live provider attached in this process)")
        return self._provider.procedure(schema, name)

    # ------------------------------------------------------------ metadata
    def list_schemas(self) -> List[str]:
        return sorted({s for s, _ in SYSTEM_TABLES})

    def list_tables(self, schema: str) -> List[str]:
        return sorted(t for s, t in SYSTEM_TABLES if s == schema)

    def get_table(self, schema: str, table: str) -> Optional[spi.TableMetadata]:
        return self._metadata.get((schema, table))

    def data_version(self, schema: str, table: str) -> Optional[str]:
        # live tables are unversioned BY DESIGN: the plan and result caches
        # cannot revalidate them, so every introspection query re-snapshots
        return None

    # --------------------------------------------------------------- scan
    def get_splits(self, schema: str, table: str, target_splits: int,
                   constraint=None, handle=None) -> List[spi.Split]:
        if (schema, table) not in SYSTEM_TABLES:
            raise KeyError(f"system.{schema}.{table} does not exist")
        # ONE split always: the snapshot happens at scan time, and a table
        # this size (metadata scale) gains nothing from parallel scans
        # while a multi-split scan would stitch two different instants
        return [spi.Split(table, schema, 0, 0)]

    def _rows(self, schema: str, table: str) -> List[tuple]:
        if self._provider is not None:
            return self._provider.snapshot_rows(schema, table)
        if (schema, table) == ("metrics", "metrics"):
            return metric_sample_rows()
        if (schema, table) == ("runtime", "device_cache"):
            # the cache pool is process-global: even without a live
            # provider a session can inspect its own process's entries
            return device_cache_rows()
        if (schema, table) == ("runtime", "memory"):
            # the memory ledger is process-global too: a providerless
            # session reads its own process's owner rows
            from trino_tpu_torch.obs.memledger import MEMORY_LEDGER

            nid = MEMORY_LEDGER.node_id or "local"
            return [(nid, r["pool"], r["owner"], int(r["bytes"]),
                     int(r["peakBytes"]), int(r["events"]))
                    for r in MEMORY_LEDGER.owner_rows()]
        return []

    def scan(self, split: spi.Split, columns: List[str],
             constraint=None) -> Dict[str, spi.ColumnData]:
        """The snapshot's rows as host columns; the executor stages them
        onto the session's device, as every connector's scan."""
        from trino_tpu_torch.data.page import column_data_from_python

        meta = self._metadata[(split.schema, split.table)]
        rows = self._rows(split.schema, split.table)
        index = {c.name: i for i, c in enumerate(meta.columns)}
        out: Dict[str, spi.ColumnData] = {}
        for c in columns:
            i = index[c]
            out[c] = column_data_from_python(meta.columns[i].type, [r[i] for r in rows])
        return out
