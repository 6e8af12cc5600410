"""Materialized-view registry: the coordinator-owned metadata store (a
copy of trino_tpu/matview/registry.py).

Reference: the reference engine's materialized views live in connector
metadata (``ConnectorMetadata.getMaterializedView`` returning a
``ConnectorMaterializedViewDefinition`` + ``getMaterializedViewFreshness``
deciding staleness); here the engine owns one registry per server —
shared by every query the coordinator runs (like the prepared-statement
registry). The reference also replicates it across its executor-process
plane; the port has no process plane, and ``to_payload`` /
``from_payload`` keep the payload format that replication ships.

Each entry records everything the transparent-substitution pass
(``matview/substitute.py``) needs to decide *match* and *freshness*
without re-planning the definition:

- the **canonical plan fingerprint** of the optimized defining query
  (``cache/plan_key.canonicalize_plan``), recomputed at every REFRESH so
  it reflects the catalog state the stored rows were computed from —
  plus canonicals for each select-item *prefix* of the definition (the
  projection-subsumption stretch match);
- the **base-table data versions** captured when the REFRESH planned
  (before it executed — a mid-refresh mutation makes the view stale,
  never wrong);
- the **storage version** of the backing table after the atomic swap, so
  an out-of-band mutation (or DROP) of the storage suppresses
  substitution too.

The registry is pure metadata: it imports no torch.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class MaterializedView:
    """One registered materialized view (metadata only; rows live in the
    storage table behind the connector write SPI)."""

    catalog: str
    schema: str
    name: str
    definition_sql: str            # the defining query's SQL text
    definition: object             # parsed ast.Query
    owner: str                     # creating principal
    # name resolution defaults captured at CREATE: unqualified tables in
    # the definition must keep resolving against the CREATOR's defaults,
    # whatever session later expands or refreshes the view
    default_catalog: str = "tpch"
    default_schema: str = "tiny"
    storage_catalog: str = ""
    storage_schema: str = ""
    storage_table: str = ""
    column_names: Tuple[str, ...] = ()
    column_types: tuple = ()       # engine Type objects, definition order
    base_tables: Tuple[tuple, ...] = ()   # ((catalog, schema, table), ...)
    # canonical plan string of the optimized definition (match key) and
    # the prefix-projection variants: canonical -> column prefix width
    canonical: Optional[str] = None
    prefix_canonicals: Dict[str, int] = dataclasses.field(default_factory=dict)
    # freshness state, written atomically at REFRESH
    base_versions: Optional[tuple] = None   # (((c, s, t), version), ...)
    storage_version: Optional[str] = None
    last_refresh: Optional[float] = None
    created_at: float = dataclasses.field(default_factory=time.time)
    hits: int = 0
    refreshes: int = 0

    @property
    def qualified(self) -> str:
        return f"{self.catalog}.{self.schema}.{self.name}"

    @property
    def storage_qualified(self) -> str:
        return (f"{self.storage_catalog}.{self.storage_schema}"
                f".{self.storage_table}")


class MaterializedViewRegistry:
    """Thread-safe (catalog, schema, name) -> MaterializedView map.

    Server-wide like the prepared-statement registry: CREATE on one query
    is substitutable by the next, whatever lane/thread runs it. Embedded
    sessions get a private instance (client/session.py)."""

    def __init__(self):
        self._entries: Dict[tuple, MaterializedView] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(catalog: str, schema: str, name: str) -> tuple:
        return (catalog.lower(), schema.lower(), name.lower())

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def empty(self) -> bool:
        with self._lock:
            return not self._entries

    def put(self, mv: MaterializedView) -> None:
        with self._lock:
            self._entries[self._key(mv.catalog, mv.schema, mv.name)] = mv

    def get(self, catalog: str, schema: str, name: str
            ) -> Optional[MaterializedView]:
        with self._lock:
            return self._entries.get(self._key(catalog, schema, name))

    def remove(self, catalog: str, schema: str, name: str
               ) -> Optional[MaterializedView]:
        with self._lock:
            return self._entries.pop(self._key(catalog, schema, name), None)

    def snapshot(self) -> List[MaterializedView]:
        """Entry list sorted by qualified name (system-table row order)."""
        with self._lock:
            return [self._entries[k] for k in sorted(self._entries)]

    def record_hit(self, catalog: str, schema: str, name: str) -> None:
        with self._lock:
            mv = self._entries.get(self._key(catalog, schema, name))
            if mv is not None:
                mv.hits += 1

    def publish_refresh(self, mv: MaterializedView, base_versions,
                        storage_version: str, canonical: str,
                        prefix_canonicals: Dict[str, int]) -> None:
        """The REFRESH commit point: one locked write flips the match
        keys and the freshness evidence together, so a concurrent
        substitution sees either the pre-refresh state (stale -> falls
        back) or the complete post-refresh state — never a torn mix."""
        with self._lock:
            mv.base_versions = tuple(base_versions)
            mv.base_tables = tuple(tuple(k) for k, _v in base_versions)
            mv.storage_version = str(storage_version)
            mv.canonical = canonical
            mv.prefix_canonicals = dict(prefix_canonicals)
            mv.last_refresh = time.time()
            mv.refreshes += 1


# ------------------------------------------------- cross-process payload
def to_payload(mv: MaterializedView) -> dict:
    """JSON-shaped registry entry for the executor-process sync procedure
    (``CALL system.runtime.sync_materialized_view('<json>')``). Column
    types serialize as their SQL spellings; the definition ships as SQL
    and re-parses on the receiving side."""
    return {
        "op": "put",
        "catalog": mv.catalog, "schema": mv.schema, "name": mv.name,
        "definitionSql": mv.definition_sql,
        "owner": mv.owner,
        "defaultCatalog": mv.default_catalog,
        "defaultSchema": mv.default_schema,
        "storageCatalog": mv.storage_catalog,
        "storageSchema": mv.storage_schema,
        "storageTable": mv.storage_table,
        "columnNames": list(mv.column_names),
        "columnTypes": [str(t) for t in mv.column_types],
        "baseTables": [list(t) for t in mv.base_tables],
        "canonical": mv.canonical,
        "prefixCanonicals": dict(mv.prefix_canonicals),
        "baseVersions": ([[list(k), v] for k, v in mv.base_versions]
                         if mv.base_versions is not None else None),
        "storageVersion": mv.storage_version,
        "lastRefresh": mv.last_refresh,
        "createdAt": mv.created_at,
    }


def drop_payload(catalog: str, schema: str, name: str) -> dict:
    return {"op": "drop", "catalog": catalog, "schema": schema,
            "name": name}


def from_payload(payload: dict) -> MaterializedView:
    from trino_tpu_torch import types as T
    from trino_tpu_torch.sql.parser import ast
    from trino_tpu_torch.sql.parser.parser import parse_statement

    definition = parse_statement(payload["definitionSql"])
    if isinstance(definition, ast.CreateMaterializedView):
        # definition_sql kept the FULL statement text (a shape the
        # prefix-stripping regex could not take apart): unwrap the query
        definition = definition.query
    return MaterializedView(
        catalog=payload["catalog"], schema=payload["schema"],
        name=payload["name"],
        definition_sql=payload["definitionSql"],
        definition=definition,
        owner=payload.get("owner", "anonymous"),
        default_catalog=payload.get("defaultCatalog", "tpch"),
        default_schema=payload.get("defaultSchema", "tiny"),
        storage_catalog=payload["storageCatalog"],
        storage_schema=payload["storageSchema"],
        storage_table=payload["storageTable"],
        column_names=tuple(payload.get("columnNames") or ()),
        column_types=tuple(
            T.parse_type(t) for t in payload.get("columnTypes") or ()),
        base_tables=tuple(
            tuple(t) for t in payload.get("baseTables") or ()),
        canonical=payload.get("canonical"),
        prefix_canonicals={
            str(k): int(v)
            for k, v in (payload.get("prefixCanonicals") or {}).items()},
        base_versions=(
            tuple((tuple(k), v) for k, v in payload["baseVersions"])
            if payload.get("baseVersions") is not None else None),
        storage_version=payload.get("storageVersion"),
        last_refresh=payload.get("lastRefresh"),
        created_at=payload.get("createdAt") or time.time(),
    )
