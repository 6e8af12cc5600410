"""In-memory tables connector: the port of
trino_tpu/connector/memory/connector.py.

Tables live on the host as ``ColumnData`` built from Python rows (CREATE
TABLE AS, INSERT and the engine-computed DELETE/UPDATE rewrites) and are
served as single- or multi-split scans; they reach the device only through
staging. Every mutation bumps the table's ``data_version``, which is what
keeps the device and host caches correct.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import spi
from trino_tpu_torch.data.page import column_data_from_python


class MemoryConnector(spi.Connector):
    name = "memory"
    coordinator_only = True  # tables live in this process only
    supports_transactions = True  # overlay protocol (exec/transaction.py)

    def __init__(self):
        self._tables: Dict[Tuple[str, str], Tuple[spi.TableMetadata, Dict[str, spi.ColumnData]]] = {}
        # monotonic per-table mutation counter (the cache-invalidation
        # token): survives DROP so a re-created table keeps advancing
        self._versions: Dict[Tuple[str, str], int] = {}

    def _bump(self, schema: str, table: str) -> None:
        key = (schema, table)
        self._versions[key] = self._versions.get(key, 0) + 1

    def data_version(self, schema: str, table: str) -> str:
        return f"v{self._versions.get((schema, table), 0)}"

    def create_table(self, schema: str, name: str, schema_def: Sequence[Tuple[str, T.Type]], rows: List[tuple]):
        """Register a table from Python rows (None = NULL)."""
        cols: Dict[str, spi.ColumnData] = {}
        for i, (cname, ctype) in enumerate(schema_def):
            cols[cname] = column_data_from_python(ctype, [r[i] for r in rows])
        meta = spi.TableMetadata(
            schema, name, [spi.ColumnMetadata(n, t) for n, t in schema_def]
        )
        self._tables[(schema, name)] = (meta, cols)
        self._bump(schema, name)

    def overwrite_rows(self, schema: str, table: str, rows) -> None:
        """Replace contents (engine-computed DELETE/UPDATE rewrite)."""
        entry = self._tables.get((schema, table))
        if entry is None:
            raise KeyError(f"memory.{schema}.{table} does not exist")
        meta, _cols = entry
        new_cols = {
            cm.name: column_data_from_python(cm.type, [r[i] for r in rows])
            for i, cm in enumerate(meta.columns)
        }
        self._tables[(schema, table)] = (meta, new_cols)
        self._bump(schema, table)

    def insert_rows(self, schema: str, table: str, rows: List[tuple]) -> int:
        """Append rows: the new data is columnized on its own and
        concatenated with a dictionary merge."""
        entry = self._tables.get((schema, table))
        if entry is None:
            raise KeyError(f"memory.{schema}.{table} does not exist")
        meta, cols = entry
        if not rows:
            return 0
        # build every new column before publishing: a failure part way
        # must not leave some columns longer than others
        new_cols = {}
        for i, cm in enumerate(meta.columns):
            new = column_data_from_python(cm.type, [r[i] for r in rows])
            new_cols[cm.name] = spi.concat_column_data([cols[cm.name], new])
        self._tables[(schema, table)] = (meta, {**cols, **new_cols})
        self._bump(schema, table)
        return len(rows)

    def drop_table(self, schema: str, table: str) -> None:
        self._tables.pop((schema, table), None)
        self._bump(schema, table)

    def list_schemas(self) -> List[str]:
        return sorted({s for s, _ in self._tables} | {"default"})

    def list_tables(self, schema: str) -> List[str]:
        return sorted(n for s, n in self._tables if s == schema)

    def get_table(self, schema: str, table: str) -> Optional[spi.TableMetadata]:
        entry = self._tables.get((schema, table))
        return entry[0] if entry else None

    def table_row_count(self, schema: str, table: str) -> Optional[int]:
        entry = self._tables.get((schema, table))
        if not entry:
            return None
        _, cols = entry
        first = next(iter(cols.values()), None)
        return 0 if first is None else len(first.values)

    def get_splits(self, schema: str, table: str, target_splits: int, constraint=None,
                   handle=None) -> List[spi.Split]:
        n = self.table_row_count(schema, table) or 0
        target_splits = max(1, min(target_splits, max(n, 1)))
        bounds = [n * i // target_splits for i in range(target_splits + 1)]
        return [
            spi.Split(table, schema, bounds[i], bounds[i + 1])
            for i in range(target_splits)
            if bounds[i] < bounds[i + 1] or n == 0
        ] or [spi.Split(table, schema, 0, 0)]

    def scan(self, split: spi.Split, columns: List[str], constraint=None) -> Dict[str, spi.ColumnData]:
        _, cols = self._tables[(split.schema, split.table)]
        out = {}
        for c in columns:
            out[c] = spi.column_data_slice(cols[c], split.lo, split.hi)
        return out
