"""Black-hole connector: swallow writes, serve empty scans (a copy of
trino_tpu/connector/blackhole/connector.py).

Reference: ``plugin/trino-blackhole`` (2.2k LoC) — the null sink/source used
to benchmark write paths and exercise DDL/DML without storage. Tables keep
metadata only; INSERT counts rows and discards them; scans return zero rows.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import spi
from trino_tpu_torch.data.dictionary import Dictionary


class BlackHoleConnector(spi.Connector):
    name = "blackhole"

    def __init__(self):
        self._tables: Dict[Tuple[str, str], spi.TableMetadata] = {}
        self.rows_swallowed = 0

    def create_table(self, schema: str, name: str, schema_def, rows) -> None:
        self._tables[(schema, name)] = spi.TableMetadata(
            schema, name, [spi.ColumnMetadata(n, t) for n, t in schema_def]
        )
        self.rows_swallowed += len(rows)

    def insert_rows(self, schema: str, table: str, rows) -> int:
        if (schema, table) not in self._tables:
            raise KeyError(f"blackhole.{schema}.{table} does not exist")
        self.rows_swallowed += len(rows)
        return len(rows)

    def drop_table(self, schema: str, table: str) -> None:
        self._tables.pop((schema, table), None)

    def list_schemas(self) -> List[str]:
        return sorted({s for s, _ in self._tables} | {"default"})

    def list_tables(self, schema: str) -> List[str]:
        return sorted(n for s, n in self._tables if s == schema)

    def get_table(self, schema: str, table: str) -> Optional[spi.TableMetadata]:
        return self._tables.get((schema, table))

    def table_row_count(self, schema: str, table: str) -> Optional[int]:
        return 0 if (schema, table) in self._tables else None

    def data_version(self, schema: str, table: str) -> str:
        # scans always return zero rows regardless of writes swallowed
        return "immutable"

    def get_splits(self, schema: str, table: str, target_splits: int, constraint=None,
                   handle=None) -> List[spi.Split]:
        return [spi.Split(table, schema, 0, 0)]

    def scan(self, split: spi.Split, columns: List[str], constraint=None) -> Dict[str, spi.ColumnData]:
        meta = self._tables[(split.schema, split.table)]
        out = {}
        for c in columns:
            t = meta.columns[meta.column_index(c)].type
            out[c] = spi.ColumnData(
                t,
                np.empty(0, dtype=t.np_dtype or np.dtype(np.int64)),
                None,
                Dictionary([]) if t.is_varchar else None,
            )
        return out
