"""TPC-DS connector: schemas tiny/sf1/... over the stateless generator.

Reference: ``plugin/trino-tpcds`` (TpcdsMetadata exposes tiny/sf1/sf100/...
schemas; TpcdsSplitManager splits tables into row ranges). Splits here are
row ranges (order/ticket ranges for the sales/returns fact tables), each
generated independently — the same coordination-free split design as the
tpch connector.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import spi
from trino_tpu_torch.connector.tpcds import generator as gen
from trino_tpu_torch.connector.tpch.connector import schema_scale_factor


class TpcdsConnector(spi.Connector):
    name = "tpcds"

    def list_schemas(self) -> List[str]:
        return ["tiny", "sf1", "sf10", "sf100"]

    def list_tables(self, schema: str) -> List[str]:
        schema_scale_factor(schema)
        return list(gen.SCHEMAS)

    def get_table(self, schema: str, table: str) -> Optional[spi.TableMetadata]:
        try:
            schema_scale_factor(schema)
        except KeyError:
            return None
        if table not in gen.SCHEMAS:
            return None
        cols = [spi.ColumnMetadata(n, T.parse_type(t)) for n, t in gen.SCHEMAS[table]]
        return spi.TableMetadata(schema, table, cols)

    def table_row_count(self, schema: str, table: str) -> Optional[int]:
        return gen.table_row_count(table, schema_scale_factor(schema))

    def column_stats(self, schema: str, table: str, column: str):
        sf = schema_scale_factor(schema)
        probe = gen.generate(table, sf, 0, 1, [column])
        vr = probe[column].vrange
        if vr is None:
            return None
        return spi.ColumnStats(low=vr[0], high=vr[1])

    _PRIMARY_KEYS = {
        "date_dim": ["d_date_sk"],
        "income_band": ["ib_income_band_sk"],
        "household_demographics": ["hd_demo_sk"],
        "customer_demographics": ["cd_demo_sk"],
        "customer_address": ["ca_address_sk"],
        "customer": ["c_customer_sk"],
        "item": ["i_item_sk"],
        "store": ["s_store_sk"],
        "warehouse": ["w_warehouse_sk"],
        "web_site": ["web_site_sk"],
        "promotion": ["p_promo_sk"],
    }

    def primary_key(self, schema: str, table: str):
        return self._PRIMARY_KEYS.get(table)

    def data_version(self, schema: str, table: str) -> str:
        # generated data is a pure function of (table, scale factor)
        return "immutable"

    def get_splits(
        self, schema: str, table: str, target_splits: int, constraint=None,
        handle=None,
    ) -> List[spi.Split]:
        sf = schema_scale_factor(schema)
        n = gen.order_range_count(table, sf)
        k = max(1, min(max(target_splits, 1), n))
        bounds = [n * i // k for i in range(k + 1)]
        return [
            spi.Split(table, schema, bounds[i], bounds[i + 1])
            for i in range(k)
            if bounds[i] < bounds[i + 1]
        ]

    def scan(self, split: spi.Split, columns: List[str], constraint=None) -> Dict[str, spi.ColumnData]:
        sf = schema_scale_factor(split.schema)
        out = gen.generate(split.table, sf, split.lo, split.hi, columns)
        return {c: out[c] for c in columns}
