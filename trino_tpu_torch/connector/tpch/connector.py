"""TPC-H connector: schemas tiny/sf1/sf10/... over the stateless generator.

Reference: ``plugin/trino-tpch`` (TpchMetadata.java:99 exposes schemas
tiny/sf1/sf100/... whose scale factor is parsed from the schema name;
TpchSplitManager splits by part ranges). Splits here are row ranges (order
ranges for orders/lineitem), each generated independently.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.connector import spi
from trino_tpu_torch.connector.tpch import generator as gen

_SCHEMA_SF = {
    "tiny": 0.01,
    "sf1": 1.0,
    "sf10": 10.0,
    "sf100": 100.0,
    "sf300": 300.0,
    "sf1000": 1000.0,
}


def schema_scale_factor(schema: str) -> float:
    if schema in _SCHEMA_SF:
        return _SCHEMA_SF[schema]
    if schema.startswith("sf"):
        return float(schema[2:].replace("_", "."))
    raise KeyError(f"unknown tpch schema: {schema}")


class TpchConnector(spi.Connector):
    name = "tpch"

    def list_schemas(self) -> List[str]:
        return list(_SCHEMA_SF)

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

    def column_stats(self, schema: str, table: str, column: str) -> Optional[spi.ColumnStats]:
        sf = schema_scale_factor(schema)
        vr = gen.column_vrange(table, column, sf)
        ndv = gen.column_ndv(table, column, sf)
        if vr is None and ndv is None:
            return None
        low, high = vr if vr is not None else (None, None)
        return spi.ColumnStats(low=low, high=high, ndv=ndv)

    _PRIMARY_KEYS = {
        "region": ["r_regionkey"],
        "nation": ["n_nationkey"],
        "supplier": ["s_suppkey"],
        "customer": ["c_custkey"],
        "part": ["p_partkey"],
        "partsupp": ["ps_partkey", "ps_suppkey"],
        "orders": ["o_orderkey"],
        "lineitem": ["l_orderkey", "l_linenumber"],
    }

    def primary_key(self, schema: str, table: str):
        return self._PRIMARY_KEYS.get(table)

    def data_version(self, schema: str, table: str) -> str:
        # generated data is a pure function of (table, scale factor):
        # immutable per schema, so cached results never go stale
        return "immutable"

    def table_partitioning(self, schema: str, table: str):
        """orders and lineitem are both generated in ORDER-index ranges
        with identical split-boundary arithmetic (get_splits), so they
        co-partition on the order key: split i of one holds exactly the
        orders whose lines are in split i of the other — a join on
        o_orderkey = l_orderkey needs no exchange (reference:
        ConnectorTablePartitioning + ConnectorNodePartitioningProvider,
        the bucketed-table co-located join contract)."""
        family = f"tpch:{schema}:order-range"
        if table == "orders":
            return spi.TablePartitioning(("o_orderkey",), family)
        if table == "lineitem":
            return spi.TablePartitioning(("l_orderkey",), family)
        return None

    # Columns monotone in the generator's row index (key = row + 1; lineitem
    # rows are indexed by ORDER row; partsupp rows are 4 per part). A range
    # or in-set constraint on these maps directly to row-range narrowing —
    # the generator analog of Parquet row-group pruning by min/max stats.
    _MONOTONE = {
        "region": ("r_regionkey", 0, 1),  # (column, key_offset, rows_per_key)
        "nation": ("n_nationkey", 0, 1),
        "supplier": ("s_suppkey", 1, 1),
        "customer": ("c_custkey", 1, 1),
        "part": ("p_partkey", 1, 1),
        "partsupp": ("ps_partkey", 1, 4),
        "orders": ("o_orderkey", 1, 1),
        "lineitem": ("l_orderkey", 1, 1),  # row index = order row
    }

    # in-set domains split into at most this many range runs (split overhead
    # cap, like max-splits-per-request in the reference split managers)
    MAX_PUSHDOWN_RUNS = 256

    def _key_ranges(self, table: str, n: int, constraint) -> List:
        """[(lo, hi)) generator row ranges covered by the constraint's domain
        on the monotone key column; [(0, n)] when nothing applies."""
        if constraint is None or table not in self._MONOTONE:
            return [(0, n)]
        column, off, per_key = self._MONOTONE[table]
        dom = constraint.domain(column)
        if dom.is_all():
            return [(0, n)]

        def key_to_rows(k):
            base = (int(k) - off) * per_key
            return base, base + per_key

        if dom.values is not None:
            import numpy as np

            if dom.values_sorted is not None:
                keys = np.unique(dom.values_sorted).astype(np.int64)
            else:
                keys = np.unique(np.fromiter(
                    (int(v) for v in dom.values
                     if isinstance(v, int) or (isinstance(v, float) and v == int(v))),
                    dtype=np.int64, count=-1))
            if keys.size == 0:
                return []
            # vectorized run building: consecutive keys merge into one run;
            # when runs outnumber the budget, keep only the widest gaps as
            # separators (coalescing the closest neighbors) — all numpy, no
            # per-key python (in-set domains reach millions of keys under
            # phase-1 dynamic filtering)
            brk = np.nonzero(np.diff(keys) > 1)[0]
            run_first = keys[np.concatenate(([0], brk + 1))]
            run_last = keys[np.concatenate((brk, [keys.size - 1]))]
            cap = self.MAX_PUSHDOWN_RUNS
            if run_first.size > cap:
                gaps = run_first[1:] - run_last[:-1]
                sep = np.sort(np.argpartition(gaps, -(cap - 1))[-(cap - 1):])
                run_first = np.concatenate(([run_first[0]], run_first[sep + 1]))
                run_last = np.concatenate((run_last[sep], [run_last[-1]]))
            runs = [
                (key_to_rows(f)[0], key_to_rows(l)[1])
                for f, l in zip(run_first.tolist(), run_last.tolist())
            ]
            return [(max(0, lo), min(n, hi)) for lo, hi in runs if lo < n and hi > 0]
        low, high = dom.value_bounds()
        lo = 0 if low is None else max(0, key_to_rows(low)[0])
        hi = n if high is None else min(n, key_to_rows(high)[1])
        return [(lo, hi)] if lo < hi else []

    def get_splits(
        self, schema: str, table: str, target_splits: int, constraint=None,
        handle=None,
    ) -> List[spi.Split]:
        """Never returns more than ``target_splits`` splits (callers shard
        them 1:1 onto devices/workers). When the constraint's key runs
        outnumber the budget, runs are grouped into contiguous covers and
        ``scan`` re-narrows each cover to the exact runs."""
        sf = schema_scale_factor(schema)
        if table == "lineitem":
            n = gen.table_row_count("orders", sf)  # order-range splits
        else:
            n = gen.table_row_count(table, sf)
        target_splits = max(target_splits, 1)
        ranges = self._key_ranges(table, n, constraint)
        if not ranges:
            return []
        if len(ranges) == 1:
            lo0, hi0 = ranges[0]
            rows = hi0 - lo0
            k = max(1, min(target_splits, rows))
            bounds = [lo0 + rows * i // k for i in range(k + 1)]
            return [
                spi.Split(table, schema, bounds[i], bounds[i + 1])
                for i in range(k)
                if bounds[i] < bounds[i + 1]
            ]
        if len(ranges) > target_splits:
            # group into target_splits covers, balanced by run count
            grouped: List = []
            per = (len(ranges) + target_splits - 1) // target_splits
            for i in range(0, len(ranges), per):
                chunk = ranges[i : i + per]
                grouped.append((chunk[0][0], chunk[-1][1]))
            ranges = grouped
        return [spi.Split(table, schema, lo, hi) for lo, hi in ranges]

    def scan(self, split: spi.Split, columns: List[str], constraint=None) -> Dict[str, spi.ColumnData]:
        sf = schema_scale_factor(split.schema)
        ranges = [
            (max(split.lo, lo), min(split.hi, hi))
            for lo, hi in self._key_ranges(split.table, split.hi, constraint)
        ]
        ranges = [(lo, hi) for lo, hi in ranges if lo < hi]
        parts = [gen.generate(split.table, sf, lo, hi, columns) for lo, hi in ranges]
        # the monotone key column is non-decreasing within every generated
        # range and ranges are enumerated ascending: declare its sort order
        # (reference: ConnectorTableProperties local properties)
        mono = self._MONOTONE.get(split.table)
        if mono and mono[0] in columns:
            for p in parts:
                p[mono[0]].sorted = True
        if len(parts) == 1:
            return {c: parts[0][c] for c in columns}
        if not parts:
            empty = gen.generate(split.table, sf, 0, 0, columns)
            return {c: empty[c] for c in columns}
        # merge part dictionaries where they differ (nation/region name
        # vocabs are range-dependent) — shared helper with the engine
        return {c: spi.concat_column_data([p[c] for p in parts]) for c in columns}
