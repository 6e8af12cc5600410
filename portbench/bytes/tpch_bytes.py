"""The frozen byte table behind ``ops_roofline``: the bytes each TPC-H query
reads, at each scale factor a configuration runs.

A query reads every column its text names, each once however often it is
scanned: rows of the column's table times the column's stored width (8 bytes
for bigint and decimal(12,2), held as scaled int64; 4 for integer, date and
varchar, held as int32 dictionary codes). Rows are the generator's exact
counts (lineitem's from each order's line count). The table is written once
and read by the metric; ``portbench/tests/test_portbench_bytes.py`` computes
it again from the query templates and the schema.

    python -m portbench.bytes.tpch_bytes   # rewrites bytes/tpch.json
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict

import numpy as np

from portbench.queries.tpch import params as P
from portbench.reference import generator as G

TABLE = Path(__file__).resolve().parent / "tpch.json"
SCALES = ("0.01", "1")
PEAK_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, HBM3 (data sheet, 700 W)


def width(sql_type: str) -> int:
    if sql_type in ("bigint",) or sql_type.startswith("decimal"):
        return 8
    return 4  # integer, date, varchar (dictionary codes)


def row_count(table: str, sf: float) -> int:
    if table != "lineitem":
        return G.table_row_count(table, sf)
    orders = G.table_row_count("orders", sf)
    total = 0
    for lo in range(0, orders, 1 << 22):
        keys = np.arange(lo + 1, min(orders, lo + (1 << 22)) + 1, dtype=np.int64)
        total += int(G._line_count(keys).sum())
    return total


def columns_read(q: int):
    """(table, column) of every schema column the query's text names."""
    words = set(re.findall(r"[a-z_]+", P.template(q).lower()))
    return sorted((t, c) for t, cols in G.SCHEMAS.items() for c, _ in cols if c in words)


def compute() -> Dict:
    types = {(t, c): ty for t, cols in G.SCHEMAS.items() for c, ty in cols}
    rows = {sf: {t: row_count(t, float(sf)) for t in G.SCHEMAS} for sf in SCALES}
    queries = {}
    for q in P.QUERY_IDS:
        cols = columns_read(q)
        queries[str(q)] = {
            "columns": [f"{t}.{c}" for t, c in cols],
            "bytes": {sf: sum(rows[sf][t] * width(types[(t, c)]) for t, c in cols)
                      for sf in SCALES}}
    return {"peak_bytes_per_s": PEAK_BYTES_PER_S,
            "widths": {f"{t}.{c}": width(ty) for (t, c), ty in sorted(types.items())},
            "rows": rows, "queries": queries}


if __name__ == "__main__":
    TABLE.write_text(json.dumps(compute(), indent=1, sort_keys=True) + "\n")
