"""The frozen byte table behind ``ops_roofline`` for the ``tpcds`` family: the
bytes each of its six queries reads, at each scale factor a configuration
runs.

The rule is the TPC-H table's (``tpch_bytes.py``): a query reads every column
its text names (its ``--`` comments left out), each once however often it is
scanned: rows of the column's table times the column's stored width (8 bytes
for bigint and decimal(7,2), held as scaled int64; 4 for integer, date and
varchar, held as int32 dictionary codes). Rows are the generator's exact
counts (a fact table's from each order's or ticket's lines, its returns from
the lines drawn as returned). The table is written once and read by the
metric; ``portbench/tests/test_portbench_tpcds_bytes.py`` computes it again
from the query templates and the port's schema.

    python -m portbench.bytes.tpcds_bytes   # rewrites bytes/tpcds.json
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict

from portbench.bytes.tpch_bytes import PEAK_BYTES_PER_S, width
from portbench.queries.tpcds import params as P
from portbench.reference import tpcds_generator as G

TABLE = Path(__file__).resolve().parent / "tpcds.json"
SCALES = ("0.01", "10")
_CHUNK = 1 << 20


def row_count(table: str, sf: float) -> int:
    """The rows the generator makes of ``table``, counted range by range."""
    n = G.order_range_count(table, sf)
    first = G.SCHEMAS[table][0][0]
    return sum(len(G.generate(table, sf, lo, min(n, lo + _CHUNK), [first])[first].values)
               for lo in range(0, n, _CHUNK))


def sql_text(q: int) -> str:
    """Query ``q``'s template without its comments."""
    return "\n".join(line.split("--")[0] for line in P.template(q).splitlines())


def columns_read(q: int):
    """(table, column) of every schema column the query's text names."""
    words = set(re.findall(r"[a-z_]+", sql_text(q).lower()))
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
