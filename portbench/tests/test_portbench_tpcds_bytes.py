"""The frozen byte table of ``ops_roofline`` for the ``tpcds`` family against
a count made afresh from the query templates' column names and the port's
schema and generator."""
import json
import re

from portbench.bytes import tpcds_bytes
from portbench.queries.tpcds import params as P
from trino_tpu_torch.connector.tpcds import generator as PG

WIDTH = {"bigint": 8, "integer": 4, "date": 4}


def _width(t):
    return 8 if t.startswith("decimal") else 4 if t.startswith("varchar") else WIDTH[t]


def _rows(table, sf):
    """The rows the port's generator makes, one range of orders at a time."""
    n = PG.order_range_count(table, sf)
    col = PG.SCHEMAS[table][0][0]
    step = 1 << 20
    return sum(len(PG._generate(table, sf, lo, min(n, lo + step), {col})[col].values)
               for lo in range(0, n, step))


def test_frozen_table_is_what_the_templates_read():
    frozen = json.loads(tpcds_bytes.TABLE.read_text())
    types = {c: (t, ty) for t, cols in PG.SCHEMAS.items() for c, ty in cols}
    for sf in ("0.01", "10"):
        rows = {t: _rows(t, float(sf)) for t in PG.SCHEMAS}
        assert frozen["rows"][sf] == rows
        for q in P.QUERY_IDS:
            text = re.sub(r"--[^\n]*", "", P.template(q))
            named = set(re.findall(r"\b[a-z]+_[a-z_]+\b", text))
            cols = sorted(c for c in named if c in types)
            want = sum(rows[types[c][0]] * _width(types[c][1]) for c in cols)
            assert frozen["queries"][str(q)]["bytes"][sf] == want, q
            assert sorted(x.split(".")[1] for x in frozen["queries"][str(q)]["columns"]) == cols


def test_frozen_table_is_current():
    assert json.loads(tpcds_bytes.TABLE.read_text()) == json.loads(
        json.dumps(tpcds_bytes.compute()))
