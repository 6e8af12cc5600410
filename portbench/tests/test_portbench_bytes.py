"""The frozen byte table of ``ops_roofline`` against a count made afresh
from the query templates' column names and the port's schema."""
import json
import re

import numpy as np

from portbench.bytes import tpch_bytes
from portbench.queries.tpch import params as P
from trino_tpu_torch.connector.tpch import generator as PG

WIDTH = {"bigint": 8, "integer": 4, "date": 4}


def _width(t):
    return 8 if t.startswith("decimal") else 4 if t.startswith("varchar") else WIDTH[t]


def _rows(table, sf):
    if table != "lineitem":
        return PG.table_row_count(table, sf)
    keys = np.arange(1, PG.table_row_count("orders", sf) + 1, dtype=np.int64)
    return int(PG._line_count(keys).sum())


def test_frozen_table_is_what_the_templates_read():
    frozen = json.loads(tpch_bytes.TABLE.read_text())
    types = {c: (t, ty) for t, cols in PG.SCHEMAS.items() for c, ty in cols}
    for sf in ("0.01", "1"):
        rows = {t: _rows(t, float(sf)) for t in PG.SCHEMAS}
        assert frozen["rows"][sf] == rows
        for q in P.QUERY_IDS:
            named = set(re.findall(r"\b(?:l|o|c|p|ps|s|n|r)_[a-z]+\b", P.template(q)))
            cols = sorted(c for c in named if c in types)
            want = sum(rows[types[c][0]] * _width(types[c][1]) for c in cols)
            assert frozen["queries"][str(q)]["bytes"][sf] == want, q
            assert sorted(x.split(".")[1] for x in frozen["queries"][str(q)]["columns"]) == cols


def test_frozen_table_is_current():
    assert json.loads(tpch_bytes.TABLE.read_text()) == json.loads(
        json.dumps(tpch_bytes.compute()))
