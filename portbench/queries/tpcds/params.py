"""TPC-DS substitution parameters (TPC-DS Standard Specification 3.2.0, the
``define`` lines of query templates 64 and 95), drawn from a seed, and the six
query texts they fill.

Queries 64 and 95 are the TPC-DS templates. Queries 101-104 are the repo's own
queries in the shape of TPC-DS 98, 70 and 5/77 (the generator lacks the
columns of those templates): they carry no substitution parameter, only the
schema the scale factor names (``{s}``), and are numbered past the spec's 99
so that none passes for a real template.

Each value is drawn within the range the template gives, from the
vocabularies the connector's generator makes (a frozen copy under
``portbench/reference``). ``draw`` returns plain strings and integers: the
text the SQL carries and the input the plain reference reads, so both sides
get the same parameters.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np

from portbench.reference import tpcds_generator as G

TEMPLATES = Path(__file__).resolve().parent
QUERY_IDS = (64, 95, 101, 102, 103, 104)
# the schemas of the connector by scale factor (connector/tpcds: tiny, sfN)
SCHEMAS = {0.01: "tiny", 1.0: "sf1", 10.0: "sf10", 100.0: "sf100"}


def schema(sf: float) -> str:
    return SCHEMAS[float(sf)]


def draw(seed: int, sf: float) -> Dict[int, Dict[str, object]]:
    """One substitution set for the six queries from ``seed``."""
    rng = np.random.default_rng(int(seed))
    p: Dict[int, Dict[str, object]] = {}
    # q64: define YEAR = random(1999, 2001); PRICE = random(0, 85);
    # COLOR = ulist(dist(colors), 6)
    colors = [G.COLORS[int(i)] for i in rng.permutation(len(G.COLORS))[:6]]
    p[64] = {"YEAR": int(rng.integers(1999, 2002)), "PRICE": int(rng.integers(0, 86)),
             **{f"COLOR{i + 1}": c for i, c in enumerate(colors)}}
    # q95: define YEAR = random(1999, 2002); MONTH = random(2, 5); STATE =
    # dist(fips_county); COMPANY = a web site's company name
    p[95] = {"YEAR": int(rng.integers(1999, 2003)), "MONTH": int(rng.integers(2, 6)),
             "STATE": G.STATES[int(rng.integers(0, len(G.STATES)))],
             "COMPANY": G.COMPANIES[int(rng.integers(0, len(G.COMPANIES)))]}
    for q in (101, 102, 103, 104):
        p[q] = {"s": schema(sf)}
    return p


def template(q: int) -> str:
    return (TEMPLATES / f"q{q}.sql").read_text()


def render(q: int, params: Dict[str, object]) -> str:
    """Query ``q``'s text with ``params`` substituted."""
    return template(q).format(**params)
