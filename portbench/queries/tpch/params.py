"""TPC-H substitution parameters (TPC-H Standard Specification 3.0.1, Clause
2.4.N.3), drawn from a seed, and the 22 query texts they fill.

Each value is drawn within the range the clause gives, from the vocabularies
the connector's generator makes (a frozen copy under ``portbench/reference``).
``draw`` returns plain strings and integers: the text the SQL carries and the
input the plain reference reads, so both sides get the same parameters.
"""
from __future__ import annotations

import datetime
from decimal import Decimal
from pathlib import Path
from typing import Dict

import numpy as np

from portbench.reference import generator as G

TEMPLATES = Path(__file__).resolve().parent
QUERY_IDS = tuple(range(1, 23))
NATION_NAMES = [n for n, _ in G.NATIONS]
TYPES = [f"{a} {b} {c}" for a in G.TYPE_SYLLABLE1 for b in G.TYPE_SYLLABLE2
         for c in G.TYPE_SYLLABLE3]
CONTAINERS = [f"{a} {b}" for a in G.CONTAINER_SYLLABLE1 for b in G.CONTAINER_SYLLABLE2]
Q13_WORD1 = ["special", "pending", "unusual", "express"]
Q13_WORD2 = ["packages", "requests", "accounts", "deposits"]
COUNTRY_CODES = [str(10 + k) for k in range(len(G.NATIONS))]


def _month(rng, first: tuple, last: tuple) -> str:
    """First day of a month drawn uniformly from ``first`` to ``last`` (year, month)."""
    lo = first[0] * 12 + first[1] - 1
    hi = last[0] * 12 + last[1] - 1
    m = int(rng.integers(lo, hi + 1))
    return datetime.date(m // 12, m % 12 + 1, 1).isoformat()


def _year(rng) -> str:
    return f"{int(rng.integers(1993, 1998))}-01-01"


def _brand(rng) -> str:
    return f"Brand#{int(rng.integers(1, 6))}{int(rng.integers(1, 6))}"


def _pick(rng, values):
    return values[int(rng.integers(0, len(values)))]


def _distinct(rng, values, k):
    return [values[int(i)] for i in rng.permutation(len(values))[:k]]


def fraction(sf: float) -> str:
    """Q11's FRACTION, 0.0001 / SF, as an exact decimal literal."""
    return format(Decimal("0.0001") / Decimal(repr(float(sf))).normalize(), "f")


def draw(seed: int, sf: float) -> Dict[int, Dict[str, object]]:
    """One substitution set for the 22 queries from ``seed``."""
    rng = np.random.default_rng(int(seed))
    p: Dict[int, Dict[str, object]] = {}
    p[1] = {"DELTA": int(rng.integers(60, 121))}
    p[2] = {"SIZE": int(rng.integers(1, 51)), "TYPE": _pick(rng, G.TYPE_SYLLABLE3),
            "REGION": _pick(rng, G.REGIONS)}
    p[3] = {"SEGMENT": _pick(rng, G.MKT_SEGMENTS),
            "DATE": f"1995-03-{int(rng.integers(1, 32)):02d}"}
    p[4] = {"DATE": _month(rng, (1993, 1), (1997, 10))}
    p[5] = {"REGION": _pick(rng, G.REGIONS), "DATE": _year(rng)}
    p[6] = {"DATE": _year(rng), "DISCOUNT": f"0.0{int(rng.integers(2, 10))}",
            "QUANTITY": int(rng.integers(24, 26))}
    n1, n2 = _distinct(rng, NATION_NAMES, 2)
    p[7] = {"NATION1": n1, "NATION2": n2}
    k = int(rng.integers(0, len(G.NATIONS)))
    p[8] = {"NATION": G.NATIONS[k][0], "REGION": G.REGIONS[G.NATIONS[k][1]],
            "TYPE": _pick(rng, TYPES)}
    p[9] = {"COLOR": _pick(rng, G.PART_COLORS)}
    p[10] = {"DATE": _month(rng, (1993, 2), (1995, 1))}
    p[11] = {"NATION": _pick(rng, NATION_NAMES), "FRACTION": fraction(sf)}
    m1, m2 = _distinct(rng, G.SHIP_MODES, 2)
    p[12] = {"SHIPMODE1": m1, "SHIPMODE2": m2, "DATE": _year(rng)}
    p[13] = {"WORD1": _pick(rng, Q13_WORD1), "WORD2": _pick(rng, Q13_WORD2)}
    p[14] = {"DATE": _month(rng, (1993, 1), (1997, 12))}
    p[15] = {"DATE": _month(rng, (1993, 1), (1997, 10))}
    sizes = [int(s) for s in rng.permutation(np.arange(1, 51))[:8]]
    t = _pick(rng, TYPES)
    p[16] = {"BRAND": _brand(rng), "TYPE": " ".join(t.split()[:2]),
             **{f"SIZE{i + 1}": s for i, s in enumerate(sizes)}}
    p[17] = {"BRAND": _brand(rng), "CONTAINER": _pick(rng, CONTAINERS)}
    p[18] = {"QUANTITY": int(rng.integers(312, 316))}
    p[19] = {"QUANTITY1": int(rng.integers(1, 11)), "QUANTITY2": int(rng.integers(10, 21)),
             "QUANTITY3": int(rng.integers(20, 31)), "BRAND1": _brand(rng),
             "BRAND2": _brand(rng), "BRAND3": _brand(rng)}
    p[20] = {"COLOR": _pick(rng, G.PART_COLORS), "DATE": _year(rng),
             "NATION": _pick(rng, NATION_NAMES)}
    p[21] = {"NATION": _pick(rng, NATION_NAMES)}
    p[22] = {f"I{i + 1}": c for i, c in enumerate(_distinct(rng, COUNTRY_CODES, 7))}
    return p


# the spec's validation parameters (Clause 2.4.N.3 "Query Validation")
VALIDATION = {
    1: {"DELTA": 90}, 2: {"SIZE": 15, "TYPE": "BRASS", "REGION": "EUROPE"},
    3: {"SEGMENT": "BUILDING", "DATE": "1995-03-15"}, 4: {"DATE": "1993-07-01"},
    5: {"REGION": "ASIA", "DATE": "1994-01-01"},
    6: {"DATE": "1994-01-01", "DISCOUNT": "0.06", "QUANTITY": 24},
    7: {"NATION1": "FRANCE", "NATION2": "GERMANY"},
    8: {"NATION": "BRAZIL", "REGION": "AMERICA", "TYPE": "ECONOMY ANODIZED STEEL"},
    9: {"COLOR": "green"}, 10: {"DATE": "1993-10-01"},
    11: {"NATION": "GERMANY", "FRACTION": "0.0001"},
    12: {"SHIPMODE1": "MAIL", "SHIPMODE2": "SHIP", "DATE": "1994-01-01"},
    13: {"WORD1": "special", "WORD2": "requests"}, 14: {"DATE": "1995-09-01"},
    15: {"DATE": "1996-01-01"},
    16: {"BRAND": "Brand#45", "TYPE": "MEDIUM POLISHED",
         **{f"SIZE{i + 1}": s for i, s in enumerate((49, 14, 23, 45, 19, 3, 36, 9))}},
    17: {"BRAND": "Brand#23", "CONTAINER": "MED BOX"}, 18: {"QUANTITY": 300},
    19: {"QUANTITY1": 1, "QUANTITY2": 10, "QUANTITY3": 20, "BRAND1": "Brand#12",
         "BRAND2": "Brand#23", "BRAND3": "Brand#34"},
    20: {"COLOR": "forest", "DATE": "1994-01-01", "NATION": "CANADA"},
    21: {"NATION": "SAUDI ARABIA"},
    22: {f"I{i + 1}": c for i, c in enumerate(("13", "31", "23", "29", "30", "18", "17"))},
}


def template(q: int) -> str:
    return (TEMPLATES / f"q{q:02d}.sql").read_text()


def render(q: int, params: Dict[str, object]) -> str:
    """Query ``q``'s text with ``params`` substituted."""
    return template(q).format(**params)
