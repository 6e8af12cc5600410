"""The TPC-H substitution rules: every parameter inside its clause's range,
drawn from what the port's generator makes, and one seed giving one text."""
import datetime
import re

import pytest

from portbench.queries.tpch import params as P
from trino_tpu_torch.connector.tpch import generator as PG

NATIONS = [n for n, _ in PG.NATIONS]
TYPES = {f"{a} {b} {c}" for a in PG.TYPE_SYLLABLE1 for b in PG.TYPE_SYLLABLE2
         for c in PG.TYPE_SYLLABLE3}
BRAND = re.compile(r"Brand#[1-5][1-5]")


def _first_of_month(s, lo, hi):
    d = datetime.date.fromisoformat(s)
    return d.day == 1 and lo <= (d.year, d.month) <= hi


def _jan_first(s):
    d = datetime.date.fromisoformat(s)
    return (d.month, d.day) == (1, 1) and 1993 <= d.year <= 1997


def check_ranges(p, sf):
    assert 60 <= p[1]["DELTA"] <= 120
    assert 1 <= p[2]["SIZE"] <= 50 and p[2]["TYPE"] in PG.TYPE_SYLLABLE3
    assert p[2]["REGION"] in PG.REGIONS
    assert p[3]["SEGMENT"] in PG.MKT_SEGMENTS
    assert "1995-03-01" <= p[3]["DATE"] <= "1995-03-31"
    assert _first_of_month(p[4]["DATE"], (1993, 1), (1997, 10))
    assert p[5]["REGION"] in PG.REGIONS and _jan_first(p[5]["DATE"])
    assert _jan_first(p[6]["DATE"]) and p[6]["QUANTITY"] in (24, 25)
    assert p[6]["DISCOUNT"] in {f"0.0{k}" for k in range(2, 10)}
    assert p[7]["NATION1"] in NATIONS and p[7]["NATION2"] in NATIONS
    assert p[7]["NATION1"] != p[7]["NATION2"]
    assert p[8]["TYPE"] in TYPES
    assert PG.REGIONS[dict(PG.NATIONS)[p[8]["NATION"]]] == p[8]["REGION"]
    assert p[9]["COLOR"] in PG.PART_COLORS
    assert _first_of_month(p[10]["DATE"], (1993, 2), (1995, 1))
    assert p[11]["NATION"] in NATIONS
    assert float(p[11]["FRACTION"]) == pytest.approx(0.0001 / sf)
    assert {p[12]["SHIPMODE1"], p[12]["SHIPMODE2"]} <= set(PG.SHIP_MODES)
    assert p[12]["SHIPMODE1"] != p[12]["SHIPMODE2"] and _jan_first(p[12]["DATE"])
    assert p[13]["WORD1"] in ("special", "pending", "unusual", "express")
    assert p[13]["WORD2"] in ("packages", "requests", "accounts", "deposits")
    assert {p[13]["WORD1"], p[13]["WORD2"]} <= set(PG._COMMENT_WORDS)
    assert _first_of_month(p[14]["DATE"], (1993, 1), (1997, 12))
    assert _first_of_month(p[15]["DATE"], (1993, 1), (1997, 10))
    assert BRAND.fullmatch(p[16]["BRAND"])
    assert any(t.startswith(p[16]["TYPE"] + " ") for t in TYPES)
    sizes = [p[16][f"SIZE{i}"] for i in range(1, 9)]
    assert len(set(sizes)) == 8 and all(1 <= s <= 50 for s in sizes)
    assert BRAND.fullmatch(p[17]["BRAND"])
    assert p[17]["CONTAINER"] in {f"{a} {b}" for a in PG.CONTAINER_SYLLABLE1
                                  for b in PG.CONTAINER_SYLLABLE2}
    assert 312 <= p[18]["QUANTITY"] <= 315
    assert 1 <= p[19]["QUANTITY1"] <= 10 and 10 <= p[19]["QUANTITY2"] <= 20
    assert 20 <= p[19]["QUANTITY3"] <= 30
    assert all(BRAND.fullmatch(p[19][f"BRAND{i}"]) for i in (1, 2, 3))
    assert p[20]["COLOR"] in PG.PART_COLORS and _jan_first(p[20]["DATE"])
    assert p[20]["NATION"] in NATIONS and p[21]["NATION"] in NATIONS
    codes = [p[22][f"I{i}"] for i in range(1, 8)]
    assert len(set(codes)) == 7 and all(10 <= int(c) <= 34 for c in codes)


@pytest.mark.parametrize("sf", [1, 10])
def test_every_seed_draws_inside_the_spec(sf):
    for seed in range(100):
        check_ranges(P.draw(seed, sf), sf)


def test_a_seed_gives_the_same_sql_twice():
    for seed in (0, 7, 2 ** 33 + 1):
        a = {q: P.render(q, p) for q, p in P.draw(seed, 1).items()}
        b = {q: P.render(q, p) for q, p in P.draw(seed, 1).items()}
        assert a == b
        assert all("{" not in s and "}" not in s for s in a.values())
    assert P.draw(1, 1) != P.draw(2, 1)


def test_validation_parameters_give_the_spec_text():
    check_ranges({**P.VALIDATION, 18: {"QUANTITY": 312}}, 1)
    sql = P.render(6, P.VALIDATION[6])
    assert "l_discount between 0.06 - 0.01 and 0.06 + 0.01" in sql
    assert P.fraction(10) == "0.00001" and P.fraction(0.01) == "0.01"
