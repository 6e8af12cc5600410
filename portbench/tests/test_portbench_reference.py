"""The plain reference against the port on the CPU at ``tpch.tiny`` over
seeded parameters, and against the JAX package's answers at SF1 with the
spec's validation parameters."""
import decimal
import json
from pathlib import Path

import pytest

from portbench.queries.tpch import params as P
from portbench.reference.compare import canonical, first_difference, same_answer
from portbench.reference.tables import Tables
from portbench.reference.tpch import answers

EXPECTED = Path(__file__).resolve().parents[2] / "trino_tpu_torch" / "testdata" / \
    "tpch_sf1_expected.json"


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2 ** 33 + 5])
def test_reference_matches_the_port_at_tiny(seed):
    from trino_tpu_torch import Session

    prm = P.draw(seed, 0.01)
    ref = answers(Tables(0.01, "cpu"), prm)
    session = Session({"catalog": "tpch", "schema": "tiny"}, device="cpu")
    bad = {}
    for q in P.QUERY_IDS:
        got = canonical(session.execute(P.render(q, prm[q])).rows)
        if not same_answer(q, got, ref[q]):
            bad[q] = first_difference(got, ref[q])
    assert not bad


def _jsonable(v):
    if isinstance(v, tuple) and v[0] == "d":
        return str(decimal.Decimal(v[1]).scaleb(-v[2]))
    if isinstance(v, tuple) and v[0] == "date":
        return v[1]
    return v


def test_reference_matches_the_validation_answers_at_sf1():
    expected = json.loads(EXPECTED.read_text())["queries"]
    ref = answers(Tables(1, "cpu"), P.VALIDATION)
    for q in P.QUERY_IDS:
        rows = [[_jsonable(v) for v in r] for r in ref[q]]
        assert rows == expected[str(q)]["rows"], q


def test_the_comparison_holds_ties_and_scales():
    a = [("x", ("d", 150, 2)), ("y", ("d", 150, 2)), ("z", ("d", 100, 2))]
    b = [a[1], a[0], a[2]]
    assert same_answer(11, a, b)            # tied values, either order
    assert not same_answer(11, a[::-1], a)  # out of ORDER BY order
    assert not same_answer(6, [(("d", 15, 1),)], [(("d", 150, 2),)])  # scale differs
    assert canonical([(decimal.Decimal("-1.50"),)]) == [(("d", -150, 2),)]
