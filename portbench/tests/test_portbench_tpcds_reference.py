"""The ``tpcds`` family's plain reference against the JAX package's answers
at SF1 (the committed rows ``chip_smoke.py`` checks, with the templates'
constants as ``tests/tpcds_sql.py`` has them), and its sources importing
nothing of the program."""
import ast
import decimal
import json
import sys
from pathlib import Path

from portbench.queries.tpcds import params as P
from portbench.reference import tpcds as R

BENCH = Path(__file__).resolve().parents[1]
EXPECTED = BENCH.parent / "trino_tpu_torch" / "testdata" / "analytics_sf1_expected.json"
NAMES = {64: "q64", 95: "q95", 101: "w_ds_revenue_share", 102: "w_ds_rank_stores",
         103: "s_ds_channels", 104: "s_ds_union_distinct"}
# the constants of tests/tpcds_sql.py's q64 and q95
CONSTANTS = {64: {"YEAR": 1999, "PRICE": 64, "COLOR1": "purple", "COLOR2": "burlywood",
                  "COLOR3": "indian", "COLOR4": "spring", "COLOR5": "floral",
                  "COLOR6": "medium"},
             95: {"YEAR": 1999, "MONTH": 2, "STATE": "IL", "COMPANY": "pri"}}


def _jsonable(v):
    if isinstance(v, tuple) and v[0] == "d":
        return str(decimal.Decimal(v[1]).scaleb(-v[2]))
    return v


def test_reference_matches_the_jax_answers_at_sf1():
    expected = json.loads(EXPECTED.read_text())["queries"]
    prm = P.draw(0, 1)
    prm.update(CONSTANTS)
    ref = R.answers(R.DsTables(1, "cpu"), prm)
    for q, name in NAMES.items():
        rows = [[_jsonable(v) for v in r] for r in ref[q]]
        want = expected[name]["rows"]
        if q == 64:  # its ties, as the JAX package ordered them
            rows, want = sorted(rows, key=repr), sorted(want, key=repr)
        assert rows == want, q


def test_the_templates_are_the_texts_the_port_is_tested_on():
    """q64 and q95 with those constants are ``tests/tpcds_sql.py``'s texts,
    below the templates' comments."""
    sys.path.insert(0, str(BENCH.parent / "tests"))
    from tpcds_sql import Q64, Q95

    for q, text in ((64, Q64), (95, Q95)):
        body = "\n".join(line for line in P.render(q, CONSTANTS[q]).splitlines()
                         if not line.startswith("--"))
        assert body.strip() == text.strip(), q


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_the_family_imports_nothing_of_the_program():
    for path in (BENCH / "reference" / "tpcds.py", BENCH / "reference" / "tpcds_generator.py",
                 BENCH / "queries" / "tpcds" / "params.py", BENCH / "bytes" / "tpcds_bytes.py"):
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "trino_tpu",
                                          "trino_tpu_torch"}, path
