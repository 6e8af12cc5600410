"""The benchmark's ``tpcds`` family on the CPU at ``tiny``: the plain
reference (``portbench/reference/tpcds.py``) against ``Session.execute`` on
the port for the six queries, the reference's frozen generator against the
port's ``tpcds`` generator, faults planted in a run of the cell
``tpcds-sf10.analytics`` turning it incorrect, and the executor's spans and
counters on dynamic filters, windows and set operations."""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402
from portbench.queries.tpcds import params as P  # noqa: E402
from portbench.reference import tpcds as R  # noqa: E402
from portbench.reference import tpcds_generator as FG  # noqa: E402

from trino_tpu_torch import Session  # noqa: E402
from trino_tpu_torch.connector.tpcds import generator as PG  # noqa: E402
from trino_tpu_torch.obs import metrics as M  # noqa: E402
from trino_tpu_torch.obs import trace  # noqa: E402

TINY = {"scale_factor": 0.01, "schema": "tiny"}
CELL = "tpcds-sf10.analytics"
# substitution sets under which q64 and q95 return rows at tiny (their
# drawn sets select nothing there): an item and a web order that the
# queries with their item, state and company filters dropped return, and the
# colour, price, year, month, state and company that keep them
SETS = {
    "a": {64: {"YEAR": 1999, "PRICE": 14, "COLOR1": "orange", "COLOR2": "chartreuse",
               "COLOR3": "red", "COLOR4": "navy", "COLOR5": "tan", "COLOR6": "white"},
          95: {"YEAR": 2000, "MONTH": 3, "STATE": "MO", "COMPANY": "able"}},
    "b": {64: {"YEAR": 1999, "PRICE": 45, "COLOR1": "cornsilk", "COLOR2": "aquamarine",
               "COLOR3": "orange", "COLOR4": "plum", "COLOR5": "snow", "COLOR6": "green"},
          95: {"YEAR": 1999, "MONTH": 3, "STATE": "WI", "COMPANY": "ese"}},
}
INTERSECT_SQL = """SELECT ss_item_sk FROM tpcds.tiny.store_sales
    INTERSECT SELECT ws_item_sk FROM tpcds.tiny.web_sales"""
OPERATOR_PARTS = {M.DYNAMIC_FILTER_SECONDS: "exec/dynamic-filter",
                  M.WINDOW_SECONDS: "exec/window", M.SET_OP_SECONDS: "exec/set-op"}


def _params(name):
    prm = P.draw(7, 0.01)
    prm.update(SETS[name])
    return prm


@pytest.fixture(scope="module")
def session():
    return Session({"catalog": "tpcds", "schema": "tiny", "device_cache_enabled": True},
                   device="cpu")


@pytest.fixture(scope="module")
def tables():
    return R.DsTables(0.01, "cpu")


# ------------------------------------------------- reference against the port
@pytest.mark.parametrize("q", P.QUERY_IDS)
@pytest.mark.parametrize("name", sorted(SETS))
def test_reference_matches_the_port_at_tiny(session, tables, name, q):
    prm = _params(name)
    want = R.answers(tables, prm, queries=(q,))[q]
    got = R.canonical(session.execute(P.render(q, prm[q])).rows)
    assert R.same_answer(q, got, want), R.first_difference(got, want)
    assert want and (q != 95 or want[0][0] > 0), want


@pytest.mark.parametrize("name", sorted(SETS))
def test_the_float32_control_is_refused(tables, name):
    """The cell's separating control (``portbench/control_tpcds.py``): the
    reference with its decimals and their sums in float32, put in the
    program's place, is refused on the revenue shares, the ranked profits
    and the channel totals. float64 carries these answers exactly, so the
    comparison reads it as the exact reference."""
    from portbench.control_tpcds import control_reading

    reading = control_reading(tables, _params(name))
    assert {101, 102, 103} <= set(reading["float32"]["queries"]), reading
    assert reading["float64"]["mismatched_answers"] == 0, reading
    assert reading["q95"][0] > 0 and reading["rows"][64] > 0, reading


@pytest.mark.parametrize("seed", [0, 2026, 2 ** 31 + 11])
def test_drawn_parameters_lie_in_the_templates_ranges(seed):
    prm = P.draw(seed, 10)
    assert prm == P.draw(seed, 10)
    q64, q95 = prm[64], prm[95]
    colours = [q64[f"COLOR{i}"] for i in range(1, 7)]
    assert len(set(colours)) == 6 and set(colours) <= set(PG.COLORS)
    assert 1999 <= q64["YEAR"] <= 2001 and 0 <= q64["PRICE"] <= 85
    assert 1999 <= q95["YEAR"] <= 2002 and 2 <= q95["MONTH"] <= 5
    assert q95["STATE"] in PG.STATES and q95["COMPANY"] in PG.COMPANIES
    assert all(prm[q] == {"s": "sf10"} for q in (101, 102, 103, 104))
    for q in P.QUERY_IDS:
        assert "{" not in P.render(q, prm[q])


def test_the_comparison_holds_q64s_ties_as_a_multiset():
    row = ("p", "s", "z") + ("x",) * 8 + (1999, 1) + tuple(("d", 100, 2) for _ in range(6)) \
        + (2000, 1)
    other = row[:18] + (("d", 7, 2),) + row[19:]
    assert R.same_answer(64, [row, other], [other, row])  # tied on the ORDER BY
    later = row[:20] + (2,)
    assert not R.same_answer(64, [later, row], [row, later])  # cs2.cnt orders them
    assert not R.same_answer(95, [(1, ("d", 150, 2), None)], [(1, ("d", 15, 1), None)])


# ----------------------------------------------------------- frozen generator
@pytest.mark.parametrize("table", sorted(PG.SCHEMAS))
def test_frozen_generator_equals_the_ports_at_tiny(table):
    assert FG.SCHEMAS[table] == PG.SCHEMAS[table]
    n = PG.order_range_count(table, 0.01)
    assert FG.order_range_count(table, 0.01) == n
    assert FG.table_row_count(table, 10) == PG.table_row_count(table, 10)
    cols = [c for c, _ in PG.SCHEMAS[table]]
    for lo, hi in ((0, n), (n // 3, n)):
        mine, port = FG.generate(table, 0.01, lo, hi, cols), PG._generate(table, 0.01, lo, hi,
                                                                          set(cols))
        for c in cols:
            assert np.array_equal(mine[c].values, port[c].values), c
            if port[c].dictionary is None:
                assert mine[c].dictionary is None, c
            else:
                assert mine[c].dictionary.values == port[c].dictionary.values, c


# --------------------------------------------------------- faults in the cell
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(seconds):
    return core.run_cell(BENCH, CELL, 2 ** 31 + 7, seconds, False, "cpu", time.perf_counter(),
                         config_overrides=TINY)


def _alter(rows):
    if not rows:
        return [(0,)]
    first = list(rows[0])
    v = first[-1]
    first[-1] = v + 1 if isinstance(v, int) else v * 2 if v else 1
    return [tuple(first)] + list(rows[1:])


def _drop_row(rows):
    return list(rows[:-1])


def test_a_sound_run_of_the_cell_is_correct():
    # a window that answers all six queries however busy the machine (a pass
    # takes a few tenths of a second alone, some seconds beside other tests)
    res = _run(12.0)
    assert res["correct"], res["notes"]
    assert res["notes"]["instances_compared"] == 6


@pytest.mark.parametrize("fault", [_alter, _drop_row], ids=["altered", "row_dropped"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    real = Session.execute
    calls = {"n": 0}

    def execute(self, sql):
        res = real(self, sql)
        calls["n"] += 1
        # set-up's two warm-up passes make 12 answers; the window's are altered
        if calls["n"] > 12:
            res.rows = fault(res.rows)
        return res

    monkeypatch.setattr(Session, "execute", execute)
    # q64 answers no row at tiny; the window reaches q101 after it
    res = _run(3.0)
    assert not res["correct"]
    assert res["checks"]["mismatched_answers"]["value"] > 0


# ---------------------------------------------------------- spans and counters
def _traced(session, sql):
    tracer = trace.Tracer(max_spans=1 << 16)
    before = {m: m.value() for m in (*OPERATOR_PARTS, M.DYNAMIC_FILTER_HOST_BYTES)}
    with trace.activate(tracer):
        rows = session.execute(sql).rows
    deltas = {m: m.value() - v for m, v in before.items()}
    return tracer.spans(), deltas, rows


def _feeds(spans, deltas, counter):
    mine = [s for s in spans if s.name == OPERATOR_PARTS[counter]]
    assert mine
    assert deltas[counter] == pytest.approx(sum(s.duration for s in mine), abs=1e-9)
    by_id = {s.span_id: s for s in spans}
    for s in mine:
        parent = by_id[s.parent_id]
        assert parent.name.startswith("exec/") and parent._t0 <= s._t0
        assert s._t0 + s.duration <= parent._t0 + parent.duration + 1e-9
    return mine


def test_a_window_query_feeds_the_window_counter(session):
    sql = P.render(101, {"s": "tiny"})
    session.execute(sql)  # the tables staged outside the traced run
    spans, deltas, rows = _traced(session, sql)
    (win,) = _feeds(spans, deltas, M.WINDOW_SECONDS)
    assert win.attributes == {"calls": 1}
    assert deltas[M.SET_OP_SECONDS] == 0
    assert rows == session.execute(sql).rows


@pytest.mark.parametrize("sql,ops", [(P.render(103, {"s": "tiny"}), {"union_all"}),
                                     (INTERSECT_SQL, {"intersect"})],
                         ids=["union_all", "intersect"])
def test_a_set_operation_feeds_the_set_op_counter(session, sql, ops):
    session.execute(sql)
    spans, deltas, rows = _traced(session, sql)
    mine = _feeds(spans, deltas, M.SET_OP_SECONDS)
    assert {s.attributes["op"] for s in mine} == ops
    assert deltas[M.WINDOW_SECONDS] == 0
    assert rows == session.execute(sql).rows


def test_a_join_with_a_dynamic_filter_feeds_its_counters(session):
    sql = P.render(95, SETS["a"][95])
    session.execute(sql)
    spans, deltas, rows = _traced(session, sql)
    mine = _feeds(spans, deltas, M.DYNAMIC_FILTER_SECONDS)
    for s in mine:
        assert set(s.attributes) == {"node", "keys", "rows", "bytes", "kind"}
        assert s.attributes["keys"] >= 1 and s.attributes["rows"] >= 0
        assert set(s.attributes["kind"].split(",")) <= {"set", "range", "empty"}
    assert deltas[M.DYNAMIC_FILTER_HOST_BYTES] == sum(s.attributes["bytes"] for s in mine) > 0
    assert rows == session.execute(sql).rows


def test_without_a_tracer_no_span_is_made_and_the_counters_advance(session, monkeypatch):
    sqls = [P.render(101, {"s": "tiny"}), P.render(103, {"s": "tiny"}), INTERSECT_SQL,
            P.render(95, SETS["a"][95])]
    for sql in sqls:
        session.execute(sql)
    made = []
    real = trace.Span.__init__

    def init(self, *a, **k):
        made.append(a[0] if a else k.get("name"))
        real(self, *a, **k)

    monkeypatch.setattr(trace.Span, "__init__", init)
    assert trace.current() is None
    counters = (*OPERATOR_PARTS, M.DYNAMIC_FILTER_HOST_BYTES)
    before = {m: m.value() for m in counters}
    for sql in sqls:
        session.execute(sql)
    assert made == []
    assert all(m.value() > before[m] for m in counters), {
        m.name: m.value() - before[m] for m in counters}
    assert all(M.REGISTRY.get(m.name) is m and m.name in M.PORT_SERIES for m in counters)


# ------------------------------------------------------- the admission cap
def test_the_default_admission_cap_grows_with_the_pool(monkeypatch):
    """A session that leaves ``device_cache_max_bytes`` unset may keep an
    entry of a quarter of the pool's budget (on the 80 GB card, q64's 1.4
    GB scan of store_sales at SF10); one that sets the property is capped by
    it, whatever the value, its old default of 1 GiB included."""
    from trino_tpu_torch.devcache import admit_budget
    from trino_tpu_torch.devcache.cache import DEVICE_CACHE

    unset = Session({"catalog": "tpcds", "schema": "tiny"}, device="cpu")
    assert unset.properties.get("device_cache_max_bytes") is None
    assert admit_budget(unset) == DEVICE_CACHE.max_bytes // 4
    small = Session({"catalog": "tpcds", "schema": "tiny", "device_cache_max_bytes": 5000},
                    device="cpu")
    gib = Session({"catalog": "tpcds", "schema": "tiny", "device_cache_max_bytes": 1 << 30},
                  device="cpu")
    monkeypatch.setattr(DEVICE_CACHE, "_max_bytes", 80 * 10 ** 9 // 4)
    assert admit_budget(unset) == 5 * 10 ** 9
    assert admit_budget(small) == 5000
    assert admit_budget(gib) == 1 << 30
