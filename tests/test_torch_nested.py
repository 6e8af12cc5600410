"""The nested-type data plane and kernels of the port against the JAX
package's on the same seeded inputs: trino_tpu_torch/ops/array_ops.py
against trino_tpu/ops/array_ops.py, the nested ``Column`` (Python round
trips, concat, ``host_take``, ``all_dead``, ``slice_rows``), the executor's
``unnest_page`` and nested aggregates (array_agg, histogram, map_agg through
``aggregate_page``) over pages built from the same numpy arrays, and the
copied matcher of exec/match_recognize.py.

Tolerance: exact; doubles within ``rel_tol=1e-9`` (sums of a flat child
are a cumsum difference, whose order of additions may differ).
"""
import datetime
from decimal import Decimal

import numpy as np
import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
import jax.numpy as jnp
from trino_tpu import types as JT
from trino_tpu.client.session import Session as JaxSession
from trino_tpu.data.page import Column as JaxColumn
from trino_tpu.data.page import Page as JaxPage
from trino_tpu.data.page import host_take as j_host_take
from trino_tpu.exec import match_recognize as j_mr
from trino_tpu.exec.executor import Executor as JaxExecutor
from trino_tpu.ops import array_ops as JA
from trino_tpu.sql import ir as j_ir
from trino_tpu.sql.parser.parser import parse_statement as j_parse
from trino_tpu.sql.planner import plan as JP

from trino_tpu_torch import Session as TorchSession
from trino_tpu_torch import types as TT
from trino_tpu_torch.data.page import Page, column_data_from_python, column_to_device, host_take
from trino_tpu_torch.exec import match_recognize as t_mr
from trino_tpu_torch.exec.executor import Executor as TorchExecutor
from trino_tpu_torch.ops import array_ops as TA
from trino_tpu_torch.sql import ir as t_ir
from trino_tpu_torch.sql.parser.parser import parse_statement as t_parse
from trino_tpu_torch.sql.planner import plan as TP

REL_TOL = 1e-9


def eq(t, j, what=""):
    """Exact equality of a port tensor and a JAX array, dtypes included."""
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


# --------------------------------------------------------------- array_ops
def _lengths(kind, rng):
    if kind == "random":
        lens = rng.integers(0, 6, 200)
    elif kind == "all_empty":
        lens = np.zeros(50, np.int64)
    elif kind == "one_long":
        lens = np.array([0, 300, 0])
    else:  # "mostly_empty"
        lens = np.where(rng.random(120) < 0.9, 0, rng.integers(1, 4, 120))
    return lens.astype(np.int32)


KINDS = ("random", "all_empty", "one_long", "mostly_empty")


@pytest.mark.parametrize("kind", KINDS)
def test_offsets_and_rowids_equal_reference(kind):
    lens = _lengths(kind, np.random.default_rng(1))
    to, jo = TA.offsets_from_lengths(torch.from_numpy(lens)), JA.offsets_from_lengths(jnp.asarray(lens))
    eq(to, jo, "offsets")
    flat_n = int(lens.sum())
    eq(TA.rowid_of_flat(to, flat_n), JA.rowid_of_flat(jo, flat_n), "rowid")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", ["int8", "int32", "int64", "bool", "float32", "float64"])
def test_segment_reduce_by_range_equals_reference(kind, dtype):
    rng = np.random.default_rng(2)
    lens = _lengths(kind, rng)
    flat_n = int(lens.sum())
    if dtype == "bool":
        x = rng.random(flat_n) < 0.5
    elif dtype.startswith("float"):
        x = rng.normal(0, 1e3, flat_n).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, flat_n, dtype=dtype, endpoint=True)
    to, jo = TA.offsets_from_lengths(torch.from_numpy(lens)), JA.offsets_from_lengths(jnp.asarray(lens))
    got = TA.segment_reduce_by_range(to, torch.from_numpy(x))
    want = JA.segment_reduce_by_range(jo, jnp.asarray(x))
    if dtype.startswith("float"):
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL_TOL,
                                   atol=1e-9 if dtype == "float64" else 1e-2)
    else:
        eq(got, want, dtype)


@pytest.mark.parametrize("kind", KINDS)
def test_gather_at_equals_reference(kind):
    """1-based, negative, zero and out-of-range subscripts, and an empty
    flat child."""
    rng = np.random.default_rng(3)
    lens = _lengths(kind, rng)
    n, flat_n = len(lens), int(lens.sum())
    flat = rng.integers(-100, 100, flat_n).astype(np.int64)
    idx = rng.integers(-8, 9, n).astype(np.int64)
    idx[:4] = [0, -1, 7, 2**31 + 5][:min(4, n)]
    to, jo = TA.offsets_from_lengths(torch.from_numpy(lens)), JA.offsets_from_lengths(jnp.asarray(lens))
    gv, gb = TA.gather_at(to, torch.from_numpy(lens), torch.from_numpy(flat), torch.from_numpy(idx))
    wv, wb = JA.gather_at(jo, jnp.asarray(lens), jnp.asarray(flat), jnp.asarray(idx))
    eq(gb, wb, "in_bounds")
    inb = gb.numpy()
    np.testing.assert_array_equal(gv.numpy()[inb], np.asarray(wv)[inb])
    assert gv.numpy().dtype == np.asarray(wv).dtype


@pytest.mark.parametrize("kind", KINDS)
def test_first_match_and_count_in_ranges_equal_reference(kind):
    rng = np.random.default_rng(4)
    lens = _lengths(kind, rng)
    flat_n = int(lens.sum())
    match = rng.random(flat_n) < 0.3
    to, jo = TA.offsets_from_lengths(torch.from_numpy(lens)), JA.offsets_from_lengths(jnp.asarray(lens))
    eq(TA.first_match_index(to, torch.from_numpy(match)),
       JA.first_match_index(jo, jnp.asarray(match)), "first_match")
    eq(TA.count_in_ranges(to, torch.from_numpy(match)),
       JA.count_in_ranges(jo, jnp.asarray(match)), "count")


def test_gathers_clamp_where_jax_clamps():
    """Past the end of a one-element flat child, and with no flat child at
    all: no index error, the reference's in_bounds."""
    lens = np.array([0, 0, 0], np.int32)
    to = TA.offsets_from_lengths(torch.from_numpy(lens))
    v, b = TA.gather_at(to, torch.from_numpy(lens), torch.zeros(0, dtype=torch.int64),
                        torch.tensor([1, -1, 3]))
    assert v.tolist() == [0, 0, 0] and b.tolist() == [False, False, False]
    assert TA.first_match_index(to, torch.zeros(0, dtype=torch.bool)).tolist() == [0, 0, 0]


# ------------------------------------------------------- nested Column
VALUES = {
    "array(bigint)": [[1, 2], [], None, [5, None, -7], [2**62]],
    "array(varchar)": [["x", "y"], None, [], [None, "z", "x"], ["w"]],
    "map(varchar, bigint)": [{"a": 1}, None, {}, {"b": 2, "a": None}, {"c": -3}],
    "map(bigint, double)": [{1: 1.5, 2: -0.0}, {}, None, {9: float("inf")}, {3: 2.0}],
    "row(a bigint, b varchar)": [(1, "x"), None, (None, None), (4, "y"), (5, "x")],
    "array(decimal(10,2))": [[Decimal("1.25")], None, [], [Decimal("-3.50"), None], []],
    "array(decimal(38,2))": [[Decimal("1" * 30 + ".01")], [], None, [Decimal("-2.00")], []],
    "array(date)": [[datetime.date(1995, 3, 1)], [None], None, [], [datetime.date(1969, 7, 20)]],
    "array(boolean)": [[True, False], [None], [], None, [True]],
}


def _both_columns(tname):
    data = VALUES[tname]
    j = JaxColumn.from_python(JT.parse_type(tname), data)
    t = column_to_device(column_data_from_python(TT.parse_type(tname), data), "cpu")
    return t, j


def assert_same_column(t, j, what=""):
    """The same arrays, recursively, and the same Python values."""
    assert str(t.type) == str(j.type), what
    eq(t.values, j.values, f"{what} values")
    assert (t.nulls is None) == (j.nulls is None), what
    if t.nulls is not None:
        eq(t.nulls, j.nulls, f"{what} nulls")
    assert (t.hi is None) == (j.hi is None), what
    if t.hi is not None:
        eq(t.hi, j.hi, f"{what} hi")
    assert (t.dictionary is None) == (j.dictionary is None), what
    if t.dictionary is not None:
        assert t.dictionary.values == j.dictionary.values, what
    assert (t.children is None) == (j.children is None), what
    for k, (tk, jk) in enumerate(zip(t.children or (), j.children or ())):
        assert_same_column(tk, jk, f"{what}.{k}")
    assert t.to_python() == j.to_python(), what


@pytest.mark.parametrize("tname", list(VALUES))
def test_column_round_trip_equals_reference(tname):
    t, j = _both_columns(tname)
    assert_same_column(t, j, tname)
    assert t.to_python() == VALUES[tname] or tname.startswith("map")


@pytest.mark.parametrize("tname", list(VALUES))
def test_concat_and_host_take_equal_reference(tname):
    t, j = _both_columns(tname)
    tp = Page.concat_pages(Page([t]), Page([t]))
    jp = JaxPage.concat_pages(JaxPage([j]), JaxPage([j]))
    assert_same_column(tp.columns[0], jp.columns[0], "concat")
    np.testing.assert_array_equal(tp.sel.numpy(), np.asarray(jp.sel))
    idx = np.random.default_rng(5).integers(0, 2 * len(t), 17)
    assert_same_column(host_take(tp.columns[0], idx), j_host_take(jp.columns[0], idx), "take")
    empty = np.zeros(0, np.int64)
    assert_same_column(host_take(t, empty), j_host_take(j, empty), "take nothing")
    assert tp.to_pylist() == jp.to_pylist()


@pytest.mark.parametrize("tname", list(VALUES))
def test_slices_and_byte_estimate_equal_reference(tname):
    t, j = _both_columns(tname)
    tp, jp = Page([t, t]), JaxPage([j, j])
    for lo, hi in ((0, 2), (1, 4), (3, 99), (2, 2)):
        assert tp.slice_rows(lo, hi).to_pylist() == jp.slice_rows(lo, hi).to_pylist()
    assert tp.row_byte_estimate() == jp.row_byte_estimate()
    sel = np.array([True, False, True, True, False])
    tp, jp = Page([t], torch.from_numpy(sel)), JaxPage([j], jnp.asarray(sel))
    assert tp.to_pylist() == jp.to_pylist()
    assert_same_column(tp.compact().columns[0], jp.compact().columns[0], "compact")


def test_all_dead_equals_reference():
    names = list(VALUES) + ["row(a array(bigint), b map(varchar, bigint))", "bigint"]
    tp = Page.all_dead([TT.parse_type(n) for n in names], "cpu")
    jp = JaxPage.all_dead([JT.parse_type(n) for n in names])

    def shape(c):
        return (str(c.type), tuple(c.values.shape), str(np.asarray(c.values).dtype)
                if not isinstance(c.values, torch.Tensor) else str(c.values.numpy().dtype),
                [shape(k) for k in c.children or ()])

    assert [shape(c) for c in tp.columns] == [shape(c) for c in jp.columns]
    assert tp.to_pylist() == jp.to_pylist() == []


# ------------------------------------------------------- executor paths
def _page_data(seed=6, n=64):
    """Columns of one page: an id, a group key with NULLs, arrays of
    bigint (NULL rows and NULL elements, empty arrays) and of varchar, a
    map and a long decimal; plus a selection mask."""
    rng = np.random.default_rng(seed)
    arr = [None if rng.random() < 0.15 else
           [None if rng.random() < 0.1 else int(v) for v in rng.integers(-50, 50, rng.integers(0, 5))]
           for _ in range(n)]
    words = ["ab", "cd", "ef", "gh"]
    strs = [None if rng.random() < 0.1 else [words[int(v)] for v in rng.integers(0, 4, rng.integers(0, 4))]
            for _ in range(n)]
    maps = [None if rng.random() < 0.1 else {int(k): float(rng.normal()) for k in rng.integers(0, 6, 3)}
            for _ in range(n)]
    data = {
        "id": ("bigint", list(range(n))),
        "g": ("bigint", [None if rng.random() < 0.1 else int(v) for v in rng.integers(0, 7, n)]),
        "s": ("varchar", [words[int(v)] for v in rng.integers(0, 4, n)]),
        "x": ("double", [float(v) for v in rng.normal(0, 10, n)]),
        "d": ("decimal(38,2)", [Decimal(int(v)).scaleb(-2) if i % 9 else
                                Decimal("12345678901234567890123.45")
                                for i, v in enumerate(rng.integers(-10**6, 10**6, n))]),
        "xs": ("array(bigint)", arr),
        "ys": ("array(varchar)", strs),
        "m": ("map(bigint, double)", maps),
    }
    sel = rng.random(n) < 0.8
    return data, sel


def _both_pages(with_sel=True):
    data, sel = _page_data()
    jp = JaxPage([JaxColumn.from_python(JT.parse_type(t), v) for t, v in data.values()],
                 jnp.asarray(sel) if with_sel else None)
    from trino_tpu_torch.data.page import page_from_numpy

    tp = page_from_numpy(jp.columns, sel if with_sel else None, device="cpu")
    return list(data), jp, tp


def _executors():
    return (JaxExecutor(JaxSession()),
            TorchExecutor(TorchSession(device="cpu")))


def _values_node(P, types, names, cols):
    return P.ValuesNode(types=[types.parse_type(c) for c in cols], names=names, rows=[])


UNNESTS = {
    "single": (["xs"], False, ["id", "g"]),
    "ordinality": (["xs"], True, ["id"]),
    "zipped": (["xs", "ys"], False, ["id", "s"]),
    "zipped_ordinality": (["ys", "xs"], True, []),
    "map": (["m"], False, ["id", "x"]),
}


@pytest.mark.parametrize("with_sel", [True, False])
@pytest.mark.parametrize("case", list(UNNESTS))
def test_unnest_page_equals_reference(case, with_sel):
    names, jp, tp = _both_pages(with_sel)
    exprs, ordinality, replicate = UNNESTS[case]
    types = [str(c.type) for c in jp.columns]
    nodes = []
    for P, ty, ir in ((JP, JT, j_ir), (TP, TT, t_ir)):
        src = _values_node(P, ty, names, types)
        nodes.append(P.UnnestNode(
            source=src,
            unnest_exprs=[ir.ColumnRef(ty.parse_type(types[names.index(e)]), names.index(e), e)
                          for e in exprs],
            ordinality=ordinality,
            replicate_channels=[names.index(r) for r in replicate]))
    je, te = _executors()
    want = je.unnest_page(nodes[0], jp)
    got = te.unnest_page(nodes[1], tp)
    assert got.num_rows == want.num_rows
    np.testing.assert_array_equal(got.sel.numpy(), np.asarray(want.sel))
    assert got.to_pylist() == want.to_pylist()


def test_unnest_replicates_a_long_decimal_whole():
    """A reference fault the port repairs: a replicated two-limb decimal
    keeps its high limb through UNNEST. The reference's ``unnest_page``
    gathers the low word only, so 12345678901234567890123.45 comes out as
    10962463713375599.29."""
    names, jp, tp = _both_pages(False)
    types = [str(c.type) for c in jp.columns]
    d, xs = names.index("d"), names.index("xs")
    got, want = [], []
    for P, ty, ir, ex, page, out in ((JP, JT, j_ir, _executors()[0], jp, want),
                                     (TP, TT, t_ir, _executors()[1], tp, got)):
        node = P.UnnestNode(source=_values_node(P, ty, names, types),
                            unnest_exprs=[ir.ColumnRef(ty.parse_type(types[xs]), xs, "xs")],
                            replicate_channels=[d])
        out.extend(r[0] for r in ex.unnest_page(node, page).to_pylist())
    data, _ = _page_data()
    per_row = [dv for dv, a in zip(data["d"][1], data["xs"][1]) if a for _ in a]
    assert got == per_row
    big = Decimal("12345678901234567890123.45")
    assert big in got and big not in want
    assert [g for g in got if g != big] == [w for w, g in zip(want, got) if g != big]


AGGREGATES = {
    # (group channels, [(function, arg, arg2, output type)])
    "array_agg_by_g": (["g"], [("array_agg", "id", None, "array(bigint)"),
                               ("array_agg", "x", None, "array(double)")]),
    "array_agg_by_s": (["s"], [("array_agg", "g", None, "array(bigint)"),
                               ("array_agg", "d", None, "array(decimal(38,2))")]),
    "array_agg_global": ([], [("array_agg", "s", None, "array(varchar)"),
                              ("array_agg", "g", None, "array(bigint)")]),
    "histogram_by_g": (["g"], [("histogram", "s", None, "map(varchar, bigint)")]),
    "histogram_global": ([], [("histogram", "g", None, "map(bigint, bigint)")]),
    "map_agg_by_s": (["s"], [("map_agg", "g", "x", "map(bigint, double)"),
                             ("map_agg", "id", "d", "map(bigint, decimal(38,2))")]),
}


@pytest.mark.parametrize("with_sel", [True, False])
@pytest.mark.parametrize("case", list(AGGREGATES))
def test_nested_aggregates_equal_reference(case, with_sel):
    """array_agg's element order is the grouping layout's, so the rows are
    compared exactly, lists in order."""
    names, jp, tp = _both_pages(with_sel)
    groups, calls = AGGREGATES[case]
    types = [str(c.type) for c in jp.columns]
    nodes = []
    for P, ty in ((JP, JT), (TP, TT)):
        aggs = [P.AggregateCall(fn, names.index(a), ty.parse_type(out),
                                arg2_channel=None if a2 is None else names.index(a2))
                for fn, a, a2, out in calls]
        nodes.append(P.AggregationNode(source=_values_node(P, ty, names, types),
                                       group_channels=[names.index(g) for g in groups],
                                       aggregates=aggs, names=groups + [c[0] for c in calls]))
    je, te = _executors()
    want = je.aggregate_page(nodes[0], jp)
    got = te.aggregate_page(nodes[1], tp)
    assert got.to_pylist() == want.to_pylist()
    for tc, jc in zip(got.columns[len(groups):], want.columns[len(groups):]):
        eq(tc.values, jc.values, "lengths")


def test_array_agg_distinct_is_refused_alike():
    names, jp, tp = _both_pages()
    types = [str(c.type) for c in jp.columns]
    msgs = []
    for (P, ty), (ex, page) in zip(((JP, JT), (TP, TT)), zip(_executors(), (jp, tp))):
        node = P.AggregationNode(
            source=_values_node(P, ty, names, types), group_channels=[1],
            aggregates=[P.AggregateCall("array_agg", 0, ty.parse_type("array(bigint)"),
                                        distinct=True)], names=["g", "a"])
        with pytest.raises(NotImplementedError) as e:
            ex.aggregate_page(node, page)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------ the copied matcher
V_SHAPE = """
select * from t match_recognize (
  partition by sym order by day
  measures first(strt.day) as start_day, last(down.day) as bottom_day,
           last(up.price) as top_price, match_number() as mn, classifier() as c,
           prev(up.price, 2) as p2
  {after}
  pattern (strt down+ up+ flat?)
  define down as price < prev(price), up as price > prev(price),
         flat as price = prev(price))"""


@pytest.mark.parametrize("after", ["after match skip past last row",
                                   "after match skip to next row"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_match_recognize_equals_reference(seed, after):
    """The copied matcher over the same seeded partition rows (prices with
    NULLs and ties): the same matches and measure values."""
    rng = np.random.default_rng(seed)
    rows = [{"sym": "A", "day": i,
             "price": None if rng.random() < 0.05 else int(rng.integers(0, 12))}
            for i in rng.permutation(300).tolist()]
    out = []
    for parse, mr in ((j_parse, j_mr), (t_parse, t_mr)):
        rel = parse(V_SHAPE.format(after=after)).body.from_
        out.append(mr.run_match_recognize(
            list(rows), lambda r: (r["day"],), list(rel.pattern), list(rel.defines),
            list(rel.measures), rel.after_match))
    assert out[1] == out[0] and len(out[0]) > 10


def test_page_bytes_counts_children():
    """A reference fault the port repairs: ``exec/memory.page_bytes``
    (which sizes device-cache entries and the spill decision) counts a
    nested column's children. The reference counts the lengths only: 4000
    bytes for 1000 arrays of three bigints, which hold 28000."""
    from trino_tpu.exec.memory import page_bytes as j_page_bytes

    from trino_tpu_torch.exec.memory import page_bytes

    data = [[1, 2, 3]] * 1000
    t = column_to_device(column_data_from_python(TT.array_of(TT.BIGINT), data), "cpu")
    j = JaxColumn.from_python(JT.array_of(JT.BIGINT), data)
    assert page_bytes(Page([t])) == 4 * 1000 + 8 * 3000
    assert j_page_bytes(JaxPage([j])) == 4 * 1000
