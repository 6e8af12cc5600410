"""The port's calendar math (trino_tpu_torch/ops/datetime_ops.py) and the
expression kinds of trino_tpu_torch/ops/expr_lower.py that the TPC-H
queries reach, against their JAX counterparts on the same inputs. Each
expression is built once per package from the same description, lowered
over the same page (the port's page made from the JAX page's arrays), and
compared exactly: values, validity and dictionaries."""
import datetime
from decimal import Decimal

import numpy as np
import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
import jax.numpy as jnp
from trino_tpu import types as JT
from trino_tpu.data.page import Page as JaxPage
from trino_tpu.ops import datetime_ops as j_dt
from trino_tpu.ops import expr_lower as j_L
from trino_tpu.sql import ir as j_ir

from trino_tpu_torch import types as TT
from trino_tpu_torch.data.dictionary import Dictionary as TDictionary
from trino_tpu_torch.data.page import page_from_numpy
from trino_tpu_torch.obs import metrics as t_M
from trino_tpu_torch.obs import trace as t_trace
from trino_tpu_torch.ops import datetime_ops as t_dt
from trino_tpu_torch.ops import expr_lower as t_L
from trino_tpu_torch.sql import ir as t_ir

EPOCH = datetime.date(1970, 1, 1)


def eq(t, j):
    """Exact equality of a port tensor and a JAX array (values and dtype)."""
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def days(*dates):
    return np.array([(d - EPOCH).days for d in dates], dtype=np.int32)


@pytest.fixture
def rng():
    return np.random.default_rng(20261016)


# ------------------------------------------------------------ datetime_ops
EDGE_DATES = [datetime.date(*d) for d in (
    (1970, 1, 1), (1969, 12, 31), (1900, 2, 28), (1600, 2, 29), (2000, 2, 29),
    (2001, 2, 28), (1999, 1, 31), (1992, 3, 31), (1998, 12, 1), (1, 1, 1),
    (2400, 12, 31), (1968, 2, 29))]


def test_civil_round_trip_and_extract_year(rng):
    d = np.concatenate([days(*EDGE_DATES),
                        rng.integers(-800_000, 800_000, 2000).astype(np.int32)])
    for a, b in zip(t_dt.civil_from_days(torch.from_numpy(d)),
                    j_dt.civil_from_days(jnp.asarray(d))):
        eq(a, b)
    y, m, dd = (np.array(x) for x in j_dt.civil_from_days(jnp.asarray(d)))
    eq(t_dt.days_from_civil(torch.from_numpy(y), torch.from_numpy(m), torch.from_numpy(dd)),
       j_dt.days_from_civil(jnp.asarray(y), jnp.asarray(m), jnp.asarray(dd)))
    eq(t_dt.extract_year(torch.from_numpy(d)), j_dt.extract_year(jnp.asarray(d)))
    assert t_dt.extract_year(torch.from_numpy(days(datetime.date(1969, 12, 31)))).item() == 1969


def test_days_in_month(rng):
    y = np.concatenate([[1900, 2000, 2004, 2100, 1969, 1600],
                        rng.integers(-500, 3000, 300)]).astype(np.int64)
    m = np.concatenate([[2, 2, 2, 2, 2, 2], rng.integers(1, 13, 300)]).astype(np.int64)
    eq(t_dt.days_in_month(torch.from_numpy(y), torch.from_numpy(m)),
       j_dt.days_in_month(jnp.asarray(y), jnp.asarray(m)))


@pytest.mark.parametrize("n", [1, -1, 12, -13, 25, 0])
def test_add_months_clamps_to_month_end(rng, n):
    """Jan 31, Feb 29 and dates before 1970 among the inputs."""
    d = np.concatenate([days(*EDGE_DATES),
                        rng.integers(-40_000, 40_000, 500).astype(np.int32)])
    k = np.full(len(d), n, dtype=np.int64)
    eq(t_dt.add_months(torch.from_numpy(d), torch.from_numpy(k)),
       j_dt.add_months(jnp.asarray(d), jnp.asarray(k)))
    jan31 = torch.from_numpy(days(datetime.date(1999, 1, 31)))
    if n == 1:
        out = t_dt.add_months(jan31, torch.tensor([1])).item()
        assert EPOCH + datetime.timedelta(days=out) == datetime.date(1999, 2, 28)


# ------------------------------------------------------------ expressions
NULLABLE_ROWS = 9
COLUMNS = {
    # name: (type, values) -- every column has NULLs but ``d``
    "d": ("date", [datetime.date(1994, 1, 31), datetime.date(1996, 2, 29),
                   datetime.date(1969, 12, 31), datetime.date(1995, 3, 15),
                   datetime.date(1998, 12, 1), datetime.date(1900, 1, 31),
                   datetime.date(1992, 6, 30), datetime.date(1993, 10, 1),
                   datetime.date(1997, 8, 31)]),
    "k": ("bigint", [1, 3, None, 5, 7, None, 2, 3, 9]),
    "b": ("boolean", [True, False, None, True, None, False, True, False, True]),
    "s": ("varchar", ["special requests", "a.c", None, "100%", "(x)", "xay",
                      "abc", "12-345", "special  pending requests"]),
    "m": ("decimal(12,2)", [Decimal("1.25"), None, Decimal("-3.00"), Decimal("0.07"),
                            Decimal("99.99"), Decimal("5.00"), None, Decimal("0.00"),
                            Decimal("-0.01")]),
    "big": ("decimal(38,2)", [Decimal("1" * 30 + ".01"), Decimal("-2.50"), None,
                              Decimal("7.00"), Decimal("-" + "9" * 25 + ".99"),
                              Decimal("0.00"), Decimal("3.33"), Decimal("12.00"),
                              Decimal("-1.00")]),
}
ORDER = list(COLUMNS)


def _pages(sel):
    schema = {c: JT.parse_type(t) if t != "varchar" else JT.varchar()
              for c, (t, _) in COLUMNS.items()}
    jp = JaxPage.from_pydict(schema, {c: v for c, (_, v) in COLUMNS.items()})
    tp = page_from_numpy(jp.columns, device="cpu")
    return jp, tp


def _both(build, sel=None):
    """Lower ``build(ir, types, col)`` in both packages over the same page."""
    jp, tp = _pages(sel)

    def col(ir, types):
        def ref(name):
            t = COLUMNS[name][0]
            return ir.ColumnRef(types.varchar() if t == "varchar" else types.parse_type(t),
                                ORDER.index(name), name)
        return ref

    ej = build(j_ir, JT, col(j_ir, JT))
    et = build(t_ir, TT, col(t_ir, TT))
    jsel = None if sel is None else jnp.asarray(sel)
    tsel = None if sel is None else torch.from_numpy(sel)
    lj = j_L.lower(ej, j_L.LowerCtx(jp.columns, NULLABLE_ROWS, jsel))
    ctx = t_L.LowerCtx(tp.columns, NULLABLE_ROWS, tsel, "cpu")
    lt = t_L.lower(et, ctx)
    return lt, lj


def _check(lt, lj):
    assert (lt.valid is None) == (lj.valid is None)
    if lt.valid is not None:
        eq(lt.valid, lj.valid)
    assert (lt.dictionary is None) == (lj.dictionary is None)
    if lt.dictionary is not None:
        assert lt.dictionary.values == lj.dictionary.values
    assert (lt.hi is None) == (lj.hi is None)
    if lt.hi is not None:
        eq(lt.hi, lj.hi)
    eq(lt.vals, lj.vals)


def _c(ir, types, tname, v):
    t = types.varchar() if tname == "varchar" else types.parse_type(tname)
    return ir.Constant(t, v)


EXPRS = {
    "not": lambda ir, T, c: ir.Call(T.BOOLEAN, "not", (c("b"),)),
    "between_date": lambda ir, T, c: ir.Call(
        T.BOOLEAN, "between", (c("d"), _c(ir, T, "date", 8766), _c(ir, T, "date", 10000))),
    "between_nulls": lambda ir, T, c: ir.Call(
        T.BOOLEAN, "between", (c("k"), _c(ir, T, "bigint", 2), _c(ir, T, "bigint", 7))),
    "in_list": lambda ir, T, c: ir.Call(T.BOOLEAN, "in_list", (
        c("k"), _c(ir, T, "bigint", 1), _c(ir, T, "bigint", 3), _c(ir, T, "bigint", 9))),
    "in_list_null_item": lambda ir, T, c: ir.Call(T.BOOLEAN, "in_list", (
        c("k"), _c(ir, T, "bigint", 3), _c(ir, T, "bigint", None))),
    "in_list_varchar": lambda ir, T, c: ir.Call(T.BOOLEAN, "in_list", (
        c("s"), _c(ir, T, "varchar", "abc"), _c(ir, T, "varchar", "zz"),
        _c(ir, T, "varchar", "(x)"))),
    "extract_year": lambda ir, T, c: ir.Call(T.BIGINT, "extract_year", (c("d"),)),
    "date_add_months": lambda ir, T, c: ir.Call(
        T.DATE, "date_add_months", (c("d"), _c(ir, T, "bigint", 1))),
    "date_sub_year": lambda ir, T, c: ir.Call(
        T.DATE, "date_add_months", (c("d"), _c(ir, T, "bigint", -12))),
    "date_add_months_null_n": lambda ir, T, c: ir.Call(
        T.DATE, "date_add_months", (c("d"), c("k"))),
    "case_else": lambda ir, T, c: ir.Case(T.parse_type("decimal(12,2)"), (
        (ir.Call(T.BOOLEAN, "gt", (c("k"), _c(ir, T, "bigint", 4))), c("m")),
        (c("b"), _c(ir, T, "decimal(12,2)", 100))), _c(ir, T, "decimal(12,2)", 0)),
    "case_no_else": lambda ir, T, c: ir.Case(T.BIGINT, (
        (ir.Call(T.BOOLEAN, "lt", (c("k"), _c(ir, T, "bigint", 4))), c("k")),), None),
    "mul_long_decimals": lambda ir, T, c: ir.Call(
        T.parse_type("decimal(38,4)"), "mul", (c("big"), c("m"))),
    "div_by_long_decimal": lambda ir, T, c: ir.Call(
        T.parse_type("decimal(38,6)"), "div", (c("m"), c("big"))),
    "case_long_decimal": lambda ir, T, c: ir.Case(T.parse_type("decimal(38,2)"), (
        (c("b"), c("big")),), c("m")),
    "case_varchar": lambda ir, T, c: ir.Case(T.varchar(), (
        (c("b"), c("s")),), _c(ir, T, "varchar", "other")),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
@pytest.mark.parametrize("with_sel", [False, True])
def test_expression_matches_reference(name, with_sel):
    sel = (np.arange(NULLABLE_ROWS) % 3 != 1) if with_sel else None
    _check(*_both(EXPRS[name], sel))


LIKE_PATTERNS = ["%special%requests%", "a_c", "a.c", "%.%", "100%", "(%)", "%[%",
                 "x%y", "_", "%", "", "12-%", "%$", "^%", "a+c", "%requests"]


@pytest.mark.parametrize("pattern", LIKE_PATTERNS)
def test_like_matches_reference(pattern):
    """``%`` and ``_`` wildcards; regex metacharacters are literals."""
    lt, lj = _both(lambda ir, T, c: ir.Call(
        T.BOOLEAN, "like", (c("s"), _c(ir, T, "varchar", pattern))))
    _check(lt, lj)


def test_like_metacharacters_are_literal():
    lt, _ = _both(lambda ir, T, c: ir.Call(
        T.BOOLEAN, "like", (c("s"), _c(ir, T, "varchar", "a.c"))))
    assert lt.vals.tolist() == [False, True] + [False] * 7


# Q22's (1, 2) first
SUBSTRING_BOUNDS = [(1, 2), (2, None), (-2, None), (-3, 2), (0, 3), (10, None), (-20, 2),
                    (3, 0), (4, 100), (1, -1)]


@pytest.mark.parametrize("start,length", SUBSTRING_BOUNDS)
def test_substring_matches_reference(start, length):
    def build(ir, T, c):
        args = (c("s"), _c(ir, T, "bigint", start))
        if length is not None:
            args += (_c(ir, T, "bigint", length),)
        return ir.Call(T.varchar(), "substring", args)

    _check(*_both(build))


def test_in_list_lowers_its_operand_once(monkeypatch):
    """Q22's ``substring(c_phone, 1, 2) in (...)``: the operand's host pass
    over the vocabulary runs once, not once for each list item."""
    calls = []
    orig = t_L._substring_table

    def spy(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(t_L, "_substring_table", spy)
    _check(*_both(lambda ir, T, c: ir.Call(T.BOOLEAN, "in_list", (
        ir.Call(T.varchar(), "substring", (c("s"), _c(ir, T, "bigint", 1),
                                           _c(ir, T, "bigint", 2))),
        *(_c(ir, T, "varchar", v) for v in ("sp", "a.", "12", "zz", "(x"))))))
    assert len(calls) == 1


# ASCII vocabularies: entries of varying length, '' and one-character
# entries, the first and last ASCII bytes
SUBSTRING_VOCABS = {
    "mixed": ["", "a", "ab", "abc", "12-345-678", "special  pending requests", "(x)",
              "~\x7f", "\x01z", "zzzzzzzzzzzzzzzzzzzz"],
    "one_char": ["a", "b", "x"],
    "empty_string": [""],
    "empty": [],
    "phones": [f"{10 + i % 25}-{i % 997:03d}-{i % 991:03d}-{i:04d}" for i in range(500)],
}


@pytest.mark.parametrize("vocab", sorted(SUBSTRING_VOCABS))
@pytest.mark.parametrize("start,length", SUBSTRING_BOUNDS)
def test_substring_vector_pass_matches_entries(vocab, start, length):
    """The pass over the vocabulary's bytes gives the dictionary and the
    codes that ``_sql_substring`` applied to each entry gives."""
    d = TDictionary(sorted(set(SUBSTRING_VOCABS[vocab])))
    assert d.byte_form().ascii
    got, codes = t_L._substring_table(d.byte_form(), start, length)
    mapped = [t_L._sql_substring(v, start, length) for v in d.values]
    want = TDictionary.build(mapped)
    assert got.values == want.values
    assert codes.dtype == np.int32
    assert codes.tolist() == [want.code_of(m) for m in mapped]


def _substring_lowered(strings, start, length, tracer=None):
    """substring(s, start[, length]) over one varchar column holding
    ``strings``, lowered in both packages, with the port's span under
    ``tracer``: (port, JAX, port's vector passes, its per-entry passes)."""
    jp = JaxPage.from_pydict({"s": JT.varchar()}, {"s": strings})
    tp = page_from_numpy(jp.columns, device="cpu")

    def build(ir, T):
        args = (ir.ColumnRef(T.varchar(), 0, "s"), _c(ir, T, "bigint", start))
        if length is not None:
            args += (_c(ir, T, "bigint", length),)
        return ir.Call(T.varchar(), "substring", args)

    lj = j_L.lower(build(j_ir, JT), j_L.LowerCtx(jp.columns, len(strings), None))
    v0, e0 = t_M.SUBSTRING_VECTOR_PASSES.value(), t_M.SUBSTRING_ENTRY_PASSES.value()
    with t_trace.activate(tracer or t_trace.Tracer()):
        lt = t_L.lower(build(t_ir, TT), t_L.LowerCtx(tp.columns, len(strings), None, "cpu"))
    return (lt, lj, t_M.SUBSTRING_VECTOR_PASSES.value() - v0,
            t_M.SUBSTRING_ENTRY_PASSES.value() - e0)


@pytest.mark.parametrize("strings,path", [
    (["special requests", "a", "", None, "12-345"], "vector"),
    (["été", "naïve", "ab", None, "Ωmega"], "entries"),
    (["a\x00", "a", "b\x00c", None, "\x00"], "entries"),
], ids=["ascii", "non_ascii", "nul"])
@pytest.mark.parametrize("start,length", SUBSTRING_BOUNDS)
def test_substring_path_follows_the_vocabulary(strings, path, start, length):
    """A vocabulary whose characters are not all bytes, or that holds a NUL,
    takes the per-entry path; every path gives the reference's answer, row
    for row ``_sql_substring``'s, and the counters and the span's ``path``
    say which path ran."""
    tracer = t_trace.Tracer()
    lt, lj, vector, entries = _substring_lowered(strings, start, length, tracer)
    _check(lt, lj)
    rows = lt.dictionary.decode(lt.vals.numpy())
    assert rows == [None if v is None else t_L._sql_substring(v, start, length)
                    for v in strings]
    assert (vector, entries) == ((1, 0) if path == "vector" else (0, 1))
    (sp,) = [s for s in tracer.spans() if s.name == "exec/host-pass"]
    assert sp.attributes == {"fn": "substring", "entries": len(set(strings) - {None}),
                             "path": path}


def test_substring_passes_are_not_memoized():
    """Two lowerings of one substring over one dictionary each make their
    pass: only the vocabulary's bytes are kept on the dictionary."""
    _, tp = _pages(None)
    e = t_ir.Call(TT.varchar(), "substring", (
        t_ir.ColumnRef(TT.varchar(), ORDER.index("s"), "s"), _c(t_ir, TT, "bigint", 1),
        _c(t_ir, TT, "bigint", 2)))
    v0 = t_M.SUBSTRING_VECTOR_PASSES.value()
    first, second = (t_L.lower(e, t_L.LowerCtx(tp.columns, NULLABLE_ROWS, None, "cpu"))
                     for _ in range(2))
    assert t_M.SUBSTRING_VECTOR_PASSES.value() - v0 == 2
    assert first.dictionary is not second.dictionary
    assert first.dictionary.values == second.dictionary.values
    eq(first.vals, second.vals.numpy())


def test_unported_expression_raises_naming_itself():
    """A function that neither package lowers raises NotImplementedError
    naming itself in both. (Every function of the reference's
    table is ported, the nested ones included, so the case is a name
    outside the table.)"""
    jp, tp = _pages(None)
    for ir, types, ctx in ((j_ir, JT, j_L.LowerCtx(jp.columns, NULLABLE_ROWS, None)),
                           (t_ir, TT, t_L.LowerCtx(tp.columns, NULLABLE_ROWS, None, "cpu"))):
        e = ir.Call(types.BIGINT, "no_such_function",
                    (ir.ColumnRef(types.varchar(), ORDER.index("s"), "s"),))
        with pytest.raises(NotImplementedError, match="no_such_function"):
            (j_L if ir is j_ir else t_L).lower(e, ctx)
