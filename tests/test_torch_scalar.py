"""The scalar function families of trino_tpu_torch/ops/expr_lower.py, the
calendar helpers of ops/datetime_ops.py and the int128 helpers of
ops/int128.py, against their JAX counterparts on the same seeded inputs.

Each lowering is built once per package from the same description and
lowered over the same page (the port's made from the JAX page's arrays),
with and without a selection mask. Validity, dtypes, the deferred error
flags and the values of live rows must be equal; doubles within
``rel_tol=1e-12`` (the transcendental functions are libm or SLEEF in the
port and XLA's own approximations in the reference), everything else
exactly. The page holds NULLs, INT64_MIN and INT64_MAX, zero and -1
divisors, NaN and infinities, dates before 1970 and negative timestamps.
"""
import datetime
import math
import time
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
from trino_tpu.ops import int128 as j_i128
from trino_tpu.sql import ir as j_ir

from trino_tpu_torch import types as TT
from trino_tpu_torch.data.page import page_from_numpy
from trino_tpu_torch.ops import datetime_ops as t_dt
from trino_tpu_torch.ops import expr_lower as t_L
from trino_tpu_torch.ops import int128 as t_i128
from trino_tpu_torch.sql import ir as t_ir

REL_TOL = 1e-12
I64_MIN, I64_MAX = -(2**63), 2**63 - 1
EPOCH = datetime.date(1970, 1, 1)
NESTED = {"array_ctor", "cardinality", "subscript", "element_at", "map_subscript",
          "map_element_at", "contains", "array_position", "array_min", "array_max",
          "array_sum", "map_keys", "map_values", "map_ctor", "transform", "any_match",
          "all_match", "none_match", "row_ctor", "row_field"}


def eq(t, j):
    """Exact equality of a port tensor and a JAX array (values and dtype)."""
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ int128
EDGE_WORDS = [0, 1, -1, 2, I64_MIN, I64_MAX, I64_MIN + 1, 10**18, -(10**18), 3 * 10**18,
              -7 * 10**18, 2**32, 2**32 - 1, -(2**32)]


def _words(seed, n=300):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.array(EDGE_WORDS, np.int64),
                           rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64, endpoint=True)])


def test_from_int64_and_fits_int64():
    x = _words(1)
    th, tl = t_i128.from_int64(torch.from_numpy(x))
    jh, jl = j_i128.from_int64(jnp.asarray(x))
    eq(th, jh)
    eq(tl, jl)
    eq(t_i128.fits_int64((th, tl)), j_i128.fits_int64((jh, jl)))
    # a high limb that is not the low word's sign extension does not fit
    hi = _words(2)
    lo = _words(3)
    eq(t_i128.fits_int64((torch.from_numpy(hi), torch.from_numpy(lo))),
       j_i128.fits_int64((jnp.asarray(hi), jnp.asarray(lo))))


@pytest.mark.parametrize("m", [0, 1, 7, 10, 10**9, 10**18, 2**62])
def test_mul_small(m):
    hi, lo = _words(4), _words(5)
    got = t_i128.mul_small((torch.from_numpy(hi), torch.from_numpy(lo)), m)
    want = j_i128.mul_small((jnp.asarray(hi), jnp.asarray(lo)), m)
    eq(got[0], want[0])
    eq(got[1], want[1])
    # against Python integers where the product fits 128 bits
    for h, low, gh, gl in zip(hi.tolist(), lo.tolist(), got[0].tolist(), got[1].tolist()):
        v = (h << 64) | (low & (2**64 - 1))
        if abs(v * m) < 2**127:
            assert (gh << 64) | (gl & (2**64 - 1)) == v * m


# ------------------------------------------------------------ datetime_ops
EDGE_DATES = [datetime.date(*d) for d in (
    (1970, 1, 1), (1969, 12, 31), (1900, 2, 28), (1900, 3, 1), (1600, 2, 29),
    (2000, 2, 29), (2000, 12, 31), (2001, 1, 1), (2004, 12, 31), (2005, 1, 1),
    (2008, 12, 29), (2009, 12, 31), (2010, 1, 3), (2010, 1, 4), (2015, 12, 31),
    (2016, 1, 3), (2020, 12, 31), (2021, 1, 3), (1, 1, 1), (9999, 12, 31),
    (1968, 2, 29), (1992, 3, 31), (1998, 12, 1))]


def _days(seed):
    rng = np.random.default_rng(seed)
    edge = np.array([(d - EPOCH).days for d in EDGE_DATES], np.int64)
    return np.concatenate([edge, rng.integers(-800_000, 800_000, 3000)]).astype(np.int32)


@pytest.mark.parametrize("fn", ["extract_month", "extract_day", "extract_quarter",
                                "extract_dow", "extract_doy", "extract_week"])
def test_extract_helpers_equal_reference(fn):
    d = _days(11)
    eq(getattr(t_dt, fn)(torch.from_numpy(d)), getattr(j_dt, fn)(jnp.asarray(d)))


def test_extract_helpers_agree_with_python_calendar():
    """ISO weeks at the year boundaries and leap days, against datetime."""
    d = np.array([(x - EPOCH).days for x in EDGE_DATES], np.int32)
    t = torch.from_numpy(d)
    week, dow, doy = (getattr(t_dt, f"extract_{f}")(t).tolist() for f in ("week", "dow", "doy"))
    for x, w, dw, dy in zip(EDGE_DATES, week, dow, doy):
        assert (w, dw, dy) == (x.isocalendar()[1], x.isoweekday(), x.timetuple().tm_yday), x


@pytest.mark.parametrize("unit", ["day", "week", "month", "quarter", "year"])
def test_trunc_date_equal_reference(unit):
    d = _days(12)
    eq(t_dt.trunc_date(torch.from_numpy(d), unit), j_dt.trunc_date(jnp.asarray(d), unit))


def test_trunc_date_refuses_unknown_unit():
    with pytest.raises(NotImplementedError):
        t_dt.trunc_date(torch.zeros(1, dtype=torch.int32), "fortnight")


# ------------------------------------------------------------- the page
def _page_data():
    rng = np.random.default_rng(20261017)
    n_rand = 40

    def ints(edge, lo, hi):
        return edge + [int(v) for v in rng.integers(lo, hi, n_rand)]

    i = ints([I64_MIN, I64_MAX, -1, 0, 1, None, -7, 7, I64_MIN, -(10**15)], -1000, 1000)
    j = ints([-1, 1, 0, None, 3, -3, I64_MIN, 2, 5, 1], -9, 10)
    k = ints([0, 63, 64, -1, 1, None, 70, 32, 8, 62], -2, 70)
    x = [0.5, -0.5, 1.0, 0.0, -0.0, float("nan"), float("inf"), float("-inf"), None, 1e300] + \
        [float(v) for v in rng.normal(0, 100, n_rand)]
    y = [2.0, 0.0, -3.0, 1.5, None, 0.25, 1e-300, -0.0, 27.0, -8.0] + \
        [float(v) for v in rng.normal(0, 10, n_rand)]
    m = [Decimal(int(v)).scaleb(-2) for v in rng.integers(-10**9, 10**9, n_rand + 10)]
    m[3], m[5] = None, Decimal("0.00")
    q = [Decimal(int(v)).scaleb(-4) for v in rng.integers(-10**6, 10**6, n_rand + 10)]
    q[2], q[4] = Decimal("0.0000"), None
    big = [Decimal(int(v)).scaleb(-2) for v in rng.integers(-10**15, 10**15, n_rand + 10)]
    big[0], big[1], big[6] = Decimal("1" * 30 + ".01"), None, Decimal("-" + "9" * 25 + ".99")
    day_edge = [(dd - EPOCH).days for dd in EDGE_DATES[:10]]
    d = ints(day_edge, -40_000, 40_000)
    d[4] = None
    d2 = ints([0, -1, 31, None, 59, 365, -366, 10_000, 1, 60], -40_000, 40_000)
    ts = ints([-1, 0, 1, -86_400_000, -86_399_999, None, 1_710_498_645_123, -2_000_000_000_123,
               86_399_999, 999], -(10**13), 10**13)
    ts2 = ints([3_600_000, -1, None, 0, 5, 86_400_001, 1_710_498_645_500, 7, -5, 12],
               -(10**13), 10**13)
    ts6 = ints([-1, 0, None, 1_710_498_645_123_456, -86_400_000_001, 5, -7, 999_999, 1, 2],
               -(10**16), 10**16)
    words = ["hello world", "foo42bar", "", None, "  padded  ", "Ünïcode ß", "a,b,,c",
             '{"a": {"b": [1, 2, 3]}, "s": "txt"}', "[10, 20]", '{"k": true, "n": null}']
    vocab = ["special requests", "quickly", "x7y8", "Customer#000000001", "27-918-335-1736",
             "Clerk#000000951", "forest green puff", "1996-01-02", "ab", "ba"]
    s = words + [vocab[int(v)] for v in rng.integers(0, len(vocab), n_rand)]
    hx = ["6869", "0A1B", "zz", None, "", "DEADBEEF", "abc", "00ff", "41", "4142"] + \
        [rng.choice(["6869", "0a1b", "4142"]) for _ in range(n_rand)]
    h = [b"hi", b"", None, b"\x00\xff", b"abc", b"\xde\xad", b"\x01", b"zz", b"\x7f", b"ok"] + \
        [bytes(rng.integers(0, 256, 3).astype(np.uint8)) for _ in range(n_rand)]
    return {"i": ("bigint", i), "j": ("bigint", j), "k": ("bigint", k),
            "x": ("double", x), "y": ("double", y), "m": ("decimal(12,2)", m),
            "q": ("decimal(10,4)", q), "big": ("decimal(38,2)", big),
            "d": ("date", d), "d2": ("date", d2), "ts": ("timestamp(3)", ts),
            "ts2": ("timestamp(3)", ts2), "ts6": ("timestamp(6)", ts6),
            "s": ("varchar", s), "hx": ("varchar", hx), "h": ("varbinary", h)}


DATA = _page_data()
ORDER = list(DATA)
N = len(DATA["i"][1])


def _parse(types, tname):
    return types.varchar() if tname == "varchar" else types.parse_type(tname)


def _pages():
    jp = JaxPage.from_pydict({c: _parse(JT, t) for c, (t, _) in DATA.items()},
                             {c: v for c, (_, v) in DATA.items()})
    return jp, page_from_numpy(jp.columns, device="cpu")


def lower_both(build, sel=None):
    """(port LoweredVal, JAX LoweredVal, port errors, JAX errors)."""
    jp, tp = _pages()

    def env(ir, types):
        def col(name):
            return ir.ColumnRef(_parse(types, DATA[name][0]), ORDER.index(name), name)

        def c(tname, v):
            return ir.Constant(_parse(types, tname), v)

        def call(tname, name, *args):
            return ir.Call(_parse(types, tname), name, tuple(args))

        return col, c, call, ir, types

    ej = build(*env(j_ir, JT))
    et = build(*env(t_ir, TT))
    jctx = j_L.LowerCtx(jp.columns, N, None if sel is None else jnp.asarray(sel))
    tctx = t_L.LowerCtx(tp.columns, N, None if sel is None else torch.from_numpy(sel), "cpu")
    lj = j_L.lower(ej, jctx)
    lt = t_L.lower(et, tctx)
    errs = lambda ctx: [(c, bool(np.asarray(f.cpu() if hasattr(f, "cpu") else f)))  # noqa: E731
                        for c, f in ctx.errors]
    return lt, lj, errs(tctx), errs(jctx)


def _decoded(lv, n):
    vals = lv.vals.numpy() if isinstance(lv.vals, torch.Tensor) else np.asarray(lv.vals)
    if lv.dictionary is None:
        return vals
    return np.array([None if c < 0 else lv.dictionary.values[c] for c in vals.tolist()],
                    dtype=object)


def check(lt, lj, et, ej, same_dictionary=True):
    assert et == ej, f"error flags {et} != the reference's {ej}"
    tv = None if lt.valid is None else lt.valid.numpy()
    jv = None if lj.valid is None else np.asarray(lj.valid)
    assert (tv is None) == (jv is None)
    if tv is not None:
        np.testing.assert_array_equal(tv, jv)
    live = np.ones(N, bool) if tv is None else tv
    assert (lt.hi is None) == (lj.hi is None)
    assert (lt.dictionary is None) == (lj.dictionary is None)
    if lt.dictionary is not None and same_dictionary:
        assert lt.dictionary.values == lj.dictionary.values
    assert lt.vals.numpy().dtype == np.asarray(lj.vals).dtype
    a, b = _decoded(lt, N)[live], _decoded(lj, N)[live]
    if lt.hi is not None:
        np.testing.assert_array_equal(lt.hi.numpy()[live], np.asarray(lj.hi)[live])
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        np.testing.assert_allclose(a[ok], b[ok], rtol=REL_TOL, atol=0)
        np.testing.assert_array_equal(np.signbit(a[ok & (a == 0)]), np.signbit(b[ok & (b == 0)]))
    else:
        np.testing.assert_array_equal(a, b)


def B(tname, name, *args):
    """The IR of ``name(args...)`` with result type ``tname``, made per package; an arg is
    a column name, or (type, value) for a constant."""
    def build(col, c, call, ir, types):
        def arg(a):
            return col(a) if isinstance(a, str) else c(*a)
        return call(tname, name, *map(arg, args))
    return build


def CAST(tname, src):
    def build(col, c, call, ir, types):
        return ir.Cast(_parse(types, tname), col(src))
    return build


V = lambda s: ("varchar", s)  # noqa: E731
BI = lambda v: ("bigint", v)  # noqa: E731

NUMERIC = {
    "mod_bigint": B("bigint", "mod", "i", "j"),
    "mod_by_literal": B("bigint", "mod", "i", BI(5)),
    "mod_decimal": B("decimal(12,4)", "mod", "m", "q"),
    "mod_decimal_int": B("decimal(12,2)", "mod", "m", "j"),
    "mod_long_decimal": B("decimal(38,2)", "mod", "big", "m"),
    "mod_double": B("double", "mod", "x", "y"),
    "mod_decimal_double": B("double", "mod", "m", "y"),
    "abs_bigint": B("bigint", "abs", "i"),
    "abs_double": B("double", "abs", "x"),
    "abs_decimal": B("decimal(12,2)", "abs", "m"),
    "abs_long_decimal": B("decimal(38,2)", "abs", "big"),
    "truncate_double": B("double", "truncate", "x"),
    "truncate_double_2": B("double", "truncate", "y", BI(2)),
    "truncate_decimal": B("decimal(12,2)", "truncate", "m"),
    "truncate_decimal_1": B("decimal(12,2)", "truncate", "m", BI(1)),
    "truncate_decimal_neg": B("decimal(12,2)", "truncate", "m", BI(-2)),
    "truncate_bigint": B("bigint", "truncate", "i"),
    "atan2": B("double", "atan2", "x", "y"),
    "sign_double": B("double", "sign", "x"),
    "sign_bigint": B("bigint", "sign", "i"),
    "nullif_bigint": B("bigint", "nullif", "i", "j"),
    "nullif_double": B("double", "nullif", "x", "y"),
    "nullif_varchar": B("varchar", "nullif", "s", V("ab")),
    "coalesce_bigint": B("bigint", "coalesce", "i", "j", BI(-5)),
    "coalesce_double": B("double", "coalesce", "x", "y"),
    "coalesce_decimal": B("decimal(38,2)", "coalesce", "big", "m"),
    "coalesce_all_valid_first": B("bigint", "coalesce", BI(3), "i"),
    "is_nan": B("boolean", "is_nan", "x"),
    "is_finite": B("boolean", "is_finite", "x"),
    "is_infinite": B("boolean", "is_infinite", "x"),
    "bit_count": B("bigint", "bit_count", "i"),
    "bitwise_and": B("bigint", "bitwise_and", "i", "j"),
    "bitwise_or": B("bigint", "bitwise_or", "i", "j"),
    "bitwise_xor": B("bigint", "bitwise_xor", "i", "j"),
    "bitwise_not": B("bigint", "bitwise_not", "i"),
    "bitwise_left_shift": B("bigint", "bitwise_left_shift", "i", "k"),
    "bitwise_right_shift": B("bigint", "bitwise_right_shift", "i", "k"),
    "cast_long_decimal_to_double": CAST("double", "big"),
    "cast_long_decimal_to_bigint": CAST("bigint", "big"),
    "lt_long_decimal_double": B("boolean", "lt", "big", "x"),
}
for _fn in ("sqrt", "cbrt", "ln", "log2", "log10", "exp", "sin", "cos", "tan", "asin", "acos",
            "atan", "sinh", "cosh", "tanh", "degrees", "radians"):
    NUMERIC[_fn] = B("double", _fn, "x")
    NUMERIC[f"{_fn}_of_y"] = B("double", _fn, "y")
NUMERIC["log10_decimal"] = B("double", "log10", "m")

DATETIME = {
    **{f"extract_{f}_date": B("bigint", f"extract_{f}", "d")
       for f in ("year", "month", "day", "quarter", "dow", "doy", "week")},
    **{f"extract_{f}_ts": B("bigint", f"extract_{f}", "ts")
       for f in ("year", "month", "day", "quarter", "dow", "doy", "week", "hour", "minute",
                 "second")},
    **{f"extract_{f}_ts6": B("bigint", f"extract_{f}", "ts6") for f in ("hour", "second", "day")},
    "date_add_months_ts": B("timestamp(3)", "date_add_months", "ts", BI(13)),
    "date_add_months_ts_neg": B("timestamp(3)", "date_add_months", "ts", BI(-1)),
    "date_diff_days": B("bigint", "date_diff_days", "d", "d2", BI(1)),
    "date_diff_weeks": B("bigint", "date_diff_days", "d", "d2", BI(7)),
    "ts_diff_hours": B("bigint", "ts_diff_units", "ts", "ts2", BI(3_600_000)),
    "ts_diff_ms": B("bigint", "ts_diff_units", "ts", "ts2", BI(1)),
    "months_between": B("bigint", "months_between", "d", "d2", BI(1)),
    "years_between": B("bigint", "months_between", "d", "d2", BI(12)),
    "seconds_to_ts3": B("timestamp(3)", "seconds_to_ts3", "y"),
    **{f"date_trunc_{u}": B("date", "date_trunc", V(u), "d")
       for u in ("day", "week", "month", "quarter", "year")},
    "date_trunc_upper_unit": B("date", "date_trunc", V("MONTH"), "d"),
    "last_day_of_month": B("date", "last_day_of_month", "d"),
    "date_format": B("varchar", "date_format", "d", V("%Y/%m/%d %W %j %e")),
    "day_name": B("varchar", "day_name", "d"),
    "month_name": B("varchar", "month_name", "d"),
    "cast_ts3_ts0": CAST("timestamp(0)", "ts"),
    "cast_ts6_ts3": CAST("timestamp(3)", "ts6"),
    "cast_ts3_ts6": CAST("timestamp(6)", "ts"),
    "cast_ts3_tz": CAST("timestamp(3) with time zone", "ts"),
    "cast_date_ts3": CAST("timestamp(3)", "d"),
    "cast_ts3_date": CAST("date", "ts"),
    "cast_ts6_date": CAST("date", "ts6"),
    "ts_lt_ts6": B("boolean", "lt", "ts", "ts6"),
    "date_le_ts": B("boolean", "le", "d", "ts"),
}

STRINGS = {
    "lower": B("varchar", "lower", "s"),
    "upper": B("varchar", "upper", "s"),
    "trim": B("varchar", "trim", "s"),
    "ltrim": B("varchar", "ltrim", "s"),
    "rtrim": B("varchar", "rtrim", "s"),
    "length": B("bigint", "length", "s"),
    "length_varbinary": B("bigint", "length", "h"),
    "concat": B("varchar", "concat", V("<"), "s", V(">")),
    "concat_typed_constants": B("varchar", "concat", V("x="), ("decimal(3,2)", 125),
                                ("date", 9204), ("boolean", True), BI(-4)),
    "concat_null": B("varchar", "concat", "s", ("varchar", None)),
    "replace": B("varchar", "replace", "s", V("o"), V("0")),
    "replace_remove": B("varchar", "replace", "s", V("e")),
    "reverse": B("varchar", "reverse", "s"),
    "strpos": B("bigint", "strpos", "s", V("r")),
    "starts_with": B("boolean", "starts_with", "s", V("Cu")),
    "regexp_like": B("boolean", "regexp_like", "s", V("[0-9]+")),
    "regexp_extract": B("varchar", "regexp_extract", "s", V("([a-z]+)([0-9]+)")),
    "regexp_extract_group": B("varchar", "regexp_extract", "s", V("([a-z]+)([0-9]+)"), BI(2)),
    "regexp_extract_optional_group": B("varchar", "regexp_extract", "s", V("x(q)?"), BI(1)),
    "regexp_replace": B("varchar", "regexp_replace", "s", V("([a-z])([0-9])"), V("$2$1")),
    "regexp_replace_delete": B("varchar", "regexp_replace", "s", V("[aeiou]")),
    "regexp_count": B("bigint", "regexp_count", "s", V("[a-z]")),
    "lpad": B("varchar", "lpad", "s", BI(12), V("*-")),
    "rpad": B("varchar", "rpad", "s", BI(5)),
    "split_part": B("varchar", "split_part", "s", V(","), BI(2)),
    "split_part_out_of_range": B("varchar", "split_part", "s", V(" "), BI(3)),
    "translate": B("varchar", "translate", "s", V("lo#"), V("LO")),
    "repeat_str": B("varchar", "repeat_str", "s", BI(2)),
    "chr": B("varchar", "chr", BI(955)),
    "codepoint": B("bigint", "codepoint", "s"),
    "hamming_distance": B("bigint", "hamming_distance", "s", V("ab")),
    "levenshtein_distance": B("bigint", "levenshtein_distance", "s", V("request")),
    "json_extract_scalar": B("varchar", "json_extract_scalar", "s", V("$.a.b[2]")),
    "json_extract_scalar_bool": B("varchar", "json_extract_scalar", "s", V("$['k']")),
    "json_extract_scalar_field": B("varchar", "json_extract_scalar", "s", V("$.s")),
    "json_array_length": B("bigint", "json_array_length", "s"),
    "date_parse": B("date", "date_parse", "s", V("%Y-%m-%d")),
    "to_hex": B("varchar", "to_hex", "h"),
    "from_hex": B("varbinary", "from_hex", "hx"),
    "to_utf8": B("varbinary", "to_utf8", "s"),
    "from_utf8": B("varchar", "from_utf8", "h"),
    "md5": B("varbinary", "md5", "h"),
    "sha256": B("varbinary", "sha256", "h"),
    "cast_varchar_varbinary": CAST("varbinary", "s"),
    "cast_varbinary_varchar": CAST("varchar", "h"),
    "coalesce_varchar_one_dictionary": B("varchar", "coalesce", "s", "s"),
}
CASES = {**NUMERIC, **DATETIME, **STRINGS}
SEL = np.arange(N) % 3 != 1


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("with_sel", [False, True])
def test_lowering_equals_reference(name, with_sel):
    check(*lower_both(CASES[name], SEL if with_sel else None))


def test_int64_min_edges_of_mod_abs_truncate():
    """mod, abs and truncate on INT64_MIN, -1 and 0 (the reference's
    sign(a) * mod(|a|, |b|) form: no truncating division, which traps on
    the CPU), with values spelled out. |INT64_MIN| wraps to itself, as in
    Java's Math.abs."""
    lt, _, _, _ = lower_both(B("bigint", "mod", "i", "j"))
    got = lt.vals.tolist()
    assert got[0] == 0 and got[1] == 0 and got[2] == 0  # INT64_MIN % -1, MAX % 1, -1 % 0
    assert got[6] == 2**63 - 7 and got[7] == 1  # -7 % INT64_MIN (wrapped), 7 % 2
    lt, _, _, _ = lower_both(B("bigint", "mod", "i", BI(5)))
    assert lt.vals.tolist()[:5] == [-2, 2, -1, 0, 1]  # INT64_MIN: |a| wraps, as the reference
    lt, _, _, _ = lower_both(B("bigint", "abs", "i"))
    assert lt.vals.tolist()[:5] == [I64_MIN, I64_MAX, 1, 0, 1]
    lt, _, _, _ = lower_both(B("bigint", "truncate", "i"))
    assert lt.vals.tolist()[:5] == [I64_MIN, I64_MAX, -1, 0, 1]


def test_division_by_zero_in_mod_is_deferred_and_masked():
    _, _, et, _ = lower_both(B("bigint", "mod", "i", "j"))
    assert ("DIVISION_BY_ZERO", True) in et
    sel = np.array([v != 0 for v in DATA["j"][1]])  # every zero divisor filtered out
    _, _, et, _ = lower_both(B("bigint", "mod", "i", "j"), sel)
    assert ("DIVISION_BY_ZERO", False) in et


def test_bitwise_shifts_are_logical_and_bounded():
    lt, _, _, _ = lower_both(B("bigint", "bitwise_right_shift", "i", BI(1)))
    assert lt.vals.tolist()[:4] == [2**62, 2**62 - 1, 2**63 - 1, 0]
    lt, _, _, _ = lower_both(B("bigint", "bitwise_right_shift", "i", BI(63)))
    assert lt.vals.tolist()[:4] == [1, 0, 1, 0]
    lt, _, et, _ = lower_both(B("bigint", "bitwise_right_shift", "i", "k"))
    assert lt.vals.tolist()[:3] == [I64_MIN, 0, 0]  # shifts of 0, 63 and 64
    assert ("INVALID_FUNCTION_ARGUMENT", True) in et  # -1 as a shift amount
    lt, _, _, _ = lower_both(B("bigint", "bit_count", "i"))
    assert lt.vals.tolist()[:5] == [1, 63, 64, 0, 1]


def test_log10_is_exact_on_powers_of_ten():
    """log10(10^k) = k for every normal power of ten, as numpy gives."""
    ks = np.arange(-307, 309)
    x = torch.from_numpy(np.array([float(f"1e{k}") for k in ks]))
    got = t_L._log10(x).numpy()
    np.testing.assert_array_equal(got, ks.astype(np.float64))
    np.testing.assert_array_equal(got, np.log10(x.numpy()))
    rng = np.random.default_rng(3)
    y = np.concatenate([rng.lognormal(0, 30, 2000), [0.0, -1.0, np.inf, np.nan, 5e-324]])
    with np.errstate(divide="ignore", invalid="ignore"):
        np.testing.assert_array_equal(t_L._log10(torch.from_numpy(y)).numpy(), np.log10(y))


def test_cbrt_of_cubes_is_exact():
    x = torch.tensor([27.0, -8.0, 1e-300, 0.0, -0.0, float("inf"), 1000.0, 3.375],
                     dtype=torch.float64)
    got = t_L._cbrt(x).tolist()
    assert got[:2] == [3.0, -2.0] and got[6:] == [10.0, 1.5]
    assert math.copysign(1, got[4]) == -1 and got[5] == float("inf")


def test_date_table_bounded_by_value_range():
    """A column with a static range takes a table of just that range; a
    live date outside it raises INVALID_FUNCTION_ARGUMENT, as in the
    reference."""
    jp, tp = _pages()
    col = ORDER.index("d")
    for vr in ((-12_000, 12_000), (0, 100)):
        jp.columns[col].vrange = vr
        tp.columns[col].vrange = vr
        ej = j_ir.Call(JT.varchar(), "day_name",
                       (j_ir.ColumnRef(JT.DATE, col, "d"),))
        et = t_ir.Call(TT.varchar(), "day_name", (t_ir.ColumnRef(TT.DATE, col, "d"),))
        jctx, tctx = j_L.LowerCtx(jp.columns, N), t_L.LowerCtx(tp.columns, N, None, "cpu")
        lj, lt = j_L.lower(ej, jctx), t_L.lower(et, tctx)
        check(lt, lj, [(c, bool(f)) for c, f in tctx.errors],
              [(c, bool(np.asarray(f))) for c, f in jctx.errors])


def test_every_ported_function_is_exercised():
    """Each non-comparison function the port gained is built by a case."""
    names = set()

    def walk(e):
        if isinstance(e, t_ir.Call):
            names.add(e.name)
            for a in e.args:
                walk(a)
        elif isinstance(e, t_ir.Cast):
            walk(e.value)

    for build in CASES.values():
        col = lambda n: t_ir.ColumnRef(_parse(TT, DATA[n][0]), ORDER.index(n), n)  # noqa: E731
        walk(build(col, lambda t, v: t_ir.Constant(_parse(TT, t), v),
                   lambda t, n, *a: t_ir.Call(_parse(TT, t), n, tuple(a)), t_ir, TT))
    new = set(t_L.FUNCTIONS) - set(j_L.FUNCTIONS) | (
        set(j_L.FUNCTIONS) - NESTED - {"eq", "ne", "lt", "le", "gt", "ge", "add", "sub", "mul",
                                       "div", "and", "or", "not", "is_null", "between",
                                       "in_list", "like", "substring", "negate", "ln",
                                       "log_b", "exp", "power", "sign", "round", "ceil",
                                       "ceiling", "floor", "greatest", "least",
                                       "date_add_months", "random", "now", "current_date"})
    assert new - names == set()


def test_port_has_every_reference_function():
    """Every function of the reference's table is ported, the nested ones
    (NESTED) included."""
    assert set(j_L.FUNCTIONS) == set(t_L.FUNCTIONS)
    assert NESTED <= set(t_L.FUNCTIONS)


# ----------------------------------------------------- the nested functions
def _nested_data():
    """One seeded page of nested columns: NULL rows, NULL elements, empty
    arrays and maps, a NULL row value, subscripts in and out of range."""
    rng = np.random.default_rng(20261018)
    n = 60
    words = ["ab", "cd", "ef", "gh", "ij"]

    def maybe(v, p=0.1):
        return None if rng.random() < p else v

    xs = [maybe([maybe(int(v)) for v in rng.integers(-9, 10, rng.integers(0, 6))], 0.12)
          for _ in range(n)]
    ys = [maybe([maybe(words[int(v)]) for v in rng.integers(0, 5, rng.integers(0, 4))])
          for _ in range(n)]
    m = [maybe({words[int(k)]: maybe(int(v)) for k, v in zip(rng.integers(0, 5, 3),
                                                           rng.integers(-50, 50, 3))})
         for _ in range(n)]
    r = [maybe((maybe(int(a)), words[int(b)])) for a, b in zip(rng.integers(-5, 5, n),
                                                            rng.integers(0, 5, n))]
    i = [maybe(int(v), 0.05) for v in rng.integers(-7, 8, n)]
    s = [maybe(words[int(v)] if v < 5 else "zz", 0.05) for v in rng.integers(0, 6, n)]
    return {"xs": ("array(bigint)", xs), "ys": ("array(varchar)", ys),
            "m": ("map(varchar, bigint)", m), "r": ("row(a bigint, b varchar)", r),
            "i": ("bigint", i), "s": ("varchar", s)}


NESTED_DATA = _nested_data()
NESTED_ORDER = list(NESTED_DATA)
N_NESTED = len(NESTED_DATA["i"][1])


def _nested_builds(types, ir):
    """The IR of each nested function over the page, for one package."""
    def col(name):
        return ir.ColumnRef(_parse(types, NESTED_DATA[name][0]), NESTED_ORDER.index(name), name)

    def call(tname, name, *args):
        return ir.Call(_parse(types, tname), name, tuple(args))

    def lam(tname, body):
        return ir.Lambda(_parse(types, tname), body, 1)

    elem = ir.ColumnRef(types.BIGINT, 0, "x")
    seven = ir.Constant(types.BIGINT, 7)
    return {
        "array_ctor": call("array(bigint)", "array_ctor", col("i"), seven, col("i")),
        "cardinality": call("bigint", "cardinality", col("xs")),
        "subscript": call("bigint", "subscript", col("xs"), col("i")),
        "element_at": call("bigint", "element_at", col("xs"), col("i")),
        "map_subscript": call("bigint", "map_subscript", col("m"), col("s")),
        "map_element_at": call("bigint", "map_element_at", col("m"), col("s")),
        "contains": call("boolean", "contains", col("xs"), col("i")),
        "array_position": call("bigint", "array_position", col("xs"), col("i")),
        "array_min": call("bigint", "array_min", col("xs")),
        "array_max": call("bigint", "array_max", col("xs")),
        "array_sum": call("bigint", "array_sum", col("xs")),
        "map_keys": call("array(varchar)", "map_keys", col("m")),
        "map_values": call("array(bigint)", "map_values", col("m")),
        "map_ctor": call("map(varchar, bigint)", "map_ctor", col("ys"), col("xs")),
        "transform": call("array(bigint)", "transform", col("xs"),
                          lam("bigint", call("bigint", "mul", elem, seven))),
        "any_match": call("boolean", "any_match", col("xs"),
                          lam("boolean", call("boolean", "gt", elem, ir.Constant(types.BIGINT, 2)))),
        "all_match": call("boolean", "all_match", col("xs"),
                          lam("boolean", call("boolean", "gt", elem, ir.Constant(types.BIGINT, -5)))),
        "none_match": call("boolean", "none_match", col("xs"),
                           lam("boolean", call("boolean", "lt", elem, seven))),
        "row_ctor": call("row(a bigint, b varchar)", "row_ctor", col("i"), col("s")),
        "row_field": call("varchar", "row_field", col("r"), ir.Constant(types.BIGINT, 2)),
    }


@pytest.mark.parametrize("name", sorted(NESTED))
def test_nested_function_matches_reference(name):
    """Each nested function lowered over the same seeded nested page in
    both packages, with a selection mask: the same error flags, validity
    and dtype, and the same Python values once made a column (children
    recursively)."""
    from trino_tpu.exec.executor import _col_from_lowered as j_col

    from trino_tpu_torch.exec.executor import _col_from_lowered as t_col

    jp = JaxPage.from_pydict({c: _parse(JT, t) for c, (t, _) in NESTED_DATA.items()},
                             {c: v for c, (_, v) in NESTED_DATA.items()})
    tp = page_from_numpy(jp.columns, device="cpu")
    sel = np.random.default_rng(3).random(N_NESTED) < 0.85
    ej, et = _nested_builds(JT, j_ir)[name], _nested_builds(TT, t_ir)[name]
    jctx = j_L.LowerCtx(jp.columns, N_NESTED, jnp.asarray(sel))
    tctx = t_L.LowerCtx(tp.columns, N_NESTED, torch.from_numpy(sel), "cpu")
    lj, lt = j_L.lower(ej, jctx), t_L.lower(et, tctx)
    errs = lambda ctx: [(c, bool(np.asarray(f.cpu() if hasattr(f, "cpu") else f)))  # noqa: E731
                        for c, f in ctx.errors]
    assert errs(tctx) == errs(jctx)
    assert lt.vals.numpy().dtype == np.asarray(lj.vals).dtype
    assert (lt.valid is None) == (lj.valid is None)
    if lt.valid is not None:
        np.testing.assert_array_equal(lt.valid.numpy(), np.asarray(lj.valid))
    assert (lt.children is None) == (lj.children is None)
    got, want = t_col(et.type, lt).to_python(), j_col(ej.type, lj).to_python()
    assert [g for g, keep in zip(got, sel) if keep] == [w for w, keep in zip(want, sel) if keep]


# ------------------------------------------------------- nondeterministic
def test_random_draws_on_the_context_device_from_its_generator():
    _, tp = _pages()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    e = t_ir.Call(TT.DOUBLE, "random", ())
    a = t_L.lower(e, t_L.LowerCtx(tp.columns, N, None, "cpu", gen)).vals
    gen.manual_seed(7)
    b = t_L.lower(e, t_L.LowerCtx(tp.columns, N, None, "cpu", gen)).vals
    assert a.shape == (N,) and a.dtype == torch.float64 and a.device.type == "cpu"
    assert bool(((a >= 0) & (a < 1)).all()) and torch.equal(a, b)
    assert len(set(a.tolist())) == N


def test_now_and_current_date_follow_the_host_clock():
    _, tp = _pages()
    ctx = t_L.LowerCtx(tp.columns, N, None, "cpu")
    before = time.time()
    now = t_L.lower(t_ir.Call(TT.parse_type("timestamp(3)"), "now", ()), ctx)
    today = t_L.lower(t_ir.Call(TT.DATE, "current_date", ()), ctx)
    after = time.time()
    ms = now.vals.tolist()
    assert len(set(ms)) == 1 and before * 1000 - 1 <= ms[0] <= after * 1000 + 1
    assert now.vals.dtype == torch.int64 and today.vals.dtype == torch.int32
    assert abs(today.vals[0].item() - int(time.time() // 86_400)) <= 1


# ----------------------------------------------------- timestamp storage
def test_timestamp_type_parsing_equals_reference():
    for name in ("timestamp(3)", "timestamp", "timestamp(0)", "timestamp(9) with time zone"):
        t, j = TT.parse_type(name), JT.parse_type(name)
        assert (str(t), t.precision, t.with_tz) == (str(j), j.precision, j.with_tz)
    with pytest.raises(ValueError):
        TT.timestamp(12)


def test_timestamp_repr_round_trip_equals_reference():
    """The port's storage coders against the JAX package's, at every
    precision, before 1970 too (floor semantics), as the reference's
    tests/test_type_breadth.py checks its own against datetime."""
    from trino_tpu.data.page import _from_repr, _to_repr

    from trino_tpu_torch.data.page import _repr_decoder, _repr_encoder

    cases = [datetime.datetime(1969, 12, 31, 23, 59, 59, 750000), datetime.datetime(1970, 1, 1),
             datetime.datetime(2024, 3, 15, 10, 30, 45, 123456), datetime.datetime(1901, 7, 4, 1, 2, 3),
             "2024-03-15 10:00:00", datetime.date(1969, 7, 20)]
    for p in (0, 3, 6, 9):
        for tz in (False, True):
            tt, jt = TT.timestamp(p, tz), JT.timestamp(p, tz)
            for v in cases:
                r = _repr_encoder(tt)(v)
                assert r == _to_repr(jt, v), (p, v)
                assert _repr_decoder(tt)(r) == _from_repr(jt, r), (p, v)
