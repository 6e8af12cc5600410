"""The eager executor's dynamic filters (``Executor._collect_dynamic_filters``)
against the JAX package's host extraction: every build gives the same
``Domain`` (kind, values, bounds and their Python types), a range copies a
constant number of bytes and a set its live rows alone, a two-limb decimal
key registers no domain, and two runs of q95 and TPC-H Q18 in one cached
session stage nothing the second time."""
import os
import sys
import types
import zlib
from decimal import Decimal

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
import jax.numpy as jnp  # noqa: E402
from test_torch_sql_both import BothSessions, assert_rows_match  # noqa: E402
from test_torch_tpcds import Q95_WIDE  # noqa: E402
from tpch_sql import QUERIES  # noqa: E402
from trino_tpu import types as JT  # noqa: E402
from trino_tpu.data import page as jax_page  # noqa: E402
from trino_tpu.exec.executor import Executor as JaxExecutor  # noqa: E402

from trino_tpu_torch import Session  # noqa: E402
from trino_tpu_torch import types as T  # noqa: E402
from trino_tpu_torch.data.page import Column, Page  # noqa: E402
from trino_tpu_torch.exec import executor as torch_executor  # noqa: E402
from trino_tpu_torch.exec.executor import Executor  # noqa: E402
from trino_tpu_torch.obs import metrics as M  # noqa: E402

MAX_SET = Executor.DYNAMIC_FILTER_MAX_SET
KEY_TYPES = {"integer": "integer", "bigint": "bigint", "date": "date",
             "decimal": "decimal(12,2)", "double": "double", "double_nan": "double",
             "real": "real", "boolean": "boolean"}
# (padded rows, live rows, what marks the dead ones): live counts 0, 1, 1024
# and 1025, padded lengths on both sides of 1024, a page whose rows are all
# dead, and each of the selection, the nulls, both and neither
SHAPES = [(1024, 0, "sel"), (1024, 1, "nulls"), (1024, 1024, "both"), (3000, 0, "both"),
          (3000, 1, "sel"), (3000, 1024, "nulls"), (3000, 1025, "both"), (3000, 1025, "sel"),
          (0, 0, "none"), (1, 1, "none"), (1024, 1024, "none"), (1025, 1025, "none"),
          (3000, 3000, "none")]


def canonical(dom):
    """A Domain as comparable data: each value's type and repr (so NaN
    equals NaN, and 1 differs from 1.0 and from True)."""
    def one(x):
        return None if x is None else (type(x).__name__, repr(x))

    vals = None if dom.values is None else sorted(one(x) for x in dom.values)
    return (vals, one(dom.low), one(dom.high), dom.low_inclusive, dom.high_inclusive,
            dom.null_allowed)


def executor():
    return Executor(types.SimpleNamespace(properties={}, device=torch.device("cpu")))


def join_node(nkeys, node_id=7):
    return types.SimpleNamespace(id=node_id, dyn_filter_keys=list(range(nkeys)),
                                 right_keys=list(range(nkeys)))


def key_values(name, n, rng):
    if name in ("integer", "date"):
        return rng.integers(-5000, 5000, n).astype(np.int32)
    if name in ("bigint", "decimal"):
        return rng.integers(-(1 << 40), 1 << 40, n)
    if name == "real":
        return (rng.normal(size=n) * 1e3).astype(np.float32)
    if name == "boolean":
        return rng.random(n) < 0.5
    return rng.normal(size=n) * 1e3


def build_arrays(shape, names, seed):
    """A build's key columns as numpy (type, values, nulls) and its
    selection: ``live`` rows of ``n`` live, the dead ones cleared from the
    selection, NULL, or half of each."""
    n, live, marks = shape
    rng = np.random.default_rng(seed)
    alive = np.zeros(n, bool)
    alive[rng.permutation(n)[:live]] = True
    dead = np.flatnonzero(~alive)
    by_nulls = {"sel": dead[:0], "nulls": dead, "both": dead[::2], "none": dead}[marks]
    sel = None
    if marks in ("sel", "both"):
        sel = np.ones(n, bool)
        sel[np.setdiff1d(dead, by_nulls)] = False
    cols = []
    for name in names:
        nulls = None
        if marks in ("nulls", "both"):
            nulls = np.zeros(n, bool)
            nulls[by_nulls] = True
        values = key_values(name, n, rng)
        if name == "double_nan" and live:
            values[np.flatnonzero(alive)[:2]] = np.nan  # live NaNs
            values[dead[:2]] = np.nan
        cols.append((KEY_TYPES[name], values, nulls))
    return cols, sel


def torch_page(cols, sel):
    t = (lambda a: None if a is None else torch.from_numpy(a.copy()))
    return Page([Column(T.parse_type(ty), t(v), t(nl)) for ty, v, nl in cols], t(sel))


def jax_domains(cols, sel, nkeys):
    """The JAX package's domains for the same build: its executor copies
    each key column, the selection and the nulls to the host."""
    j = (lambda a: None if a is None else jnp.asarray(a))
    page = jax_page.Page([jax_page.Column(JT.parse_type(ty), j(v), j(nl)) for ty, v, nl in cols],
                         j(sel))
    ex = JaxExecutor(types.SimpleNamespace(properties={}))
    ex._collect_dynamic_filters(join_node(nkeys), page)
    return [ex.dyn_domains[(7, i)] for i in range(nkeys)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[2]}-{s[0]}rows-{s[1]}live")
@pytest.mark.parametrize("name", list(KEY_TYPES))
def test_the_device_path_gives_the_jax_packages_domains(name, shape):
    """Each build's domains, the key of ``name`` beside a bigint key on the
    same rows (two keys, one read), equal the JAX package's."""
    cols, sel = build_arrays(shape, [name, "bigint"], seed=zlib.crc32(repr((name, shape)).encode()))
    ex = executor()
    ex._collect_dynamic_filters(join_node(2), torch_page(cols, sel))
    got = [ex.dyn_domains[(7, i)] for i in range(2)]
    want = jax_domains(cols, sel, 2)
    assert [canonical(d) for d in got] == [canonical(d) for d in want]
    live = shape[1]
    if live == 0:
        assert got[0].values == frozenset()
    elif live <= MAX_SET:
        assert got[0].values
    else:
        assert got[0].values is None and got[0].low is not None
    if name == "double_nan" and live > MAX_SET:
        assert np.isnan(got[0].low) and np.isnan(got[0].high)
    elif name == "double_nan" and live:
        assert any(np.isnan(x) for x in got[0].values)


def counters():
    return M.DYNAMIC_FILTER_HOST_BYTES.value(), M.DYNAMIC_FILTER_COPIED_KEYS.value()


def collect_deltas(page, nkeys=1):
    before = counters()
    ex = executor()
    ex._collect_dynamic_filters(join_node(nkeys), page)
    return tuple(b - a for a, b in zip(before, counters())), ex.dyn_domains


def test_a_range_copies_a_constant_number_of_bytes_and_a_set_its_live_rows():
    rng = np.random.default_rng(11)
    ranges = []
    for n in (10_000, 1_000_000):
        sel = torch.from_numpy(rng.random(n) < 0.9)
        page = Page([Column(T.BIGINT, torch.from_numpy(rng.integers(0, 1 << 50, n)))], sel)
        (nbytes, copied), doms = collect_deltas(page)
        assert doms[(7, 0)].values is None  # a range
        assert copied == 0
        ranges.append(nbytes)
    assert ranges[0] == ranges[1] > 0
    # a large build whose live rows form a set: the scalars, then those rows
    sel = torch.zeros(5000, dtype=torch.bool)
    sel[::10] = True
    (nbytes, copied), doms = collect_deltas(Page([Column(T.BIGINT, torch.arange(5000))], sel))
    assert copied == 1 and nbytes == ranges[0] + 500 * 8
    assert doms[(7, 0)].values == frozenset(range(0, 5000, 10))
    # a small build alike: its live rows, not its padded column, selection and nulls
    nulls = torch.zeros(500, dtype=torch.bool)
    nulls[:100] = True
    (nbytes, copied), doms = collect_deltas(Page([Column(T.BIGINT, torch.arange(500), nulls)],
                                                 None))
    assert copied == 1 and nbytes == ranges[0] + 400 * 8
    assert doms[(7, 0)].values == frozenset(range(100, 500))
    # a build of no rows copies nothing: its domain is provably empty
    (nbytes, copied), doms = collect_deltas(
        Page([Column(T.BIGINT, torch.zeros(0, dtype=torch.int64))], None))
    assert (nbytes, copied) == (0, 0) and doms[(7, 0)].values == frozenset()


@pytest.mark.parametrize("build_rows", [300, 1500])
def test_a_two_limb_key_registers_no_domain(build_rows, monkeypatch):
    """A decimal(38,0) join key holds its low limb in ``values``: the port
    registers no domain for it, whether the join's other key is a set or a
    range (that key keeps its own), and the join's rows equal the JAX
    package's."""
    big = 1 << 64
    both = BothSessions()
    both.create_table("default", "a", [("k", "decimal(38,0)"), ("g", "bigint"), ("x", "bigint")],
                      [(Decimal(big + i), i % 5, i) for i in range(2000)]
                      + [(Decimal(i), i % 5, 10_000 + i) for i in range(50)])
    both.create_table("default", "b", [("k", "decimal(38,0)"), ("g", "bigint")],
                      [(Decimal(big + 3 * i), (3 * i) % 5) for i in range(build_rows)]
                      + [(Decimal(7), 2)])
    seen = {}
    real = torch_executor.Executor._collect_dynamic_filters

    def spy(self, node, build):
        real(self, node, build)
        seen.update({k: v for k, v in self.dyn_domains.items() if k[0] == node.id})

    monkeypatch.setattr(torch_executor.Executor, "_collect_dynamic_filters", spy)
    want, got, _, _ = both.run("""select count(*), sum(a.x) from memory.default.a a
        join memory.default.b b on a.k = b.k and a.g = b.g""")
    assert_rows_match(got, want, "two-limb join")
    assert got[0][0] == sum(1 for i in range(0, 2000, 3) if i < 3 * build_rows) + 1
    keys = sorted(k for _, k in seen)
    assert keys == [1], seen  # the bigint key alone, not the two-limb one


def test_a_second_run_of_q95_and_q18_stages_nothing():
    """The domains feed the device cache's signature: a changed domain
    would miss on the second run."""
    runs = [(Session({"catalog": "tpcds", "schema": "tiny", "device_cache_enabled": True},
                     device="cpu"), Q95_WIDE),
            (Session({"catalog": "tpch", "schema": "tiny", "device_cache_enabled": True},
                     device="cpu"), QUERIES[18])]
    bytes0 = M.DYNAMIC_FILTER_HOST_BYTES.value()
    for session, sql in runs:
        first = session.execute(sql).rows
        misses = M.DEVICE_CACHE_MISSES.value()
        second = session.execute(sql).rows
        assert M.DEVICE_CACHE_MISSES.value() - misses == 0
        assert second == first and first
    assert M.DYNAMIC_FILTER_HOST_BYTES.value() > bytes0
