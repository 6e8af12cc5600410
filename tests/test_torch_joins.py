"""The port's M:N expansion (ops/join.py ``expand``), count(DISTINCT)
(ops/aggregate.py ``agg_count_distinct``), page concatenation and the
int128 operations the long-decimal expressions reach, against their JAX
counterparts on the same seeded inputs. All comparisons are exact."""
import numpy as np
import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
import jax.numpy as jnp
from trino_tpu import types as JT
from trino_tpu.data.page import Page as JaxPage
from trino_tpu.ops import aggregate as j_agg
from trino_tpu.ops import groupby as j_gb
from trino_tpu.ops import int128 as j_i128
from trino_tpu.ops import join as j_join
from trino_tpu.ops import segments as j_seg

from trino_tpu_torch.data.page import Page as TorchPage
from trino_tpu_torch.data.page import page_from_numpy
from trino_tpu_torch.ops import aggregate as t_agg
from trino_tpu_torch.ops import groupby as t_gb
from trino_tpu_torch.ops import int128 as t_i128
from trino_tpu_torch.ops import join as t_join
from trino_tpu_torch.ops import segments as t_seg


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.array(a))


def eq(t, j):
    """Exact equality of a port tensor and a JAX array (values and dtype)."""
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def rng():
    return np.random.default_rng(20261016)


# ------------------------------------------------------------------ expand
def _counts(rng, case):
    if case == "empty":
        return np.zeros(0, np.int32)
    if case == "all_miss":
        return np.zeros(300, np.int32)
    c = rng.integers(0, 5, 300).astype(np.int32)
    c[rng.random(300) < 0.4] = 0
    return c


@pytest.mark.parametrize("case", ["mixed", "empty", "all_miss"])
@pytest.mark.parametrize("pad", [0, 37])
def test_expand_matches_reference(rng, case, pad):
    """The exact total as capacity (the eager executor's sizing) and a
    padded capacity with a dead tail."""
    c = _counts(rng, case)
    capacity = max(int(c.sum()), 1) + pad
    p_t, k_t, live_t, tot_t = t_join.expand(T(c), capacity)
    p_j, k_j, live_j, tot_j = j_join.expand(J(c), capacity)
    assert int(tot_t) == int(tot_j) == int(c.sum())
    eq(live_t, live_j)
    lv = np.asarray(live_j)
    # live slots carry the same (probe row, ordinal); dead slots are unused
    eq(p_t[T(lv)], np.asarray(p_j).astype(np.int64)[lv])
    eq(k_t[T(lv)], np.asarray(k_j)[lv])


def test_expand_total_past_int32():
    """Match counts whose total passes 2^31 (a large self-join's
    expansion): the total and the slots below the capacity stay exact."""
    c = np.array([3, 2**31 - 2, 0, 7], np.int32)
    p_t, k_t, live_t, tot_t = t_join.expand(T(c), 8)
    p_j, k_j, live_j, tot_j = j_join.expand(J(c), 8)
    assert int(tot_t) == int(tot_j) == 2**31 + 8
    eq(live_t, live_j)
    eq(p_t, np.asarray(p_j).astype(np.int64))
    eq(k_t, k_j)


def test_expand_probe_major_order(rng):
    c = np.array([2, 0, 3, 1], np.int32)
    p, k, live, total = t_join.expand(T(c), 6)
    assert p.tolist() == [0, 0, 2, 2, 2, 3] and k.tolist() == [0, 1, 0, 1, 2, 0]
    assert live.all() and int(total) == 6


def test_probe_counts_then_expand_on_duplicate_build(rng):
    """probe_counts + expand over a build with duplicate keys and NULLs:
    the (probe row, build row) pairs of both packages are equal."""
    nb, np_ = 120, 200
    bk = rng.integers(0, 40, nb).astype(np.int32)
    bvalid = rng.random(nb) > 0.1
    pk = rng.integers(0, 50, np_).astype(np.int32)
    psel = rng.random(np_) > 0.2
    b_t = t_join.build_side([(T(bk), T(bvalid))], None)
    b_j = j_join.build_side([(J(bk), J(bvalid))], None)
    lo_t, c_t = t_join.probe_counts(b_t, [(T(pk), None)], T(psel))
    lo_j, c_j = j_join.probe_counts(b_j, [(J(pk), None)], J(psel))
    eq(c_t, c_j)
    cap = int(np.asarray(c_j).sum())
    p_t, k_t, _, _ = t_join.expand(c_t, cap)
    p_j, k_j, _, _ = j_join.expand(c_j, cap)
    rows_t = b_t.rows[(lo_t[p_t] + k_t).long()]
    rows_j = np.asarray(b_j.rows)[np.asarray(lo_j)[np.asarray(p_j)] + np.asarray(k_j)]
    eq(rows_t, rows_j)


# -------------------------------------------------------- count(DISTINCT)
@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("with_sel", [False, True])
def test_count_distinct_matches_reference(rng, direct, with_sel):
    n = 400
    k = rng.integers(0, 6, n).astype(np.int32)
    x = rng.integers(0, 9, n).astype(np.int64)
    xvalid = rng.random(n) > 0.15
    sel = (rng.random(n) > 0.3) if with_sel else None
    tsel = None if sel is None else T(sel)
    jsel = None if sel is None else J(sel)
    if direct:
        lay_t = t_seg.direct_layout(T(k), 6, tsel)
        lay_j = j_seg.direct_layout(J(k), 6, jsel)
    else:
        o_t, g_t, n_t, _ = t_gb.group_plan([(T(k), None)], tsel)
        o_j, g_j, n_j, _ = j_gb.group_plan([(J(k), None)], jsel)
        lay_t = t_seg.sorted_layout(o_t, g_t, n_t)
        lay_j = j_seg.sorted_layout(o_j, g_j, n_j)
        eq(lay_t.gids_orig(), lay_j.gids_orig())
    cnt_t, v_t = t_agg.agg_count_distinct(lay_t, (T(x), T(xvalid)), tsel)
    cnt_j, v_j = j_agg.agg_count_distinct(lay_j, (J(x), J(xvalid)), jsel)
    assert v_t is None and v_j is None
    eq(cnt_t, cnt_j)


# ------------------------------------------------------------ concat_pages
def test_concat_pages_merges_dictionaries():
    a = JaxPage.from_pydict({"s": JT.varchar(), "k": JT.BIGINT},
                            {"s": ["b", None, "d"], "k": [1, 2, None]})
    b = JaxPage.from_pydict({"s": JT.varchar(), "k": JT.BIGINT},
                            {"s": ["a", "d"], "k": [5, 6]})
    b.sel = J(np.array([True, False]))
    ref = JaxPage.concat_pages(a, b)
    got = TorchPage.concat_pages(page_from_numpy(a.columns, device="cpu"),
                                 page_from_numpy(b.columns, np.asarray(b.sel), device="cpu"))
    eq(got.sel, ref.sel)
    for gc, rc in zip(got.columns, ref.columns):
        eq(gc.values, rc.values)
        assert (gc.dictionary is None) == (rc.dictionary is None)
        if gc.dictionary is not None:
            assert gc.dictionary.values == rc.dictionary.values
    assert got.to_pylist() == ref.to_pylist()


# ------------------------------------------------------------------ int128
def test_int128_mul_checked_and_divmod_u128(rng):
    n = 300
    a = (T(rng.integers(-2**62, 2**62, n, dtype=np.int64)),
         T(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)))
    small = rng.integers(-2**40, 2**40, n, dtype=np.int64)
    b = (T(small >> 63), T(small))
    a_hi = np.array(a[0])
    a_hi[:100] = a_hi[:100] >> 40  # some products fit, others overflow
    a = (T(a_hi), a[1])
    ja = (J(a[0].numpy()), J(a[1].numpy()))
    jb = (J(b[0].numpy()), J(b[1].numpy()))
    (ph_t, pl_t), ov_t = t_i128.mul_checked(a, b)
    (ph_j, pl_j), ov_j = j_i128.mul_checked(ja, jb)
    eq(ov_t, ov_j)
    eq(ph_t, ph_j)
    eq(pl_t, pl_j)
    num_t, _ = t_i128.abs128(a)
    num_j, _ = j_i128.abs128(ja)
    den = np.abs(rng.integers(1, 2**62, n, dtype=np.int64))
    den_hi = np.where(np.arange(n) % 2 == 0, 0, rng.integers(0, 2**20, n)).astype(np.int64)
    (q_t, r_t) = t_i128.divmod_u128(num_t, (T(den_hi), T(den)))
    (q_j, r_j) = j_i128.divmod_u128(num_j, (J(den_hi), J(den)))
    for x, y in zip(q_t + r_t, q_j + r_j):
        eq(x, y)
