"""The port's device modules (trino_tpu_torch/ops, data/page.py) against
their JAX counterparts (trino_tpu/ops, data/page.py) on the same numpy
inputs from a seed, plus the copied TPC-H generator against the
reference's. Integer outputs are compared exactly; the one float check
(seg_sum over float64) allows 1e-12 relative error because the two
scatter-adds may add in a different order."""
import numpy as np
import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
import jax.numpy as jnp
from trino_tpu.connector.tpch import generator as jax_gen
from trino_tpu.data.page import Page as JaxPage
from trino_tpu import types as JT
from trino_tpu.ops import aggregate as j_agg
from trino_tpu.ops import fused_join as j_fused
from trino_tpu.ops import groupby as j_gb
from trino_tpu.ops import int128 as j_i128
from trino_tpu.ops import join as j_join
from trino_tpu.ops import ranks as j_ranks
from trino_tpu.ops import segments as j_seg
from trino_tpu.ops import sort as j_sort

from trino_tpu_torch.connector.tpch import generator as torch_gen
from trino_tpu_torch.data.page import page_from_numpy
from trino_tpu_torch import types as TT
from trino_tpu_torch.ops import aggregate as t_agg
from trino_tpu_torch.ops import fused_join as t_fused
from trino_tpu_torch.ops import groupby as t_gb
from trino_tpu_torch.ops import int128 as t_i128
from trino_tpu_torch.ops import join as t_join
from trino_tpu_torch.ops import ranks as t_ranks
from trino_tpu_torch.ops import segments as t_seg
from trino_tpu_torch.ops import sort as t_sort


def J(a):
    return jnp.asarray(a)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def eq(t, j):
    """Exact equality of a port tensor and a JAX array (values and dtype)."""
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def eq_opt(t, j):
    assert (t is None) == (j is None)
    if t is not None:
        eq(t, j)


@pytest.fixture
def rng():
    return np.random.default_rng(20261016)


# ------------------------------------------------------------------ ranks
def test_argsorts(rng):
    a = rng.integers(0, 20, 500).astype(np.int32)
    b = rng.integers(-3, 3, 500).astype(np.int64)
    c = rng.random(500) < 0.3
    eq(t_ranks.argsort32(T(a)), j_ranks.argsort32(J(a)))
    eq(t_ranks.lex_argsort32([T(c), T(a), T(b)]),
       j_ranks.lex_argsort32([J(c), J(a), J(b)]))


def test_sorted_ranks_and_inverse(rng):
    build = np.sort(rng.integers(0, 100, 300)).astype(np.int32)
    query = rng.integers(-5, 110, 400).astype(np.int32)
    lo_t, cnt_t = t_ranks.sorted_ranks([T(build)], [T(query)])
    lo_j, cnt_j = j_ranks.sorted_ranks([J(build)], [J(query)])
    eq(lo_t, lo_j)
    eq(cnt_t, cnt_j)
    perm = rng.permutation(64).astype(np.int32)
    pay = rng.integers(0, 1000, 64).astype(np.int64)
    eq(t_ranks.apply_inverse(T(perm), [T(pay)])[0],
       j_ranks.apply_inverse(J(perm), [J(pay)])[0])
    idx = rng.integers(0, 64, 30).astype(np.int32)
    for g_t, g_j in zip(t_ranks.batched_gather([T(pay), T(perm)], T(idx)),
                        j_ranks.batched_gather([J(pay), J(perm)], J(idx))):
        eq(g_t, g_j)


# ------------------------------------------------------------------- join
def _keys(rng, n, hi, nullable, dtype=np.int32):
    v = rng.integers(0, hi, n).astype(dtype)
    valid = (rng.random(n) > 0.1) if nullable else None
    return v, valid


def _lowered(pairs, conv):
    return [(conv(v), None if m is None else conv(m)) for v, m in pairs]


@pytest.mark.parametrize("multi,nullable", [(False, False), (False, True), (True, True)])
def test_build_side_and_probes(rng, multi, nullable):
    nb, np_ = 200, 300
    bk = [_keys(rng, nb, 400, nullable)]
    pk = [_keys(rng, np_, 400, nullable)]
    if multi:
        bk.append(_keys(rng, nb, 3, False, np.int64))
        pk.append(_keys(rng, np_, 3, False, np.int64))
    sel = rng.random(nb) > 0.2
    bt, pt = t_join.align_join_keys(_lowered(bk, T), _lowered(pk, T))
    bj, pj = j_join.align_join_keys(_lowered(bk, J), _lowered(pk, J))
    for (a, _), (b, _) in zip(bt + pt, bj + pj):
        assert a.numpy().dtype == np.asarray(b).dtype
    sb_t = t_join.build_side(bt, T(sel))
    sb_j = j_join.build_side(bj, J(sel))
    for a, b in zip(sb_t.cols, sb_j.cols):
        eq(a, b)
    eq(sb_t.rows, sb_j.rows)
    eq(sb_t.live, sb_j.live)
    rows_t, m_t = t_join.probe_unique(sb_t, pt)
    rows_j, m_j = j_join.probe_unique(sb_j, pj)
    eq(m_t, m_j)
    eq(rows_t[m_t], np.asarray(rows_j)[np.asarray(m_j)])
    eq(t_join.membership(bt, T(sel), pt), j_join.membership(bj, J(sel), pj))


def test_presorted_build_and_align_widening(rng):
    keys = np.sort(rng.choice(1000, 128, replace=False)).astype(np.int32)
    live = np.arange(128) < 100  # live prefix, dead tail
    sb_t = t_join.build_side([(T(keys), None)], T(live), presorted=True)
    sb_j = j_join.build_side([(J(keys), None)], J(live), presorted=True)
    eq(sb_t.cols[0], sb_j.cols[0])
    eq(sb_t.rows, sb_j.rows)
    # unproven ranges widen int32 keys one step (the sentinel could collide)
    bt, _ = t_join.align_join_keys([(T(keys), None)], [(T(keys), None)])
    bj, _ = j_join.align_join_keys([(J(keys), None)], [(J(keys), None)])
    assert bt[0][0].dtype == torch.int64 and np.asarray(bj[0][0]).dtype == np.int64
    bt, _ = t_join.align_join_keys([(T(keys), None)], [(T(keys), None)], [(0, 999)], [(0, 999)])
    assert bt[0][0].dtype == torch.int32


def test_dense_tier(rng):
    nb, np_ = 300, 500
    bkeys = rng.permutation(1000)[:nb].astype(np.int32) + 50
    bsel = rng.random(nb) > 0.1
    pkeys = rng.integers(0, 1200, np_).astype(np.int32)
    pvalid = rng.random(np_) > 0.1
    assert t_join.dense_span((50, 1049), nb) == j_join.dense_span((50, 1049), nb)
    assert t_join.dense_span((0, 1 << 28), nb) is None
    lo, span = t_join.dense_span((50, 1049), nb)
    tab_t = t_join.dense_unique_table((T(bkeys), None), T(bsel), lo, span)
    tab_j = j_join.dense_unique_table((J(bkeys), None), J(bsel), lo, span)
    eq(tab_t, tab_j)
    r_t, m_t = t_join.dense_probe_unique(tab_t, (T(pkeys), T(pvalid)), lo)
    r_j, m_j = j_join.dense_probe_unique(tab_j, (J(pkeys), J(pvalid)), lo)
    eq(r_t, r_j)
    eq(m_t, m_j)
    dup = np.concatenate([bkeys, bkeys[:40]])
    dsel = np.concatenate([bsel, np.ones(40, bool)])
    eq(t_join.dense_membership((T(dup), None), T(dsel), (T(pkeys), T(pvalid)), lo, span),
       j_join.dense_membership((J(dup), None), J(dsel), (J(pkeys), J(pvalid)), lo, span))
    cols = [(rng.integers(0, 9, nb).astype(np.int64), None),
            (rng.random(nb), rng.random(nb) > 0.5)]
    g_t = t_join.gather_columns(_lowered(cols, T), r_t, m_t)
    g_j = j_join.gather_columns(_lowered(cols, J), r_j, m_j)
    for (a, av), (b, bv) in zip(g_t, g_j):
        eq(a, b)
        eq(av, bv)


# ------------------------------------------------------------- fused join
@pytest.mark.parametrize("nullable", [False, True])
def test_fused_tier(rng, nullable):
    nb, np_ = 250, 400
    bkeys = rng.permutation(600)[:nb].astype(np.int32)
    bk = [(bkeys, (rng.random(nb) > 0.1) if nullable else None)]
    pk = [_keys(rng, np_, 650, nullable)]
    sel = rng.random(nb) > 0.2
    eq(t_fused.fused_match_rows(_lowered(bk, T), T(sel), _lowered(pk, T)),
       j_fused.fused_match_rows(_lowered(bk, J), J(sel), _lowered(pk, J)))
    r_t, m_t = t_fused.fused_probe_unique(_lowered(bk, T), T(sel), _lowered(pk, T))
    r_j, m_j = j_fused.fused_probe_unique(_lowered(bk, J), J(sel), _lowered(pk, J))
    eq(r_t, r_j)
    eq(m_t, m_j)
    eq(t_fused.fused_membership(_lowered(bk, T), T(sel), _lowered(pk, T)),
       j_fused.fused_membership(_lowered(bk, J), J(sel), _lowered(pk, J)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_merge_sorted_build(rng, use_kernel):
    """The merge tier against a presorted build, with the merge kernel
    (``use_pallas``) on and off in both packages."""
    bkeys = np.sort(rng.choice(5000, 1500, replace=False)).astype(np.int32)
    live = np.arange(1500) < 1400
    pkeys = rng.integers(0, 5100, 2500).astype(np.int32)
    pvalid = rng.random(2500) > 0.05
    sb_t = t_join.build_side([(T(bkeys), None)], T(live), presorted=True)
    sb_j = j_join.build_side([(J(bkeys), None)], J(live), presorted=True)
    r_t, m_t = t_fused.merge_sorted_build(
        sb_t, [(T(pkeys), T(pvalid))], use_pallas=use_kernel, pallas_block_build=256)
    r_j, m_j = j_fused.merge_sorted_build(
        sb_j, [(J(pkeys), J(pvalid))], use_pallas=use_kernel, pallas_block_build=256,
        pallas_interpret=True)
    eq(m_t, m_j)
    eq(r_t, r_j)


# ------------------------------------------------------ groupby / segments
def _group(rng, n=400, with_sel=True):
    k1 = rng.integers(0, 7, n).astype(np.int32)
    k2 = rng.integers(0, 5, n).astype(np.int64)
    k2v = rng.random(n) > 0.1
    sel = (rng.random(n) > 0.25) if with_sel else None
    return k1, k2, k2v, sel


def test_group_plan_and_layouts(rng):
    k1, k2, k2v, sel = _group(rng)
    pay = rng.integers(-100, 100, len(k1)).astype(np.int64)
    o_t, g_t, n_t, p_t = t_gb.group_plan([(T(k1), None), (T(k2), T(k2v))], T(sel), [T(pay)])
    o_j, g_j, n_j, p_j = j_gb.group_plan([(J(k1), None), (J(k2), J(k2v))], J(sel), [J(pay)])
    eq(o_t, o_j)
    eq(g_t, g_j)
    assert int(n_t) == int(n_j)
    eq(p_t[0], p_j[0])
    lay_t = t_seg.sorted_layout(o_t, g_t, n_t)
    lay_j = j_seg.sorted_layout(o_j, g_j, n_j)
    for f in ("starts", "ends", "rep"):
        eq(getattr(lay_t, f), getattr(lay_j, f))
    for a, b in zip(t_gb.gather_group_keys([(T(k1), None), (T(k2), T(k2v))], lay_t.rep),
                    j_gb.gather_group_keys([(J(k1), None), (J(k2), J(k2v))], lay_j.rep)):
        eq(a[0], b[0])
        eq_opt(a[1], b[1])


@pytest.mark.parametrize("direct", [False, True])
def test_segment_reductions_and_aggregates(rng, direct):
    n = 500
    k1, _, _, sel = _group(rng, n)
    vals = rng.integers(-10**6, 10**6, n).astype(np.int64)
    valid = rng.random(n) > 0.1
    fvals = rng.random(n) * 100.0
    if direct:
        lay_t = t_seg.direct_layout(T(k1), 7, T(sel))
        lay_j = j_seg.direct_layout(J(k1), 7, J(sel))
        arg_t, arg_j, sel_t, sel_j = (T(vals), T(valid)), (J(vals), J(valid)), T(sel), J(sel)
        f_t, f_j = T(fvals), J(fvals)
    else:
        o_t, g_t, n_t, (v_t, m_t, f_t) = t_gb.group_plan(
            [(T(k1), None)], T(sel), [T(vals), T(valid), T(fvals)])
        o_j, g_j, n_j, (v_j, m_j, f_j) = j_gb.group_plan(
            [(J(k1), None)], J(sel), [J(vals), J(valid), J(fvals)])
        lay_t = t_seg.sorted_layout(o_t, g_t, n_t)
        lay_j = j_seg.sorted_layout(o_j, g_j, n_j)
        arg_t, arg_j = (v_t, m_t), (v_j, m_j)
        sel_t = torch.arange(n) < T(sel).sum()
        sel_j = jnp.arange(n) < jnp.sum(J(sel))
    eq(t_seg.seg_count(lay_t, sel_t), j_seg.seg_count(lay_j, sel_j))
    for is_min in (True, False):
        eq(t_seg.seg_minmax(lay_t, arg_t[0], arg_t[1], is_min),
           j_seg.seg_minmax(lay_j, arg_j[0], arg_j[1], is_min))
    s_t, ok_t = t_agg.agg_sum(lay_t, arg_t, sel_t, torch.int64)
    s_j, ok_j = j_agg.agg_sum(lay_j, arg_j, sel_j, jnp.int64)
    eq(s_t, s_j)
    eq(ok_t, ok_j)
    eq(t_agg.agg_count(lay_t, arg_t, sel_t)[0], j_agg.agg_count(lay_j, arg_j, sel_j)[0])
    eq(t_agg.agg_count_star(lay_t, sel_t)[0], j_agg.agg_count_star(lay_j, sel_j)[0])
    for fn_t, fn_j in ((t_agg.agg_min, j_agg.agg_min), (t_agg.agg_max, j_agg.agg_max)):
        a, b = fn_t(lay_t, arg_t, sel_t), fn_j(lay_j, arg_j, sel_j)
        eq(a[0], b[0])
        eq(a[1], b[1])
    (hi_t, lo_t), ne_t = t_agg.agg_sum_128(lay_t, arg_t[0] * (2**40), None, arg_t[1], sel_t)
    (hi_j, lo_j), ne_j = j_agg.agg_sum_128(lay_j, arg_j[0] * (2**40), None, arg_j[1], sel_j)
    eq(hi_t, hi_j)
    eq(lo_t, lo_j)
    eq(ne_t, ne_j)
    cnt_t, _ = t_agg.agg_count(lay_t, arg_t, sel_t)
    cnt_j, _ = j_agg.agg_count(lay_j, arg_j, sel_j)
    dec = TT.DecimalType(name="decimal(12,2)", np_dtype=np.dtype(np.int64), precision=12, scale=2)
    jdec = JT.DecimalType(name="decimal(12,2)", np_dtype=np.dtype(np.int64), precision=12, scale=2)
    for a, b in zip(t_agg.finish_avg(s_t, cnt_t, dec), j_agg.finish_avg(s_j, cnt_j, jdec)):
        eq(a, b)
    # float sums: the scatter-add order may differ; 1e-12 relative
    fs_t = t_seg.seg_sum(lay_t, f_t, sel_t, torch.float64).numpy()
    fs_j = np.asarray(j_seg.seg_sum(lay_j, f_j, sel_j, jnp.float64))
    np.testing.assert_allclose(fs_t, fs_j, rtol=1e-12, atol=0)


def test_monotonic_segment_sum(rng):
    seg_ids = np.sort(rng.integers(0, 20, 300)).astype(np.int32)
    x = rng.integers(0, 5, 300).astype(np.int32)
    eq(t_seg.monotonic_segment_sum(T(x), T(seg_ids), 25),
       j_seg.monotonic_segment_sum(J(x), J(seg_ids), 25))


def test_sort_payloads(rng):
    n = 300
    a = rng.integers(0, 5, n).astype(np.int32)
    av = rng.random(n) > 0.2
    b = rng.integers(-50, 50, n).astype(np.int64)
    sel = rng.random(n) > 0.1
    pay = np.arange(n, dtype=np.int64)
    for asc_a, nf in ((True, None), (False, None), (True, True)):
        keys_t = [((T(a), T(av)), asc_a, nf), ((T(b), None), False, None)]
        keys_j = [((J(a), J(av)), asc_a, nf), ((J(b), None), False, None)]
        eq(t_sort.sort_payloads(keys_t, T(sel), [T(pay)])[0],
           j_sort.sort_payloads(keys_j, J(sel), [J(pay)])[0])


# ----------------------------------------------------------------- int128
def test_int128_limbs(rng):
    x = rng.integers(-2**62, 2**62, 200, dtype=np.int64)
    y = rng.integers(-2**40, 2**40, 200, dtype=np.int64)
    y[:3] = [-(2**63), 2**63 - 1, 0]
    pt = t_i128.mul_int64(T(x), T(y))
    pj = j_i128.mul_int64(J(x), J(y))
    eq(pt[0], pj[0])
    eq(pt[1], pj[1])
    eq(t_i128.compare(pt, t_i128.neg(pt)), j_i128.compare(pj, j_i128.neg(pj)))
    st = t_i128.add(pt, (T(x >> 63), T(x)))
    sj = j_i128.add(pj, j_i128.from_int64(J(x)))
    eq(st[0], sj[0])
    eq(st[1], sj[1])
    for a, b in ((17, 2), (2, 17), (3, 21)):
        (rt, ot) = t_i128.rescale_checked(pt, a, b)
        (rj, oj) = j_i128.rescale_checked(pj, a, b)
        eq(rt[0], rj[0])
        eq(rt[1], rj[1])
        eq(ot, oj)
    (at_, _) = t_i128.abs128(pt)
    (aj, _) = j_i128.abs128(pj)
    d = np.abs(rng.integers(1, 2**62, 200, dtype=np.int64))
    qt, rt = t_i128.divmod_u64_arr(at_, T(d))
    qj, rj = j_i128.divmod_u64_arr(aj, J(d))
    eq(qt[0], qj[0])
    eq(qt[1], qj[1])
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))


# ------------------------------------------------------------ page / data
def test_page_from_numpy_round_trips_a_jax_page():
    import datetime
    from decimal import Decimal

    schema = {"k": JT.BIGINT, "s": JT.varchar(), "d": JT.DATE,
              "m": JT.parse_type("decimal(12,2)"), "big": JT.parse_type("decimal(38,2)")}
    data = {"k": [1, None, 3], "s": ["b", "a", None],
            "d": [datetime.date(1995, 1, 2), None, datetime.date(1970, 1, 1)],
            "m": [Decimal("1.25"), Decimal("-3.00"), None],
            "big": [Decimal("1" * 30 + ".01"), None, Decimal("-2.50")]}
    jp = JaxPage.from_pydict(schema, data)
    jp.sel = J(np.array([True, False, True]))
    tp = page_from_numpy(jp.columns, np.asarray(jp.sel), device="cpu")
    assert [str(c.type) for c in tp.columns] == [str(c.type) for c in jp.columns]
    for tc, jc in zip(tp.columns, jp.columns):
        eq(tc.values, jc.values)
        eq_opt(tc.nulls, jc.nulls)
        eq_opt(tc.hi, jc.hi)
    assert tp.to_pylist() == jp.to_pylist()
    assert tp.columns[4].hi is not None  # the two-limb decimal kept its limb


@pytest.mark.parametrize("table", ["lineitem", "orders", "customer", "part",
                                   "partsupp", "supplier", "nation", "region"])
def test_tpch_generators_agree(table):
    sf = 0.01  # the tiny schema
    n = jax_gen.table_row_count("orders" if table == "lineitem" else table, sf)
    assert n == torch_gen.table_row_count("orders" if table == "lineitem" else table, sf)
    # a connector scan earlier in this process may have declared the
    # cached key column of this range sorted: compare fresh generations
    jax_gen._gen_cache.clear()
    torch_gen._gen_cache.clear()
    ref = jax_gen.generate(table, sf, 0, n)
    got = torch_gen.generate(table, sf, 0, n)
    assert sorted(ref) == sorted(got)
    for name, cd in ref.items():
        gd = got[name]
        assert str(gd.type) == str(cd.type), name
        assert gd.values.dtype == cd.values.dtype, name
        np.testing.assert_array_equal(gd.values, cd.values, err_msg=name)
        assert (gd.nulls is None) == (cd.nulls is None), name
        if cd.nulls is not None:
            np.testing.assert_array_equal(gd.nulls, cd.nulls, err_msg=name)
        assert (gd.dictionary is None) == (cd.dictionary is None), name
        if cd.dictionary is not None:
            assert gd.dictionary.values == cd.dictionary.values, name
        assert gd.vrange == cd.vrange and gd.sorted == cd.sorted, name
