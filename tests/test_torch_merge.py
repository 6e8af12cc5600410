"""The port's merge kernel module (trino_tpu_torch/ops/merge.py) against the
JAX package's Pallas kernel (trino_tpu/ops/merge_pallas.py) run in
interpret mode on the CPU. Integer outputs: exact equality everywhere.

The CUDA kernel itself cannot run here (no GPU, no nvcc); its test is
marked ``cuda`` and skips, and chip_smoke.py holds it against the plain
version on the card."""
import numpy as np
import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
import jax.numpy as jnp
from trino_tpu.ops import fused_join as jax_fused
from trino_tpu.ops import join as jax_join
from trino_tpu.ops import merge_pallas

from trino_tpu_torch.ops import fused_join as torch_fused
from trino_tpu_torch.ops import join as torch_join
from trino_tpu_torch.ops import merge

INT32_MAX = 2**31 - 1


def _sorted_build(rng, nb, hi, dead=0):
    b = np.sort(rng.choice(hi, size=nb, replace=False)).astype(np.int32)
    if dead:
        b[-dead:] = INT32_MAX
    return b


def _sorted_probe(rng, np_, lo, hi):
    return np.sort(rng.integers(lo, hi, size=np_)).astype(np.int32)


def _closed_form(b, p):
    """The function the CUDA kernel computes: the lower bound of each key in
    the build padded with one INT32_MAX, kept where the padded build holds
    the key there, else -1; all -1 against an empty build."""
    if b.shape[0] == 0:
        return np.full(p.shape, -1, np.int32)
    padded = np.concatenate([b, np.array([INT32_MAX], np.int32)])
    lb = np.searchsorted(padded, p, side="left")
    return np.where(padded[lb] == p, lb, -1).astype(np.int32)


def _both(b, p, bb):
    ref = np.asarray(merge_pallas.merge_unique_sorted(
        jnp.asarray(b), jnp.asarray(p), block_build=bb, interpret=True))
    got = merge.merge_unique_sorted(torch.from_numpy(b), torch.from_numpy(p),
                                    block_build=bb).numpy()
    return ref, got


@pytest.mark.parametrize("seed,nb,np_,bb", [
    (0, 2000, 3000, 256),
    (1, 2000, 3000, 2048),
    (2, 1023, 1025, 256),     # ragged: one key past a probe tile
    (3, 3001, 5003, 2048),    # ragged on both sides
    (4, 1, 1, 2048),
    (5, 700, 4096, 256),      # probe an exact number of tiles
    (6, 5000, 200, 512),      # build much larger than the probe
    (7, 20000, 300, 512),     # build much denser: one tile spans ~40 windows
])
def test_plain_matches_pallas_interpret(seed, nb, np_, bb):
    rng = np.random.default_rng(seed)
    b = _sorted_build(rng, nb, 4 * nb + 10, dead=seed % 3)
    p = _sorted_probe(rng, np_, -3, 4 * nb + 13)
    ref, got = _both(b, p, bb)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bb", [128, 256, 2048, 8192])
def test_plain_matches_closed_form(bb, seed):
    """The reference's windowed arithmetic (128-aligned window starts,
    block_build windows, the nb_pad clamp) never changes an answer: the
    plain version equals the closed form the CUDA kernel computes, on
    random sizes with dead INT32_MAX build tails, INT32_MAX probe keys,
    builds denser and sparser than the probe, and empty sides."""
    rng = np.random.default_rng(1000 * bb + seed)
    for case in range(25):
        nb = int(rng.integers(0, 3000)) if case % 8 else 0
        np_ = int(rng.integers(0, 3000)) if case % 7 else 0
        hi = int(rng.integers(max(nb, 1), 8 * nb + 20))
        b = _sorted_build(rng, nb, hi, dead=int(rng.integers(0, 4)) if nb > 4 else 0)
        p = _sorted_probe(rng, np_, -3, hi + 5)
        if np_ and case % 3 == 0:
            p[-int(rng.integers(1, min(np_, 4) + 1)):] = INT32_MAX
        want = _closed_form(b, p)
        got = merge.merge_unique_sorted_plain(torch.from_numpy(b), torch.from_numpy(p),
                                              block_build=bb).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"case {case}: nb={nb} np={np_}")


@pytest.mark.parametrize("nb,np_", [(0, 50), (50, 0), (0, 0)])
def test_empty_sides(nb, np_):
    rng = np.random.default_rng(7)
    b = _sorted_build(rng, nb, 1000)
    p = _sorted_probe(rng, np_, 0, 1000)
    ref, got = _both(b, p, 2048)
    assert got.shape == (np_,)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bb", [256, 2048])
def test_int32_max_probe_edge(bb):
    """Probe keys equal to the INT32_MAX pad/dead-row sentinel: the window
    clamp decides what they match; the port must decide it the same way."""
    rng = np.random.default_rng(11)
    b = np.concatenate([np.arange(0, 1000, 2, dtype=np.int32),
                        np.full(3, INT32_MAX, np.int32)])
    p = np.sort(np.concatenate([
        _sorted_probe(rng, 2000, 0, 1100), np.full(4, INT32_MAX, np.int32)]))
    ref, got = _both(b, p.astype(np.int32), bb)
    np.testing.assert_array_equal(got, ref)


def test_merge_sorted_build_null_slot_sentinel_edge():
    """A NULL probe slot whose raw value is INT32_MAX neither matches nor
    drags its tile's window past the padded build (the mirror of
    tests/test_join_kernels.py::test_pallas_merge_null_slot_sentinel_edge)."""
    bk = np.arange(0, 1000, 2, dtype=np.int32)
    pk = np.array([4, 8, INT32_MAX, 10], np.int32)
    pvalid = np.array([True, True, False, True])
    jb = jax_join.build_side([(jnp.asarray(bk), None)], None)
    j_rows, j_matched = jax_fused.merge_sorted_build(
        jb, [(jnp.asarray(pk), jnp.asarray(pvalid))], use_pallas=True,
        pallas_block_build=256, pallas_interpret=True)
    tb = torch_join.build_side([(torch.from_numpy(bk), None)], None)
    t_rows, t_matched = torch_fused.merge_sorted_build(
        tb, [(torch.from_numpy(pk), torch.from_numpy(pvalid))], use_pallas=True,
        pallas_block_build=256)
    assert list(t_matched.numpy()) == [True, True, False, True]
    assert list(t_rows.numpy()[t_matched.numpy()]) == [2, 4, 5]
    np.testing.assert_array_equal(t_matched.numpy(), np.asarray(j_matched))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))


def test_cpu_tensors_take_the_plain_version():
    b = torch.arange(0, 100, 3, dtype=torch.int32)
    p = torch.arange(0, 50, dtype=torch.int32)
    before = merge.launches
    got = merge.merge_unique_sorted(b, p, block_build=128)
    assert merge.launches == before  # no kernel launch on the CPU
    assert torch.equal(got, merge.merge_unique_sorted_plain(b, p, block_build=128))
    want = torch.where(p % 3 == 0, p // 3, torch.full_like(p, -1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", [torch.int64, torch.int16])
def test_non_int32_keys_raise(bad):
    with pytest.raises(TypeError):
        merge.merge_unique_sorted(torch.zeros(4, dtype=bad), torch.zeros(4, dtype=torch.int32))


@pytest.mark.cuda
def test_launch_recorded_into_a_graph_is_not_counted():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    rng = np.random.default_rng(5)
    b = torch.from_numpy(_sorted_build(rng, 256, 1024, dead=2)).cuda()
    p = torch.from_numpy(_sorted_probe(rng, 6113, 0, 1024)).cuda()
    merge.merge_unique_sorted(b, p)  # builds the library outside the capture
    torch.cuda.synchronize()
    launches, captured = merge.launches, merge.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = merge.merge_unique_sorted(b, p)
    assert (merge.launches, merge.captured) == (launches, captured + 1)
    graph.replay()
    torch.cuda.synchronize()
    assert merge.launches == launches  # a replay does not pass through the wrapper
    assert torch.equal(got, merge.merge_unique_sorted_plain(b, p))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    rng = np.random.default_rng(3)
    for nb, np_, bb in [(256, 6113, 2048), (3001, 5003, 256), (1 << 16, 1 << 20, 2048),
                        (1 << 20, 1 << 16, 2048),  # build denser than the probe
                        # over a thousand full probe tiles and a ragged last
                        # one, against a sparser and a denser build
                        (1 << 20, (2 << 20) + 777, 2048),
                        (8 << 20, (2 << 20) + 777, 2048)]:
        b = torch.from_numpy(_sorted_build(rng, nb, 4 * nb, dead=2)).cuda()
        p = torch.from_numpy(_sorted_probe(rng, np_, 0, 4 * nb)).cuda()
        before = merge.launches
        got = merge.merge_unique_sorted(b, p, block_build=bb)
        assert merge.launches == before + 1
        assert torch.equal(got, merge.merge_unique_sorted_plain(b, p, block_build=bb))
        assert torch.equal(got.cpu(), torch.from_numpy(_closed_form(b.cpu().numpy(),
                                                                    p.cpu().numpy())))
        for other in (128, 8192):  # the kernel's answer does not depend on block_build
            assert torch.equal(merge.merge_unique_sorted(b, p, block_build=other), got)
