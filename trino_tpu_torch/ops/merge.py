"""Sorted probe x sorted build merge rank: the port of
trino_tpu/ops/merge_pallas.py:99 ``merge_unique_sorted``.

Per SORTED int32 probe key: the rank of the equal key in a SORTED int32
build (matched build index), or -1. Build dead rows must be an INT32_MAX
sentinel tail; the caller (ops/fused_join.merge_sorted_build) has proven
the sentinel unreachable by a live probe key.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/merge_unique_sorted.cu`` (built at first use with nvcc for sm_90a
into ``_build/`` beside this package, loaded with ctypes) or raises. The
kernel computes the closed form of the reference's result: the lower
bound of each key in the build padded with one INT32_MAX, kept where the
padded build holds the key there, else -1 (all -1 when a side is
empty, which the wrapper answers without a launch). That answer does not
depend on ``block_build``, which the kernel therefore does not take (the
wrapper still validates it). On a CPU tensor the wrapper runs
``merge_unique_sorted_plain``, which repeats the reference kernel's
arithmetic in PyTorch: probe padding to whole BLOCK_PROBE tiles, the
INT32_MAX build pad, the per-tile covering window from the tile's
boundary keys, the window clamp, and the chunked count-of-smaller /
any-equal accumulation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

BLOCK_PROBE = 1024  # probe keys per tile (the reference's grid step)
_PAD = 2**31 - 1
# kernel launches on the CUDA path; the tests and chip_smoke.py read it
launches = 0
# launches recorded into a CUDA graph while it was captured: they run only
# when the graph is replayed, so they are not launches (exec/compiled.py
# reads this to know what its graph holds)
captured = 0
# the counts are read-modify-writes from every thread that launches (the
# tasks of a worker run in threads of one process)
_count_lock = threading.Lock()

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "merge_unique_sorted.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_lib_cell: list = []
_lib_lock = threading.Lock()
build_log = ""  # nvcc's output (ptxas register/shared-memory report)


def _block_build(block_build: int) -> int:
    return max(128, (int(block_build) // 128) * 128)


def merge_unique_sorted_plain(build_sorted: torch.Tensor, probe_sorted: torch.Tensor,
                              *, block_build: int = 2048) -> torch.Tensor:
    """The reference kernel's arithmetic in PyTorch (any device)."""
    if build_sorted.dtype != torch.int32 or probe_sorted.dtype != torch.int32:
        raise TypeError("merge_unique_sorted takes int32 build and probe keys")
    device = probe_sorted.device
    nb = build_sorted.shape[0]
    np_ = probe_sorted.shape[0]
    bb = _block_build(block_build)
    if np_ == 0 or nb == 0:
        return torch.full((np_,), -1, dtype=torch.int32, device=device)
    # pad the probe to whole tiles with its last (max) key: pad slots
    # cannot widen a tile's window and are dropped at the end
    g = -(-np_ // BLOCK_PROBE)
    probe_pad = torch.cat([
        probe_sorted, probe_sorted[-1:].expand(g * BLOCK_PROBE - np_)
    ]).reshape(g, BLOCK_PROBE)
    # pad the build with the sentinel so every window stays in bounds
    nb_pad = (-(-nb // bb) + 2) * bb
    build_pad = torch.cat([
        build_sorted,
        torch.full((nb_pad - nb,), _PAD, dtype=torch.int32, device=device),
    ])
    # covering window per tile from its boundary keys only
    starts = torch.searchsorted(build_pad, probe_pad[:, 0].contiguous(), side="left")
    ends = torch.searchsorted(build_pad, probe_pad[:, -1].contiguous(), side="right")
    wstart = (starts // 128) * 128
    nwin = -(-(ends - wstart) // bb)
    # hard in-bounds clamp: windows beyond nb_pad hold nothing real
    nwin = torch.minimum(nwin, (nb_pad - wstart) // bb)
    out = torch.empty((g, BLOCK_PROBE), dtype=torch.int32, device=device)
    lane = torch.arange(bb, dtype=torch.int64, device=device)
    tiles = max(1, (1 << 24) // (BLOCK_PROBE * bb))  # bounds the compare tensor
    for t0 in range(0, g, tiles):
        pk = probe_pad[t0:t0 + tiles, :, None]
        ws = wstart[t0:t0 + tiles]
        nw = nwin[t0:t0 + tiles]
        acc_lt = torch.zeros(pk.shape[:2], dtype=torch.int32, device=device)
        acc_eq = torch.zeros(pk.shape[:2], dtype=torch.bool, device=device)
        for w in range(int(nw.max())):
            idx = (ws[:, None] + w * bb + lane).clamp(max=nb_pad - 1)
            bw = build_pad[idx][:, None, :]
            on = (nw > w)[:, None, None]
            acc_lt += ((bw < pk) & on).sum(-1, dtype=torch.int32)
            acc_eq |= ((bw == pk) & on).any(-1)
        out[t0:t0 + tiles] = torch.where(
            acc_eq, ws[:, None].to(torch.int32) + acc_lt,
            torch.full_like(acc_lt, -1))
    return out.reshape(-1)[:np_]


def build_library() -> Path:
    """Compile ``csrc/merge_unique_sorted.cu`` with nvcc for sm_90a into
    BUILD_DIR (named by a hash of the source and flags) unless that
    library already exists. Returns its path."""
    global build_log
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmerge_unique_sorted_{tag}.so"
    if lib.exists():
        return lib
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(_SRC)],
                             capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_SRC.name}:\n{build_log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def _lib():
    """The launch function, resolved once; no lock after the first load."""
    if _lib_cell:
        return _lib_cell[0]
    with _lib_lock:
        if not _lib_cell:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.merge_unique_sorted_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib_cell.append(fn)
        return _lib_cell[0]


def _check_cuda(build_sorted: torch.Tensor, probe_sorted: torch.Tensor) -> None:
    for name, t in (("build", build_sorted), ("probe", probe_sorted)):
        if t.device.type != "cuda":
            raise ValueError(f"merge_unique_sorted: {name} is on {t.device}, "
                             "the other side on CUDA")
        if t.dtype != torch.int32:
            raise TypeError(f"merge_unique_sorted: {name} must be int32, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"merge_unique_sorted: {name} must be 1-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"merge_unique_sorted: {name} must be contiguous")
    if build_sorted.device != probe_sorted.device:
        raise ValueError("merge_unique_sorted: build and probe on different devices")


def merge_unique_sorted(build_sorted: torch.Tensor, probe_sorted: torch.Tensor,
                        *, block_build: int = 2048) -> torch.Tensor:
    """Per SORTED probe key: matched build rank or -1 (int32). CPU tensors
    take the plain version; CUDA tensors the Hopper kernel.

    The CUDA path is kept lean because the main path calls it at a few
    thousand keys, where the host's cost per call exceeds the kernel's: one
    combined check (the detailed one runs only to name a failure), the
    launch function resolved once, the current stream read as a raw handle,
    and a device switch only when the tensors are not on the current one."""
    b, p = build_sorted, probe_sorted
    if not (b.is_cuda and p.is_cuda and b.dtype is torch.int32 and p.dtype is torch.int32
            and b.dim() == 1 and p.dim() == 1 and b.is_contiguous() and p.is_contiguous()
            and b.get_device() == p.get_device()):
        if b.device.type == "cpu" and p.device.type == "cpu":
            return merge_unique_sorted_plain(b, p, block_build=block_build)
        _check_cuda(b, p)
    _block_build(block_build)  # validated; the kernel's answer does not depend on it
    nb = b.shape[0]
    np_ = p.shape[0]
    if np_ == 0 or nb == 0:
        return torch.full((np_,), -1, dtype=torch.int32, device=p.device)
    if nb > _PAD:
        raise ValueError(f"merge_unique_sorted: {nb} build keys do not fit int32 ranks")
    fn = _lib()
    out = p.new_empty((np_,))
    index = p.get_device()
    # the raw handle of PyTorch's current stream on that device (what
    # torch.cuda.current_stream(index).cuda_stream returns, without
    # building a Stream object: 0.1 us against 3.3 us a call on an H100)
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        err = fn(b.data_ptr(), nb, p.data_ptr(), np_, out.data_ptr(), stream)
    else:
        with torch.cuda.device(index):
            err = fn(b.data_ptr(), nb, p.data_ptr(), np_, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"merge_unique_sorted kernel launch failed: CUDA error {err}")
    _count_launch(torch.cuda.is_current_stream_capturing())
    return out


def _count_launch(capturing: bool) -> None:
    """One launch into ``captured`` (recorded into a graph) or ``launches``."""
    global launches, captured
    with _count_lock:
        if capturing:
            captured += 1
        else:
            launches += 1
