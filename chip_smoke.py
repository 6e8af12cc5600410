"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build: compiles trino_tpu_torch/csrc/merge_unique_sorted.cu with nvcc
   for sm_90a from the checkout.
2. kernel: the merge kernel against its plain PyTorch version on the card,
   exact equality, at the SF1 join shapes of TPC-H Q17 and Q18, ragged
   sizes, empty sides, the INT32_MAX null-slot edge and probe 16M x build
   4M. Prints the kernel's, the plain version's and the library call's
   (torch.searchsorted + equality gather, never called by the port) times
   from CUDA events, and the bound (bytes moved over 3.35 TB/s).
3. tpch: TPC-H Q18 and Q17 at SF1 through trino_tpu_torch.Session on CUDA.
   The rows must equal trino_tpu_torch/testdata/tpch_sf1_expected.json
   (written by the JAX package), and each query must launch the merge
   kernel and select the merge-pallas join tier at least once. Prints cold
   and warm wall time.

With ``--profile`` it also runs each query once more under torch.profiler
and prints the device time by kernel and the device's busy share.

The last three lines of standard output are the kernel summary
``{"kernels": [...]}``, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT_OPS_PER_S = 67e12  # the card's non-tensor-core 32-bit rate (fp32 figure)
INT32_MAX = 2**31 - 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream, by CUDA
    events around ``iters`` calls after two warm-up calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_merge(build, probe):
    """The same function as one library search plus an equality gather."""
    import torch

    pos = torch.searchsorted(build, probe)
    hit = build[pos.clamp(max=build.shape[0] - 1)] == probe
    return torch.where(hit, pos.to(torch.int32), torch.full_like(probe, -1))


def kernel_cases(rng):
    """(name, build, probe, block_build) as host int32 arrays."""
    import numpy as np

    def sorted_unique(n, hi):
        return np.sort(rng.choice(hi, size=n, replace=False)).astype(np.int32)

    def probe_over(n, hi):
        return np.sort(rng.integers(0, hi, size=n)).astype(np.int32)

    cases = [
        ("q17_sf1", sorted_unique(256, 200_000), probe_over(6113, 200_000), 2048),
        ("q18_sf1", sorted_unique(65, 6_000_000), probe_over(455, 6_000_000), 2048),
        ("ragged", sorted_unique(3001, 50_000), probe_over(5003, 50_000), 256),
        ("empty_probe", sorted_unique(100, 1000), np.zeros(0, np.int32), 2048),
        ("empty_build", np.zeros(0, np.int32), probe_over(100, 1000), 2048),
    ]
    # the null-slot edge: a dead-row INT32_MAX build tail and probe slots
    # holding INT32_MAX itself
    b = np.concatenate([np.arange(0, 1000, 2, dtype=np.int32),
                        np.full(7, INT32_MAX, np.int32)])
    p = np.sort(np.concatenate([probe_over(3000, 1200),
                                np.full(5, INT32_MAX, np.int32)])).astype(np.int32)
    cases.append(("int32_max_edge", b, p, 256))
    cases.append(("large_16m_4m", sorted_unique(4 << 20, 1 << 30),
                  probe_over(16 << 20, 1 << 30), 2048))
    return cases


def phase_kernel(device):
    import numpy as np
    import torch

    from trino_tpu_torch.ops import merge

    rng = np.random.default_rng(1234)
    rows = []
    for name, b_np, p_np, bb in kernel_cases(rng):
        b = torch.from_numpy(b_np).to(device)
        p = torch.from_numpy(p_np).to(device)
        got = merge.merge_unique_sorted(b, p, block_build=bb)
        want = merge.merge_unique_sorted_plain(b, p, block_build=bb)
        torch.cuda.synchronize()
        if got.dtype != torch.int32 or got.shape != want.shape or \
                not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"merge kernel != plain at {name}: first bad {bad}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) \
            if got.numel() else 0
        nb, np_ = b.shape[0], p.shape[0]
        bytes_moved = 4 * (nb + 2 * np_)
        big = np_ >= (1 << 20)
        row = {
            "shape": name, "build": nb, "probe": np_, "block_build": bb,
            "max_abs_err": err,
            "kernel_ms": time_ms(lambda: merge.merge_unique_sorted(b, p, block_build=bb),
                                 20 if big else 200),
            "plain_ms": time_ms(lambda: merge.merge_unique_sorted_plain(b, p, block_build=bb),
                                2 if big else 20),
            "library_ms": (time_ms(lambda: library_merge(b, p), 20 if big else 200)
                           if nb and np_ else None),
            "bound_ms": 1e3 * max(bytes_moved / HBM_BYTES_PER_S,
                                  (nb + np_) / INT_OPS_PER_S),
            "bytes": bytes_moved,
        }
        rows.append(row)
        print("kernel", json.dumps(row), flush=True)
    one_b = torch.zeros(1, dtype=torch.int32, device=device)
    one_p = torch.zeros(1, dtype=torch.int32, device=device)
    floor = time_ms(lambda: merge.merge_unique_sorted(one_b, one_p), 500)
    print("kernel", json.dumps({"launch_floor_ms_1x1": floor}), flush=True)
    return rows, floor


def jsonable_rows(rows):
    return [[v if v is None or isinstance(v, (int, float, str)) else str(v) for v in r]
            for r in rows]


def phase_tpch(device):
    import torch

    from trino_tpu_torch import Session
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.ops import merge

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "trino_tpu_torch", "testdata",
                           "tpch_sf1_expected.json")) as f:
        expected = json.load(f)["queries"]
    session = Session(properties={"catalog": "tpch", "schema": "sf1",
                                  "fused_join_pallas": True}, device=device)
    out = {}
    for q in (18, 17):
        runs = []
        for label in ("cold", "warm"):
            merge.launches = 0
            sel0 = M.FUSED_JOIN_SELECTIONS.value("merge-pallas")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = session.execute(expected[str(q)]["sql"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = merge.launches
            selections = M.FUSED_JOIN_SELECTIONS.value("merge-pallas") - sel0
            got = jsonable_rows(res.rows)
            want = expected[str(q)]["rows"]
            if got != want:
                raise AssertionError(
                    f"Q{q} rows differ from the expected rows: {len(got)} vs "
                    f"{len(want)} rows; first got {got[:2]}, want {want[:2]}")
            if launches < 1 or selections < 1:
                raise AssertionError(
                    f"Q{q} ({label}) did not run the merge kernel: launches="
                    f"{launches}, merge-pallas selections={selections}")
            runs.append({"run": label, "wall_s": wall, "merge_launches": launches,
                         "merge_pallas_selections": selections})
        out[q] = runs
        print("tpch", json.dumps({"query": f"Q{q}", "scale": "sf1",
                                  "rows": len(res.rows), "runs": runs}), flush=True)
    return out, session, expected


def phase_profile(session, expected):
    """``--profile``: one warm run of each query under torch.profiler —
    device time by kernel name and the device's busy share of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for q in (18, 17):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session.execute(expected[str(q)]["sql"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only (kernels and copies): the operator rows
        # of key_averages() repeat their kernels' time, and the profiler's
        # own buffer requests are not work of the query
        by_kernel = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.key.startswith("Activity Buffer"):
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            if dev_us > 0:
                by_kernel.append((dev_us, e.count, e.key))
        by_kernel.sort(reverse=True)
        device_s = sum(us for us, _, _ in by_kernel) / 1e6
        print("profile", json.dumps({
            "query": f"Q{q}", "wall_s": wall, "device_s": device_s,
            "device_busy_share": device_s / wall if wall else None,
            "device_launches": sum(c for _, c, _ in by_kernel),
            "top": [{"kernel": k[:80], "calls": c, "device_ms": us / 1e3}
                    for us, c, k in by_kernel[:12]]}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from trino_tpu_torch.ops import merge

    card = card_line()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = merge.build_library()
    build_s = time.perf_counter() - t0
    print("build", json.dumps({"library": os.path.basename(str(lib)),
                               "seconds": build_s, "nvcc_flags": merge.NVCC_FLAGS}),
          flush=True)
    if merge.build_log.strip():
        print(merge.build_log.strip(), flush=True)
    rows, floor = phase_kernel(device)
    tpch, session, expected = phase_tpch(device)
    if "--profile" in sys.argv[1:]:
        phase_profile(session, expected)
    main_shape = next(r for r in rows if r["shape"] == "q17_sf1")
    launches = sum(run["merge_launches"] for runs in tpch.values()
                   for run in runs if run["run"] == "cold")
    summary = {
        "name": "merge_unique_sorted",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/merge_unique_sorted.cu",
        "replaces": "trino_tpu/ops/merge_pallas.py:99",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_shape["library_ms"],
        "shape": "q17_sf1 build 256 x probe 6113",
        "launch_floor_ms": floor,
        "shapes": rows,
    }
    print(json.dumps({"kernels": [summary]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
