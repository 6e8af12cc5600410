"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build: compiles trino_tpu_torch/csrc/merge_unique_sorted.cu with nvcc
   for sm_90a from the checkout.
2. kernel: the merge kernel against its plain PyTorch version on the card,
   exact equality, at the SF1 join shapes of TPC-H Q2, Q17 and Q18, ragged
   sizes, empty sides, the INT32_MAX null-slot edge, probe 16M x build 4M,
   probe 1M x build 16M (a build much denser than the probe), a probe of
   2M + 777 keys (over a thousand full tiles and a ragged last one) against
   a sparser and a denser build, and a block_build sweep (128, 2048, 8192)
   on one input whose outputs must be equal. For each shape it prints the
   wrapper-inclusive time of back-to-back calls (CUDA events; the summary's
   ``ms``, as since the first slice), the kernel's device time (a CUDA
   graph of many launches, so host overhead drops out; ``device_ms``), the
   wrapper's host microseconds per call, the plain version's time, the
   library call's (torch.searchsorted + equality gather, never called by
   the port) wrapper-inclusive and device times, and the byte bound. The
   bound counts what the function must move: each probe key read and each
   output written once, and the build read once or one 32-byte sector per
   probe key where that is less, 8 * np + min(4 * nb, 32 * np) bytes over
   3.35 TB/s. Its compare work is a few integer steps a key, far below the card's integer
   rate, so bytes bound it and no operation term is counted. Last, a 1 x 1
   call: its wrapper-inclusive time (the summary's ``launch_floor_ms``, as
   before, though it measures the wrapper and not a launch), device time
   and host microseconds.
3. tpch: all 22 TPC-H queries at SF1 through trino_tpu_torch.Session on
   CUDA, each run twice in one session (cold: the first run, which also
   generates the tables it is the first to scan; warm: the second). Each
   run's rows must equal trino_tpu_torch/testdata/tpch_sf1_expected.json
   (written by the JAX package), its join-tier selections must equal the
   reference's recorded there, and a query whose reference selects the
   merge-pallas tier must launch the merge kernel. Prints one line a query:
   rows, cold and warm wall, merge-kernel launches and tier counts.
4. mainpath: the merge kernel against its plain version, exact, on the
   very build and probe tensors the cold runs of phase tpch handed to it
   (one row a launch, with phase kernel's times), and every query whose
   reference selects merge-pallas must have handed it some.

With ``--profile`` it also runs each query once more (warm) under
torch.profiler and prints the device time by kernel, the device's busy
share of the wall, the device launches and the largest device item.

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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
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


def graph_ms(fn, launches: int, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``launches`` calls captured
    in one CUDA graph, replayed ``replays`` times between CUDA events. The
    host's cost per call drops out; the graph's gaps between kernels stay."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    torch.cuda.synchronize()
    return ms


def host_us(fn, iters: int) -> float:
    """Host microseconds per call of ``fn`` (the enqueue: no synchronise
    inside the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


def bound_bytes(nb: int, np_: int) -> int:
    """What the function must move: the probe read and the output written
    once, the build read once or one 32-byte sector a probe key."""
    return 8 * np_ + min(4 * nb, 32 * np_)


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
    # a build 16x denser than the probe: each probe tile spans about 32K
    # build keys, many ring chunks
    cases.append(("large_1m_16m", sorted_unique(16 << 20, 1 << 30),
                  probe_over(1 << 20, 1 << 30), 2048))
    # over a thousand full probe tiles and a ragged last one, against a
    # sparser build (one-chunk spans) and a denser one (several chunks)
    cases.append(("ragged_2m_1m", sorted_unique(1 << 20, 1 << 30),
                  probe_over((2 << 20) + 777, 1 << 30), 2048))
    cases.append(("ragged_2m_8m", sorted_unique(8 << 20, 1 << 30),
                  probe_over((2 << 20) + 777, 1 << 30), 2048))
    # one input, three block_build values: the outputs must be equal
    b = sorted_unique(1 << 16, 1 << 24)
    p = probe_over(1 << 20, 1 << 24)
    for bb in (128, 2048, 8192):
        cases.append((f"sweep_bb{bb}", b, p, bb))
    # Q2's SF1 shape: a build of 1024 slots, 804 live partkeys and a dead
    # INT32_MAX tail of 220, against 1024 probe keys that all match (517
    # distinct); drawn last so the shapes above keep their earlier inputs
    live = sorted_unique(804, 200_000)
    b = np.concatenate([live, np.full(220, INT32_MAX, np.int32)])
    p = np.sort(rng.choice(live, size=1024)).astype(np.int32)
    cases.insert(2, ("q2_sf1", b, p, 2048))
    return cases


def check_and_time(name, b, p, bb, **extra):
    """The merge kernel against its plain version on the card at one input
    (exact), then its times; returns (row, the kernel's output)."""
    import torch

    from trino_tpu_torch.ops import merge

    got = merge.merge_unique_sorted(b, p, block_build=bb)
    want = merge.merge_unique_sorted_plain(b, p, block_build=bb)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"merge kernel != plain at {name}: first bad {bad}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) \
        if got.numel() else 0
    nb, np_ = b.shape[0], p.shape[0]
    nbytes = bound_bytes(nb, np_)
    big = np_ >= (1 << 20)
    call = lambda: merge.merge_unique_sorted(b, p, block_build=bb)  # noqa: E731
    lib = lambda: library_merge(b, p)  # noqa: E731
    row = {
        "shape": name, "build": nb, "probe": np_, "block_build": bb, **extra,
        "max_abs_err": err,
        "kernel_device_ms": graph_ms(call, 20 if big else 200),
        "kernel_ms": time_ms(call, 20 if big else 200),
        "wrapper_host_us": host_us(call, 20 if big else 500),
        "plain_ms": time_ms(lambda: merge.merge_unique_sorted_plain(b, p, block_build=bb),
                            2 if big else 20),
        "library_device_ms": graph_ms(lib, 20 if big else 200) if nb and np_ else None,
        "library_ms": time_ms(lib, 20 if big else 200) if nb and np_ else None,
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
        "bytes": nbytes,
    }
    row["bound_share"] = (row["bound_ms"] / row["kernel_device_ms"]
                          if nbytes and np_ and nb else None)
    print("kernel", json.dumps(row), flush=True)
    return row, got


def phase_kernel(device):
    import numpy as np
    import torch

    from trino_tpu_torch.ops import merge

    rng = np.random.default_rng(1234)
    rows = []
    sweep_out = None
    for name, b_np, p_np, bb in kernel_cases(rng):
        b = torch.from_numpy(b_np).to(device)
        p = torch.from_numpy(p_np).to(device)
        row, got = check_and_time(name, b, p, bb)
        if name.startswith("sweep_"):
            if sweep_out is not None and not torch.equal(got, sweep_out):
                raise AssertionError(f"merge kernel output changes with block_build at {name}")
            sweep_out = got
        rows.append(row)
        del b, p, got
        torch.cuda.empty_cache()
    one_b = torch.zeros(1, dtype=torch.int32, device=device)
    one_p = torch.zeros(1, dtype=torch.int32, device=device)
    one = lambda: merge.merge_unique_sorted(one_b, one_p)  # noqa: E731
    call_1x1 = {"wrapper_call_ms_1x1": time_ms(one, 500),
                "kernel_device_ms_1x1": graph_ms(one, 200),
                "wrapper_host_us_1x1": host_us(one, 2000)}
    print("kernel", json.dumps(call_1x1), flush=True)
    return rows, call_1x1


def jsonable_rows(rows):
    return [[v if v is None or isinstance(v, (int, float, str)) else str(v) for v in r]
            for r in rows]


def tier_counts(metric, tiers):
    return {t: metric.value(t) for t in tiers}


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
    # the merge kernel's inputs as each cold run hands them to the wrapper,
    # for phase_mainpath to hold against the plain version afterwards; the
    # wrapper still counts every launch
    captured = []
    now = {"query": None, "run": None}
    wrapper = merge.merge_unique_sorted

    def capture(build, probe, block_build=2048):
        if now["run"] == "cold":
            captured.append((now["query"], build.clone(), probe.clone(), block_build))
        return wrapper(build, probe, block_build=block_build)

    merge.merge_unique_sorted = capture
    out = {}
    try:
        for q in range(1, 23):
            entry = expected[str(q)]
            want_tiers = entry["tiers"]
            runs = []
            for label in ("cold", "warm"):
                now.update(query=q, run=label)
                merge.launches = 0
                t0_tiers = tier_counts(M.FUSED_JOIN_SELECTIONS, want_tiers)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = session.execute(entry["sql"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = merge.launches
                tiers = {t: v - t0_tiers[t]
                         for t, v in tier_counts(M.FUSED_JOIN_SELECTIONS, want_tiers).items()}
                got = jsonable_rows(res.rows)
                want = entry["rows"]
                if got != want:
                    same = sorted(map(repr, got)) == sorted(map(repr, want))
                    raise AssertionError(
                        f"Q{q} ({label}) rows differ from the expected rows: {len(got)} vs "
                        f"{len(want)} rows{' (same rows, another order)' if same else ''}; "
                        f"first got {got[:2]}, want {want[:2]}")
                if tiers != want_tiers:
                    raise AssertionError(
                        f"Q{q} ({label}) join tiers {tiers} != the reference's {want_tiers}")
                if want_tiers.get("merge-pallas", 0) >= 1 and launches < 1:
                    raise AssertionError(
                        f"Q{q} ({label}) selected merge-pallas but did not launch the merge "
                        f"kernel: launches={launches}")
                runs.append({"run": label, "wall_s": wall, "merge_launches": launches})
            out[q] = runs
            print("tpch", json.dumps({"query": f"Q{q}", "scale": "sf1", "rows": len(res.rows),
                                      "tiers": tiers, "runs": runs}), flush=True)
    finally:
        merge.merge_unique_sorted = wrapper
    return out, session, expected, captured


def phase_mainpath(captured):
    """The merge kernel against its plain version on the very inputs the
    22 queries' cold runs gave it (exact), with the same times as phase
    kernel; one row a launch, named after its query."""
    import torch

    rows = []
    seen = {}
    for q, b, p, bb in captured:
        seen[q] = seen.get(q, 0) + 1
        row, _ = check_and_time(f"q{q}_sf1_mainpath_{seen[q]}", b, p, bb,
                                live_build=int((b != INT32_MAX).sum().item()))
        rows.append(row)
    del captured[:]
    torch.cuda.empty_cache()
    return rows


def phase_profile(session, expected):
    """``--profile``: one more warm run of each query under torch.profiler:
    device time by kernel name and the device's busy share of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for q in range(1, 23):
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
                    for us, c, k in by_kernel[:8]]}), flush=True)


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
    rows, call_1x1 = phase_kernel(device)
    tpch, session, expected, captured = phase_tpch(device)
    merge_queries = sorted(int(q) for q, e in expected.items()
                           if e["tiers"].get("merge-pallas", 0) >= 1)
    if sorted({q for q, *_ in captured}) != merge_queries:
        raise AssertionError(f"merge kernel inputs captured for queries "
                             f"{sorted({q for q, *_ in captured})}, want {merge_queries}")
    rows += phase_mainpath(captured)
    if "--profile" in sys.argv[1:]:
        phase_profile(session, expected)
    main_shape = next(r for r in rows if r["shape"] == "q17_sf1")
    launches = sum(run["merge_launches"] for runs in tpch.values()
                   for run in runs if run["run"] == "cold")
    if launches < 1:
        raise AssertionError("the 22 queries' cold runs launched the merge kernel no time")
    print("tpch_total", json.dumps({
        f"{label}_wall_s": sum(run["wall_s"] for runs in tpch.values()
                               for run in runs if run["run"] == label)
        for label in ("cold", "warm")}), flush=True)
    summary = {
        "name": "merge_unique_sorted",
        "route": "cuda",
        "source": "trino_tpu_torch/csrc/merge_unique_sorted.cu",
        "replaces": "trino_tpu/ops/merge_pallas.py:99",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_shape["kernel_ms"],
        "device_ms": main_shape["kernel_device_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_shape["library_ms"],
        "library_device_ms": main_shape["library_device_ms"],
        "shape": "q17_sf1 build 256 x probe 6113",
        "launch_floor_ms": call_1x1["wrapper_call_ms_1x1"],
        **call_1x1,
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
