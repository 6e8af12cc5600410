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
   rows, cold and warm wall, merge-kernel launches, tier counts, rows and
   bytes staged and the staging phase seconds (scan, decode, transfer).
4. cache: a second session with ``device_cache_enabled=true`` runs the 22
   queries at SF1, all cold (empty device and host caches), then all warm.
   Each run's rows must equal the expected rows and its join tiers the
   reference's recorded with the cache on (``tiers_cached`` in
   trino_tpu_torch/testdata/plane_expected.json: Q5 and Q9 take the merge
   tier through a cached sorted build). Every warm run must stage zero rows,
   copy zero scanned-column bytes host->device and look every scan up as a
   hit, and the warm runs must leave every cached tensor bitwise as the
   cold runs made it. Prints a line a query (walls, cache lookups, rows
   and bytes staged, the staging phase seconds) and the cache's resident
   bytes beside ``torch.cuda.memory_allocated``.
5. mainpath: the merge kernel against its plain version, exact, on the
   very build and probe tensors the cold runs of phases tpch and cache
   handed to it (one row a launch, with phase kernel's times), and every
   query whose reference selects merge-pallas must have handed it some in
   both sessions.
6. sf10: first the pinned double-buffered host->device copy of the
   staging module on its own (int32, int64, float64 and bool columns of
   4M + 3 rows in 1 MiB blocks, and a column of five int64 split parts
   narrowed to int32 in 1 MiB and 32 MiB blocks; bitwise equal, read on the
   consuming stream at once); then TPC-H Q3 at SF10 in a cached session, cold then warm:
   rows equal to the JAX package's, the warm run staging nothing.
7. spill: Q3 (joins), Q18 (aggregation under a semi join) and Q13 (left
   join) at SF1 in a cached session under ``query_max_device_memory`` of a
   quarter of the largest working set the reference's unbudgeted run
   handed its spill decision. Each must spill into 4 or more partitions
   and return the reference's rows (a tie group of the ORDER BY compared
   as a multiset).
8. dml: in a session over shared catalogs, CREATE TABLE AS from
   tpch.sf1.orders into the memory catalog, then INSERT, UPDATE, DELETE,
   DROP and CREATE TABLE AS again, each followed by a cached aggregate
   over the table: the read after each statement must miss, a repeated
   read hit, and every read return the rows the JAX package recorded for
   the same sequence; no entry of an older table version may stay.

With ``--profile`` it also runs each query once more (warm) in each session
under torch.profiler and prints the device time by kernel, the device's busy
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


def testdata(name):
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "trino_tpu_torch", "testdata", name)) as f:
        return json.load(f)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def plane_counters():
    """The staging and device-cache counters a run moves."""
    from trino_tpu_torch.obs import metrics as M

    return {"hits": M.DEVICE_CACHE_HITS.value(), "misses": M.DEVICE_CACHE_MISSES.value(),
            "build_hits": M.DEVICE_CACHE_BUILD_HITS.value(),
            "staged_rows": M.STAGED_ROWS.value(), "h2d_bytes": M.STAGED_H2D_BYTES.value(),
            **{f"{ph}_s": M.STAGING_PHASE_SECONDS.value(ph)
               for ph in ("scan", "decode", "transfer", "host-cache")}}


def counters_delta(before):
    now = plane_counters()
    return {k: now[k] - before[k] for k in before}


def timed_execute(session, sql, device):
    """(result, wall seconds, plane counter deltas) of one statement."""
    c0 = plane_counters()
    sync(device)
    t0 = time.perf_counter()
    res = session.execute(sql)
    sync(device)
    return res, time.perf_counter() - t0, counters_delta(c0)


def check_rows(what, got, want, sort_keys=None):
    """Exact rows in order; with ``sort_keys`` (the ORDER BY's column
    positions) a tie group may differ in order and is compared as a
    multiset."""
    if got == want:
        return
    same_order = sort_keys is not None and len(got) == len(want) and \
        [[r[k] for k in sort_keys] for r in got] == [[r[k] for k in sort_keys] for r in want]
    if same_order and sorted(map(repr, got)) == sorted(map(repr, want)):
        return
    same = sorted(map(repr, got)) == sorted(map(repr, want))
    raise AssertionError(
        f"{what}: rows differ from the expected rows: {len(got)} vs {len(want)} rows"
        f"{' (same rows, another order)' if same else ''}; first got {got[:2]}, "
        f"want {want[:2]}")


class MergeCapture:
    """Wraps the merge kernel's wrapper while the queries run: keeps the
    inputs of every cold run for phase mainpath (the wrapper still counts
    each launch, and the capture launches nothing)."""

    def __init__(self):
        self.captured = []  # (path, query, build, probe, block_build)
        self.now = None  # (path, query, run)

    def __enter__(self):
        from trino_tpu_torch.ops import merge

        self.wrapper = merge.merge_unique_sorted

        def capture(build, probe, block_build=2048):
            if self.now is not None and self.now[2] == "cold":
                self.captured.append((self.now[0], self.now[1], build.clone(),
                                      probe.clone(), block_build))
            return self.wrapper(build, probe, block_build=block_build)

        merge.merge_unique_sorted = capture
        return self

    def __exit__(self, *exc):
        from trino_tpu_torch.ops import merge

        merge.merge_unique_sorted = self.wrapper
        self.now = None


def run_checked(session, device, path, q, label, sql, want_rows, want_tiers, cap):
    """One run of query ``q``: rows and join tiers checked, merge launches
    counted from 0 just before it; returns (wall, launches, counters)."""
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.ops import merge

    cap.now = (path, q, label)
    merge.launches = 0
    t0_tiers = tier_counts(M.FUSED_JOIN_SELECTIONS, want_tiers)
    res, wall, counters = timed_execute(session, sql, device)
    launches = merge.launches
    cap.now = None
    tiers = {t: v - t0_tiers[t]
             for t, v in tier_counts(M.FUSED_JOIN_SELECTIONS, want_tiers).items()}
    check_rows(f"Q{q} ({path}, {label})", jsonable_rows(res.rows), want_rows)
    if tiers != want_tiers:
        raise AssertionError(
            f"Q{q} ({path}, {label}) join tiers {tiers} != the reference's {want_tiers}")
    if want_tiers.get("merge-pallas", 0) >= 1 and launches < 1:
        raise AssertionError(f"Q{q} ({path}, {label}) selected merge-pallas but did not "
                             f"launch the merge kernel: launches={launches}")
    return wall, launches, counters, len(res.rows)


def phase_tpch(device, expected, cap):
    from trino_tpu_torch import Session

    session = Session(properties={"catalog": "tpch", "schema": "sf1",
                                  "fused_join_pallas": True}, device=device)
    out = {}
    for q in range(1, 23):
        entry = expected[str(q)]
        runs = []
        for label in ("cold", "warm"):
            wall, launches, c, nrows = run_checked(
                session, device, "tpch", q, label, entry["sql"], entry["rows"],
                entry["tiers"], cap)
            runs.append({"run": label, "wall_s": wall, "merge_launches": launches,
                         "staged_rows": c["staged_rows"], "h2d_bytes": c["h2d_bytes"],
                         **{k: c[k] for k in ("scan_s", "decode_s", "transfer_s")}})
        out[q] = runs
        print("tpch", json.dumps({"query": f"Q{q}", "scale": "sf1", "rows": nrows,
                                  "tiers": entry["tiers"], "runs": runs}), flush=True)
    return out, session


def cached_tensors():
    """Every tensor of every resident device-cache entry."""
    from trino_tpu_torch.devcache import DEVICE_CACHE

    out = {}
    for e in DEVICE_CACHE.entries():
        v = e.value
        if hasattr(v, "columns"):
            ts = [t for c in v.columns for t in (c.values, c.nulls, c.hi) if t is not None]
            ts += [v.sel] if v.sel is not None else []
        else:  # a sorted build
            ts = list(v.cols) + [v.rows, v.live]
        out[e.key] = ts
    return out


def phase_cache(device, expected, plane, cap):
    """The 22 queries in a cached session: all cold, then all warm."""
    import torch

    from trino_tpu_torch import Session
    from trino_tpu_torch.devcache import DEVICE_CACHE, HOST_CACHE

    DEVICE_CACHE.invalidate_all()
    HOST_CACHE.invalidate_all()
    session = Session(properties={"catalog": "tpch", "schema": "sf1", "fused_join_pallas": True,
                                  "device_cache_enabled": True}, device=device)
    runs = {q: {} for q in range(1, 23)}
    for label in ("cold", "warm"):
        if label == "warm":
            snapshot = {k: [t.clone() for t in ts] for k, ts in cached_tensors().items()}
        for q in range(1, 23):
            entry = expected[str(q)]
            wall, launches, c, nrows = run_checked(
                session, device, "cache", q, label, entry["sql"], entry["rows"],
                plane["tiers_cached"][str(q)][label], cap)
            runs[q][label] = {"wall_s": wall, "merge_launches": launches, **c}
        if label == "warm":
            for q in range(1, 23):
                cold, warm = runs[q]["cold"], runs[q]["warm"]
                if warm["staged_rows"] or warm["h2d_bytes"] or warm["misses"] \
                        or warm["hits"] != cold["hits"] + cold["misses"]:
                    raise AssertionError(
                        f"Q{q} (cache, warm) was not served from the cache: staged "
                        f"{warm['staged_rows']} rows, {warm['h2d_bytes']} bytes, "
                        f"{warm['misses']} misses, {warm['hits']} hits of "
                        f"{cold['hits'] + cold['misses']} lookups")
            after = cached_tensors()
            if after.keys() != snapshot.keys() or not all(
                    torch.equal(t, s) for k in after for t, s in zip(after[k], snapshot[k])):
                raise AssertionError("a warm run changed a cached tensor or entry")
            del snapshot
    for q in range(1, 23):
        print("cache", json.dumps({
            "query": f"Q{q}", "tiers": plane["tiers_cached"][str(q)]["warm"],
            **{f"{label}_{k}": v for label in ("cold", "warm")
               for k, v in runs[q][label].items()}}), flush=True)
    resident = {"resident_bytes": DEVICE_CACHE.cached_bytes(), "entries": len(DEVICE_CACHE),
                "host_tier_bytes": HOST_CACHE.cached_bytes(), "budget_bytes": DEVICE_CACHE.max_bytes,
                "memory_allocated": torch.cuda.memory_allocated(device) if device.type == "cuda"
                else None}
    print("cache_total", json.dumps({
        **{f"{label}_{k}": sum(runs[q][label][k] for q in runs)
           for label in ("cold", "warm")
           for k in ("wall_s", "staged_rows", "h2d_bytes", "scan_s", "decode_s", "transfer_s")},
        **resident}), flush=True)
    return runs, resident, session


def phase_mainpath(captured, merge_queries):
    """The merge kernel against its plain version on the very inputs the
    cold runs of both sessions gave it (exact), with the same times as
    phase kernel; one row a launch, named after its session and query."""
    import torch

    for path in ("tpch", "cache"):
        got = sorted({q for p, q, *_ in captured if p == path})
        if got != merge_queries:
            raise AssertionError(f"{path}: merge kernel inputs captured for queries {got}, "
                                 f"want {merge_queries}")
    rows = []
    seen = {}
    for path, q, b, p, bb in captured:
        seen[(path, q)] = seen.get((path, q), 0) + 1
        row, _ = check_and_time(f"q{q}_sf1_{path}_mainpath_{seen[(path, q)]}", b, p, bb,
                                live_build=int((b != INT32_MAX).sum().item()))
        rows.append(row)
    del captured[:]
    torch.cuda.empty_cache()
    return rows


def phase_transfer(device):
    """The pinned double-buffered copy (exec/staging.py) on the card, for
    each dtype a scan stages: more than two blocks, bitwise the input, and
    read by the consuming stream straight after the call."""
    import numpy as np
    import torch

    from trino_tpu_torch.exec import staging

    rng = np.random.default_rng(5)
    out = []
    for dtype in (np.int32, np.int64, np.float64, np.bool_):
        arr = (rng.integers(0, 2, size=(1 << 22) + 3).astype(np.bool_) if dtype is np.bool_
               else rng.integers(-2**30, 2**30, size=(1 << 22) + 3).astype(dtype))
        prof = staging.StageProfile()
        got = staging.blocked_transfer(device, prof, block_bytes=1 << 20)(arr)
        total = got.to(torch.float64).sum()  # on the consuming stream, no sync first
        want_blocks = -(-arr.nbytes // ((1 << 20) // arr.itemsize * arr.itemsize))
        if prof.transfer_blocks != want_blocks or not np.array_equal(got.cpu().numpy(), arr) \
                or float(total.item()) != float(arr.astype(np.float64).sum()):
            raise AssertionError(f"blocked transfer of {arr.dtype}: {prof.transfer_blocks} "
                                 f"blocks (want {want_blocks}) or a wrong copy")
        out.append({"dtype": str(arr.dtype), "bytes": int(arr.nbytes),
                    "blocks": prof.transfer_blocks})
    # a column as per-split int64 parts narrowed to int32 on the way: packed
    # into the pinned buffers across block edges (more than two blocks), or
    # copied one part into each slice (at most two)
    parts = [rng.integers(-2**30, 2**30, size=n) for n in (700_001, 0, 1_300_000, 9, 524_288)]
    want = np.concatenate(parts).astype(np.int32)
    for block_bytes in (1 << 20, 32 << 20):
        prof = staging.StageProfile()
        got = staging.blocked_transfer(device, prof, block_bytes=block_bytes)(parts, np.int32)
        total = got.to(torch.int64).sum()
        want_blocks = -(-want.nbytes // block_bytes) if want.nbytes > 2 * block_bytes else 0
        if got.dtype != torch.int32 or prof.transfer_blocks != want_blocks \
                or not np.array_equal(got.cpu().numpy(), want) \
                or int(total.item()) != int(want.astype(np.int64).sum()):
            raise AssertionError(f"transfer of {len(parts)} parts in {block_bytes}-byte blocks: "
                                 f"{prof.transfer_blocks} blocks (want {want_blocks}) or a "
                                 f"wrong copy")
        out.append({"parts": len(parts), "dtype": "int64->int32", "bytes": int(want.nbytes),
                    "block_bytes": block_bytes, "blocks": prof.transfer_blocks})
    print("transfer", json.dumps(out), flush=True)


def phase_sf10(device, plane):
    """Q3 at SF10 in a cached session, cold then warm."""
    import torch

    from trino_tpu_torch import Session
    from trino_tpu_torch.devcache import DEVICE_CACHE

    entry = plane["sf10"]["3"]
    session = Session(properties={"catalog": "tpch", "schema": "sf10", "fused_join_pallas": True,
                                  "device_cache_enabled": True}, device=device)
    out = {}
    for label in ("cold", "warm"):
        res, wall, c = timed_execute(session, entry["sql"], device)
        check_rows(f"Q3 at SF10 ({label})", jsonable_rows(res.rows), entry["rows"])
        out[label] = {"wall_s": wall, **c}
    if out["warm"]["staged_rows"] or out["warm"]["h2d_bytes"] or out["warm"]["misses"]:
        raise AssertionError(f"Q3 at SF10 (warm) was not served from the cache: {out['warm']}")
    line = {"query": "Q3", "scale": "sf10", "rows": len(entry["rows"]),
            **{f"{label}_{k}": v for label in out for k, v in out[label].items()},
            "cache_resident_gib": DEVICE_CACHE.cached_bytes() / 2**30,
            "memory_allocated_gib": (torch.cuda.memory_allocated(device) / 2**30
                                     if device.type == "cuda" else None)}
    print("sf10", json.dumps(line), flush=True)
    return line


SPILL_SORT_KEYS = {"3": (1, 2), "18": (4, 3), "13": (1, 0)}  # ORDER BY positions


def phase_spill(device, plane):
    """The spill queries at SF1 under the reference's budgets, cache on."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.exec.executor import Executor
    from trino_tpu_torch.exec.query import plan_sql

    lines = []
    for q, entry in plane["spill"].items():
        props = {"catalog": "tpch", "schema": "sf1", "fused_join_pallas": True,
                 "device_cache_enabled": True}
        # the largest working set the unbudgeted run hands the spill decision
        s = Session(dict(props), device=device)
        unbudgeted = Executor(s)
        unbudgeted.execute_checked(plan_sql(s, entry["sql"]))
        s = Session(dict(props, query_max_device_memory=entry["budget"]), device=device)
        ex = Executor(s)
        sync(device)
        t0 = time.perf_counter()
        rows = ex.execute_checked(plan_sql(s, entry["sql"])).to_pylist()
        sync(device)
        wall = time.perf_counter() - t0
        check_rows(f"Q{q} under a {entry['budget']}-byte budget", jsonable_rows(rows),
                   entry["rows"], SPILL_SORT_KEYS.get(q))
        spills = [{"kind": e.kind, "partitions": e.partitions,
                   "projected_bytes": e.projected_bytes} for e in ex.memory.spills]
        if not spills or max(e["partitions"] for e in spills) < 4:
            raise AssertionError(f"Q{q} under a {entry['budget']}-byte budget spilled "
                                 f"{spills}: want a spill of 4 or more partitions")
        line = {"query": f"Q{q}", "budget": entry["budget"],
                "peak_projected": unbudgeted.memory.peak_projected,
                "reference_peak_projected": entry["peak_projected"], "wall_s": wall,
                "spills": spills, "reference_spills": entry["spills"],
                "cache_bytes_yielded": ex.memory.shed_bytes, "peak": ex.memory.peak}
        print("spill", json.dumps(line), flush=True)
        lines.append(line)
    return lines


def phase_dml(device, plane):
    """The DML sequence over shared catalogs: every statement invalidates,
    every read equals the reference's, no stale entry survives."""
    from trino_tpu_torch import Session
    from trino_tpu_torch.connector.registry import default_catalogs
    from trino_tpu_torch.devcache import DEVICE_CACHE

    catalogs = default_catalogs()
    session = Session(properties={"catalog": "tpch", "schema": "sf1",
                                  "device_cache_enabled": True},
                      device=device, catalogs=catalogs)
    memory_conn = catalogs["memory"]
    lines = []
    for i, step in enumerate(plane["dml"]["steps"]):
        res, wall, c = timed_execute(session, step["sql"], device)
        what = f"dml step {i} ({step['sql'][:40]})"
        check_rows(what, jsonable_rows(res.rows), step["rows"])
        if step["kind"] == "read":
            got = "hit" if (c["hits"], c["misses"]) == (1, 0) else \
                "miss" if (c["hits"], c["misses"]) == (0, 1) else str(c)
            if got != step["disposition"]:
                raise AssertionError(f"{what}: cache {got}, the reference's {step['disposition']}")
            version = memory_conn.data_version("db", "orders")
            held = {e["version"] for e in DEVICE_CACHE.snapshot()
                    if (e["catalog"], e["table"]) == ("memory", "orders")}
            if held != {str(version)}:
                raise AssertionError(f"{what}: cache holds versions {held} of memory.db.orders, "
                                     f"the table is at {version}")
        line = {"step": i, "kind": step["kind"], "sql": step["sql"][:60], "wall_s": wall,
                "disposition": step["disposition"], "staged_rows": c["staged_rows"],
                "h2d_bytes": c["h2d_bytes"]}
        print("dml", json.dumps(line), flush=True)
        lines.append(line)
    return lines


def phase_profile(session, expected, label):
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
            "session": label, "query": f"Q{q}", "wall_s": wall, "device_s": device_s,
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
    expected = testdata("tpch_sf1_expected.json")["queries"]
    plane = testdata("plane_expected.json")
    with MergeCapture() as cap:
        tpch, session = phase_tpch(device, expected, cap)
        cache_runs, _resident, cached_session = phase_cache(device, expected, plane, cap)
    merge_queries = sorted(int(q) for q, e in expected.items()
                           if e["tiers"].get("merge-pallas", 0) >= 1)
    rows += phase_mainpath(cap.captured, merge_queries)
    if "--profile" in sys.argv[1:]:
        phase_profile(session, expected, "uncached")
        phase_profile(cached_session, expected, "cached")
    del session, cached_session
    phase_transfer(device)
    phase_sf10(device, plane)
    phase_spill(device, plane)
    phase_dml(device, plane)
    main_shape = next(r for r in rows if r["shape"] == "q17_sf1")
    # each path's launches, counted from 0 just before each of its runs
    launches_by_path = {
        "tpch": sum(run["merge_launches"] for runs in tpch.values() for run in runs),
        "cache": sum(run["merge_launches"] for runs in cache_runs.values()
                     for run in runs.values())}
    for path, n in launches_by_path.items():
        if n < 1:
            raise AssertionError(f"the 22 queries of path {path} launched the merge kernel "
                                 f"no time")
    # as since the first slice: the launches of the uncached session's cold
    # runs (launches_by_path has every run of both sessions)
    launches = sum(run["merge_launches"] for runs in tpch.values() for run in runs
                   if run["run"] == "cold")
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
        "launches_by_path": launches_by_path,
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
