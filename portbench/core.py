"""One run of one cell: set-up, the measured window, the traced passes, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, cell, traffic driver,
benchmark family or per-layer metric lives in a file of its own and is found
here by name: ``configs/<config>.json``, ``workloads/<cell>.json`` (read by
the one generator, ``traffic.py``), ``drivers/<driver>.py``, the family that
a configuration's ``benchmark`` key names (``queries/<benchmark>/params.py``,
``reference/<benchmark>.py``) and ``metrics/<reader>.py``. A metric named
``<name>.<qualifier>`` is the quantity ``<name>`` in the cells it lists, so
cells whose end-to-end metrics differ read one quantity under two names.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules no run may hold once its window has closed, by top-level name:
# the JAX package is the port's reference, never its dependency
FORBIDDEN = ("jax", "jaxlib", "flax", "trino_tpu")
PORT_SPAN_FAMILY = ("staging/", "device-cache/lookup")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path):
    return json.loads(path.read_text())


def family(config: dict):
    """The substitution rules and the plain reference of the configuration's
    benchmark: ``queries/<benchmark>/params.py``, ``reference/<benchmark>.py``."""
    name = config["benchmark"]
    return (importlib.import_module(f"portbench.queries.{name}.params"),
            importlib.import_module(f"portbench.reference.{name}"))


@dataclass
class Span:
    name: str
    t0: float
    t1: float


@dataclass
class Profile:
    """What the traced passes read from torch.profiler."""
    window_s: float
    busy_s: float
    kernel_s: float
    launches: int
    queries: List[int]
    device_ops: List[list]
    idle_gaps: List[list]


@dataclass
class Run:
    config: dict
    traffic: object  # traffic.Traffic
    seed: int
    seconds: float
    device: object
    state: dict = field(default_factory=dict)
    spans: List[Span] = field(default_factory=list)  # the window's
    profile_spans: List[Span] = field(default_factory=list)  # the traced passes'
    staging_spans: int = 0
    staging_s: float = 0.0
    latencies: List[float] = field(default_factory=list)
    by_query: Dict[int, List[float]] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    errors: List[str] = field(default_factory=list)
    window_s: float = 0.0
    counters: Dict[str, float] = field(default_factory=dict)
    kept: Dict[tuple, list] = field(default_factory=dict)
    answered: set = field(default_factory=set)
    profile: Optional[Profile] = None
    recording: bool = False
    profiling: bool = False
    tracers: list = field(default_factory=list)
    lock: object = field(default_factory=threading.Lock)

    @property
    def completed(self) -> int:
        return len(self.latencies)

    @contextlib.contextmanager
    def span(self, name: str):
        """A harness span around a call into one layer (recorded when
        tracing; the traced passes' apart from the window's)."""
        if not self.recording:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            (self.profile_spans if self.profiling else self.spans).append(
                Span(name, t0, time.perf_counter()))

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def counters() -> Dict[str, float]:
    """Every series of the port's metrics registry, summed over labels."""
    from trino_tpu_torch.obs.metrics import REGISTRY

    out = {}
    for name in REGISTRY.names():
        m = REGISTRY.get(name)
        try:
            out[name] = sum(v for n, _, v in m.samples() if n == name)
        except Exception:  # histograms and gauges without a plain series
            continue
    return out


def _port_spans(run: Run, tracer) -> None:
    """Fold one query's port spans into the staging family's time (family
    spans nested in another family span count once)."""
    spans = tracer.spans()
    fam = {s.span_id for s in spans if s.name.startswith(PORT_SPAN_FAMILY)}
    with run.lock:
        for s in spans:
            if s.span_id in fam and s.parent_id not in fam and s.duration is not None:
                run.staging_spans += 1
                run.staging_s += s.duration


def call(run: Run, driver, key, client: int):
    """One instance through the driver; with tracing, under a fresh port tracer."""
    if not run.recording:
        return driver.execute(run, key, client)
    from trino_tpu_torch.obs import trace

    tracer = trace.Tracer(max_spans=1 << 20)
    with trace.activate(tracer):
        rows = driver.execute(run, key, client)
    if run.profiling:
        run.tracers.append(tracer)
    else:
        _port_spans(run, tracer)
    return rows


def _serve(run: Run, driver, key, client: int, i: int, since: float, sample: set) -> None:
    """Send one instance and record its latency from ``since`` (when it was
    sent, or when it arrived), and the rows the check keeps."""
    with run.lock:
        run.attempted += 1
    try:
        rows = call(run, driver, key, client)
    except Exception as e:  # a query that never answers fails the run
        with run.lock:
            run.failed += 1
            run.errors.append(f"Q{key[0]} ({key[1]}): {type(e).__name__}: {e}"[:300])
        return
    latency = time.perf_counter() - since
    p = i // run.traffic.n
    with run.lock:
        run.latencies.append(latency)
        run.by_query.setdefault(key[0], []).append(latency)
        run.answered.add(key[0])
        if p in sample:
            run.kept[(key, (client, p))] = rows
        run.kept[(key, "last")] = rows


def _closed_stream(run: Run, driver, client: int, t0: float, sample: set) -> None:
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        _serve(run, driver, run.traffic.key(client, i), client, i, time.perf_counter(), sample)
        i += 1


def _open_arrivals(run: Run, driver, t0: float, sample: set) -> None:
    """One stream of arrivals at the traffic's rate, each taken by the first
    free client; after the last arrival the window ends when every query
    that arrived has answered."""
    import queue

    tr = run.traffic
    todo: "queue.Queue" = queue.Queue()

    def client(c):
        while True:
            item = todo.get()
            if item is None:
                return
            at, i, key = item
            _serve(run, driver, key, c, i, at, sample)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(tr.clients)]
    for t in threads:
        t.start()
    at, i = t0, 0
    for gap in tr.arrival_gaps():
        at += gap
        if at - t0 >= run.seconds:
            break
        key = tr.key(0, i)
        wait = at - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        todo.put((at, i, key))
        i += 1
    for _ in threads:
        todo.put(None)
    for t in threads:
        t.join()


def window(run: Run, driver) -> None:
    """The measured window, as the cell's traffic file sets it: closed
    streams, one a client, each until ``seconds`` have passed (the query in
    flight then ends it), or open arrivals. Keeps the rows of the sampled
    passes and of each instance's last run for the check."""
    tr = run.traffic
    sample = tr.sample_passes()
    t0 = time.perf_counter()
    if not tr.closed:
        _open_arrivals(run, driver, t0, sample)
    elif tr.clients == 1:
        _closed_stream(run, driver, 0, t0, sample)
    else:
        threads = [threading.Thread(target=_closed_stream, args=(run, driver, c, t0, sample),
                                    daemon=True) for c in range(tr.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    run.window_s = time.perf_counter() - t0


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profiled_passes(run: Run, driver, passes: int) -> None:
    """Whole passes of the queries under torch.profiler, from one client:
    the device's busy time, kernel time and launches, the top device
    operations, and the idle gaps named by the span open on the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    keys = run.traffic.profile_keys(passes)
    run.sync()
    run.profiling = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench/anchor"):
            anchor = time.perf_counter()
        t0 = time.perf_counter()
        for key in keys:
            call(run, driver, key, 0)
        run.sync()
        t1 = time.perf_counter()
    run.profiling = False
    events = prof.events()
    base = next(e.time_range.start for e in events if e.name == "portbench/anchor")

    def at(t):  # host perf_counter seconds -> trace microseconds
        return base + (t - anchor) * 1e6

    lo, hi = at(t0), at(t1)
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    intervals = [(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in dev]
    busy = _union([iv for iv in intervals if iv[1] > iv[0]])
    busy_us = sum(e - s for s, e in busy)
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset", "Activity Buffer"))]
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    # host spans in trace time: the harness's and the port's
    named = [(at(s.t0), at(s.t1), s.name) for s in run.profile_spans]
    for tr in run.tracers:
        for s in tr.spans():
            if s.duration is not None:
                named.append((at(s._t0), at(s._t0 + s.duration), s.name))
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        open_ = [n for n in named if n[0] <= mid <= n[1]]
        name = min(open_, key=lambda n: n[1] - n[0])[2] if open_ else "harness"
        gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e6
    run.profile = Profile(
        window_s=t1 - t0, busy_s=busy_us / 1e6,
        kernel_s=sum(e.time_range.end - e.time_range.start for e in kernels) / 1e6,
        launches=len(kernels), queries=[k[0] for k in keys],
        device_ops=[[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]])
    run.tracers = []
    del prof, events


def release_program_state() -> None:
    """Drop what the port keeps process-wide (the device and host table
    caches, the connectors' generated ranges), so that the reference runs in
    the memory the window used."""
    from trino_tpu_torch.devcache.cache import DEVICE_CACHE
    from trino_tpu_torch.devcache.hostcache import HOST_CACHE

    DEVICE_CACHE.invalidate_all()
    HOST_CACHE.invalidate_all()
    for name, module in list(sys.modules.items()):
        if name.startswith("trino_tpu_torch.connector.") and \
                isinstance(getattr(module, "_gen_cache", None), dict):
            module._gen_cache.clear()


def check(run: Run) -> dict:
    """The kept answers of the compared instances against the plain
    reference's at the cell's scale."""
    import torch

    _, ref_module = family(run.config)
    t0 = time.perf_counter()
    chosen = run.traffic.compared(key for key, _ in run.kept)
    ref = ref_module.reference_answers(
        run.config, {k: run.traffic.instances[k] for k in chosen}, run.device)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    compared, mismatched, notes = 0, 0, []
    for (key, p), rows in sorted(run.kept.items(), key=lambda kv: repr(kv[0])):
        if key not in chosen:
            continue
        compared += 1
        got = ref_module.canonical(rows)
        if not ref_module.same_answer(key[0], got, ref[key]):
            mismatched += 1
            notes.append(f"Q{key[0]} ({key[1]}) pass {p}: "
                         f"{ref_module.first_difference(got, ref[key])}")
    unanswered = len(set(run.traffic.queries) - run.answered)
    return {"compared": compared, "instances": len(chosen), "mismatched": mismatched,
            "unanswered": unanswered, "notes": notes[:10], "seconds": time.perf_counter() - t0}


def end_to_end(run: Run, setup_s: float) -> Dict[str, float]:
    return {
        "queries_per_s": run.completed / run.window_s,
        "latency_p90_ms": float(np.percentile(run.latencies, 90)) * 1e3,
        "setup_s": setup_s,
    }


def quantity(name: str) -> str:
    """The quantity a metric's name reads: the part before its qualifier."""
    return name.split(".")[0]


def per_layer(run: Run, names: List[str]) -> Dict[str, float]:
    out = {}
    for name in names:
        mod = importlib.import_module(f"portbench.metrics.{quantity(name)}")
        value = mod.read(run)
        if value is not None:
            out[name] = value
    return out


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, config_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None) -> dict:
    """One run of ``cell_name``; returns the result object the run prints.
    The overrides replace keys of the configuration and of the traffic file
    (the CPU tests' sizes and mixes)."""
    import torch

    from portbench.traffic import Traffic

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    config.update(config_overrides or {})
    spec = load_json(HERE / "workloads" / f"{cell_name}.json")
    spec.update(traffic_overrides or {})
    params_module, _ = family(config)
    traffic = Traffic(spec, seed, float(config["scale_factor"]), params_module)
    driver = importlib.import_module(f"portbench.drivers.{spec['driver']}")
    run = Run(config, traffic, seed, seconds, torch.device(device))

    driver.setup(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    c0 = counters()
    run.recording = trace
    window(run, driver)
    if trace:
        run.counters = {k: v - c0.get(k, 0.0) for k, v in counters().items()}
        profiled_passes(run, driver, int(spec["profiled_passes"]))
    run.recording = False
    if run.device.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(run.device))
        kind, count = torch.cuda.get_device_name(run.device), 1
    else:
        peak, kind, count = 0, "cpu", 1
    driver.teardown(run)
    release_program_state()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    checked = check(run)
    names_e2e = [m["name"] for m in bench["end_to_end"]
                 if "workloads" not in m or cell_name in m["workloads"]]
    names_layer = [m["name"] for m in bench["per_layer"]
                   if "workloads" not in m or cell_name in m["workloads"]]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        values = per_layer(run, names_layer)
    else:
        e2e = end_to_end(run, setup_s) if run.latencies else {"setup_s": setup_s}
        values = {k: e2e[quantity(k)] for k in names_e2e if quantity(k) in e2e}
    device_info = {"platform": "gpu" if run.device.type == "cuda" else "cpu", "kind": kind,
                   "count": count, "memory_peak_bytes": peak}
    result = {
        "correct": False, "attempted": run.attempted, "failed": run.failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": device_info,
    }
    if trace and run.profile is not None:
        device_info["busy_s"] = run.profile.busy_s
        device_info["window_s"] = run.profile.window_s
        result["breakdown"] = {"device_ops": run.profile.device_ops,
                               "idle_gaps": run.profile.idle_gaps}
    limits = {"mismatched_answers": (checked["mismatched"], 0),
              "failed_queries": (run.failed, 0),
              "queries_not_compared": (checked["unanswered"], 0)}
    result["correct"] = all(v <= lim for v, lim in limits.values())
    result["notes"] = {"errors": run.errors[:5], "differences": checked["notes"],
                       "answers_compared": checked["compared"],
                       "instances_compared": checked["instances"],
                       "reference_s": checked["seconds"], "window_queries": run.completed,
                       "latency_ms_by_query": {
                           q: [len(v), round(1e3 * float(np.median(v)), 3),
                               round(1e3 * max(v), 3)]
                           for q, v in sorted(run.by_query.items())}}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in limits.items()}
    return result


def summary_lines(result: dict) -> List[str]:
    return [f"{k} {c['value']} limit {c['limit']}" for k, c in result["checks"].items()]
