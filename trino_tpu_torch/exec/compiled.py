"""Whole-query compilation for the port: stage the scans once, capture the
query body into one CUDA graph, replay it.

The port of trino_tpu/exec/compiled.py. The reference traces the executor
once under ``jax.jit`` over pre-staged scan pages and reruns the compiled
executable. Here the same body (``PreloadedExecutor``: the executor with
``eager_tier`` off, reading the staged pages) runs once eagerly on a side
stream (PyTorch's warm-up before a capture; it also builds the merge
kernel's library and fills the query's ``ConstantStore`` with every
host-computed constant the body uploads), is then captured into a
``torch.cuda.CUDAGraph``, and every run replays the graph: one launch of
the whole query from the host. The staged tensors are the graph's inputs at
fixed addresses; its outputs are the flat output page and one vector of
the deferred error flags, read to the host in one read.

Two-phase dynamic filtering (reference: DynamicFilterService +
AdaptivePlanner): phase 1 host-evaluates the dynamic-filter build sides
(exec/host_eval.py); strong domains prune rows on the host before the
transfer, the others are applied inside the body (``_traced_domain_mask``)
and the filtered scan compacts to a ``dfc:`` capacity. Capacities come from
the staged row counts and ``estimate_capacity_hints`` (or, under
``adaptive_capacity_reseed``, from the staged keys, adaptive/reseed.py); a
run whose capacity flag fires doubles that hint and captures again
(``recompiles``).

Each run feeds the device profiler (obs/devprofiler.py): a compile event
(a run that captured is a ``miss``, a replay a ``hit``) and the query's
``CompiledBody`` kernel row, written after the replay; with
``device_profiling`` the body's device seconds come from CUDA events
around the replay.

On the CPU, which only the tests ask for, nothing is captured: ``run``
executes the same body eagerly each time. On CUDA a failed capture raises;
it never falls back to eager execution. ``random()`` is refused here: the
JAX package's compiled program repeats its draws on every run, and a graph
replay would repeat or advance them only by design, so neither answer is
given.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from trino_tpu_torch.data.page import ConstantStore, Page, constant_store
from trino_tpu_torch.exec.executor import Executor, QueryError, fired_flags, raise_fired
from trino_tpu_torch.exec.page_tree import PageSpec, flatten_page, unflatten_page
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER
from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.planner import plan as P

# strong domains (|set|/NDV at or below this) prune rows on the host at
# staging, which cuts the host-to-device transfer; weaker domains are
# enforced inside the body
HOST_APPLY_MAX_SEL = 0.25
# widest probe-column value span for an in-body boolean table (bytes on the
# device = span); wider spans degrade to min/max range narrowing
LUT_MAX_SPAN = 1 << 28


class PreloadedExecutor(Executor):
    """The compiled body: table scans read the staged pages instead of the
    connector, and dynamic filtering happens inside the body. When a join
    has run its build side, the build keys stay device tensors
    (``traced_domains``); probe scans later in the same body mask against
    them (a boolean table over the probe column's static value range, or a
    min/max range) and compact to a stats-sized capacity. No host read of
    the device happens anywhere in the body."""

    eager_tier = False
    collect_stats = False

    def __init__(self, session, staged: Dict[int, Page], capacity_hints=None,
                 device_df=None):
        super().__init__(session, capacity_hints=capacity_hints)
        self.staged = staged
        # scan node id -> [(channel, join_id, key_idx, spec)]; spec is
        # ("lut", lo, span) with static bounds from the probe column's
        # vrange, or ("range",) for min/max narrowing
        self.device_df = device_df or {}
        # (join_id, key_idx) -> (build key values, live mask), registered
        # by _collect_dynamic_filters, consumed by probe scans
        self.traced_domains: Dict[Tuple[int, int], tuple] = {}

    def _lower(self, e: ir.Expr, page: Page):
        if any(isinstance(x, ir.Call) and x.name == "random" for x in ir.walk(e)):
            raise NotImplementedError("random() in the compiled tier")
        return super()._lower(e, page)

    def _collect_dynamic_filters(self, node: P.JoinNode, build: Page) -> None:
        """Remember the build-side key column and its liveness; no host
        read."""
        for i in node.dyn_filter_keys:
            col = build.columns[node.right_keys[i]]
            if col.type.is_varchar or col.hi is not None:
                continue  # dictionary codes are page-local; two-limb keys
            live = (build.sel if build.sel is not None else torch.ones(
                (build.num_rows,), dtype=torch.bool, device=col.values.device))
            if col.nulls is not None:
                live = live & ~col.nulls
            self.traced_domains[(node.id, i)] = (col.values, live)

    def _exec_TableScanNode(self, node: P.TableScanNode) -> Page:
        page = self.staged[node.id]
        entries = self.device_df.get(node.id)
        if not entries:
            return page
        sel = page.sel if page.sel is not None else torch.ones(
            (page.num_rows,), dtype=torch.bool, device=self.device)
        applied = False
        for ch, join_id, key_idx, spec in entries:
            dom = self.traced_domains.get((join_id, key_idx))
            if dom is None:
                continue  # the build side could not register this key
            col = page.columns[ch]
            m = _traced_domain_mask(col.values, dom, spec)
            if col.nulls is not None:
                m = m & ~col.nulls
            sel = sel & m
            applied = True
        if not applied:
            return page
        page = Page(list(page.columns), sel)
        cap = self.capacity_hints.get(f"dfc:{node.id}")
        if cap is not None:
            page = self.compact_to(page, cap, f"dfc:{node.id}")
        return page


def _traced_domain_mask(values: torch.Tensor, dom, spec) -> torch.Tensor:
    """Membership of probe ``values`` in a build-side key set held on the
    device. The table path is the semi join's dense membership (one
    scatter, one bounded gather); the range path masked min/max reductions,
    where a build with no live key admits nothing."""
    from trino_tpu_torch.ops import join as join_ops

    bvals, blive = dom
    if spec[0] == "lut":
        _, lo, span = spec
        lut = join_ops.dense_membership_table((bvals, None), blive, lo, span)
        return join_ops.dense_membership_probe(lut, (values, None), lo)
    if bvals.numel() == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    bv = bvals.to(torch.int64)
    big = 1 << 62
    lo = torch.where(blive, bv, torch.full_like(bv, big)).min()
    hi = torch.where(blive, bv, torch.full_like(bv, -big)).max()
    v = values.to(torch.int64)
    return (v >= lo) & (v <= hi)


@dataclasses.dataclass
class CompiledQuery:
    session: object
    root: P.OutputNode
    input_arrays: List[torch.Tensor]
    input_specs: Dict[int, PageSpec]
    capacity_hints: Dict[str, int] = dataclasses.field(default_factory=dict)
    # two-phase profile: host phase-1 wall (exec/host_eval.py), host
    # domain-application seconds at the scans, staged rows per scan
    phase1_s: float = 0.0
    df_apply_s: float = 0.0
    scan_rows: Dict[int, int] = dataclasses.field(default_factory=dict)
    # staging profile: wall of the staging loop, scans the device cache
    # served, rows that crossed host-to-device (0 on a fully warm build)
    staging_s: float = 0.0
    cache_hits: int = 0
    fresh_staged_rows: int = 0
    # capacity overflows that grew a hint and captured again
    recompiles: int = 0
    # one record per capture on CUDA: warm-up and capture seconds, the
    # graph pool's bytes (device memory reserved by the capture), the
    # merge-kernel launches the graph holds and its replays
    captures: List[dict] = dataclasses.field(default_factory=list)
    # kernel ledger (obs/devprofiler.py): one "CompiledBody" row over this
    # query's runs of the body
    kernel_stats: Dict[tuple, dict] = dataclasses.field(default_factory=dict)
    # the compile ledger's identity, computed once on the first run, and
    # the inputs' shape signature, once a capture
    _fingerprint: str = ""
    _shape_sig: str = ""

    MAX_RECOMPILES = 16  # doubling buckets: 2^16x headroom over the estimate

    @classmethod
    def build(cls, session, root: P.OutputNode,
              capacity_hints: Optional[Dict[str, int]] = None) -> "CompiledQuery":
        """Phase 1 host-evaluates the dynamic-filter build sides and narrows
        the probe scans before staging; the staged row counts then size
        the capacities. The body is captured on the first ``run()``."""
        from trino_tpu_torch.adaptive.reseed import apply_reseed, reseed_enabled
        from trino_tpu_torch.exec import host_eval
        from trino_tpu_torch.sql.planner import stats

        t0 = time.perf_counter()
        with tracing.span("staging/dynamic-filters"):
            dyn = host_eval.resolve_dynamic_filters(session, root)
        phase1_s = time.perf_counter() - t0
        scans = [n for n in P.walk_plan(root) if isinstance(n, P.TableScanNode)]

        def _dom_sel(node, col_name, dom):
            """|domain| / column NDV: the narrowing strength estimate."""
            if dom.values is None:
                return 1.0
            cs = session.catalogs[node.catalog].column_stats(node.schema, node.table, col_name)
            if cs is not None and cs.ndv:
                return min(1.0, len(dom.values) / cs.ndv)
            return 1.0

        def host_allow(node, col_name, dom):
            return dom.values is not None and \
                _dom_sel(node, col_name, dom) <= HOST_APPLY_MAX_SEL

        # stages the scans: constraint pushdown with the resolved domains,
        # host row pruning by the strong domains only
        base = Executor(session)
        base.df_host_allow = host_allow
        base.dyn_domains.update(dyn)
        with tracing.span("device/staging") as stage_sp:
            t_stage = time.perf_counter()
            staged_pages = {n.id: base._exec_TableScanNode(n) for n in scans}
            staging_s = time.perf_counter() - t_stage
            # a device-cache hit staged zero host-to-device bytes
            cache_hits = sum(1 for n in scans if base.scan_cache.get(n.id) == "hit")
            fresh_staged = sum(base.scan_stats.get(n.id, staged_pages[n.id].num_rows)
                               for n in scans if base.scan_cache.get(n.id) != "hit")
            total_staged = sum(base.scan_stats.get(n.id, staged_pages[n.id].num_rows)
                               for n in scans)
            stage_sp.set("staged_rows", int(fresh_staged))
            stage_sp.set("cached_rows", int(total_staged - fresh_staged))
            stage_sp.set("cache_hits", cache_hits)
            stage_sp.set("scans", len(scans))
        # the scans charged their own loads (staged rows and seconds)
        M.STAGING_SECONDS.inc(phase1_s)
        # in-body dynamic-filter specs and stats-sized compaction per scan:
        # every annotated (join, key) not already pruned on the host is
        # applied on the device; the host domains only size capacities
        df_hints: Dict[str, int] = {}
        device_df: Dict[int, List] = {}
        joins_by_id = {n.id: n for n in P.walk_plan(root) if isinstance(n, P.JoinNode)}
        for n in scans:
            staged_rows = base.scan_stats.get(n.id, staged_pages[n.id].num_rows)
            if not n.dynamic_filters:
                n.runtime_rows = staged_rows
                continue
            page = staged_pages[n.id]
            sel_frac = 1.0
            entries: List = []
            for join_id, key_idx, col_name in n.dynamic_filters:
                ch = n.column_names.index(col_name)
                col = page.columns[ch]
                join = joins_by_id.get(join_id)
                if col.type.is_varchar or col.hi is not None or join is None:
                    continue
                if join.right.output_types[join.right_keys[key_idx]].is_varchar:
                    continue  # the build side cannot register this key
                dom_known = dyn.get((join_id, key_idx))
                if dom_known is not None and host_allow(n, col_name, dom_known):
                    continue  # applied at staging: the mask would be all true
                vr = col.vrange
                lut = vr is not None and (vr[1] - vr[0] + 1) <= LUT_MAX_SPAN
                if lut:
                    entries.append((ch, join_id, key_idx,
                                    ("lut", int(vr[0]), int(vr[1] - vr[0] + 1))))
                else:
                    entries.append((ch, join_id, key_idx, ("range",)))
                if dom_known is not None and lut:
                    # only a domain the device enforces exactly (the table)
                    # discounts the estimate
                    sel_frac *= _dom_sel(n, col_name, dom_known)
            if not entries:
                n.runtime_rows = staged_rows
                continue
            device_df[n.id] = entries
            est = max(int(staged_rows * sel_frac), 1)
            n.runtime_rows = est
            cap = 1 << max(int(est * 1.3), 1024).bit_length()
            if cap < staged_rows:
                df_hints[f"dfc:{n.id}"] = cap
        if capacity_hints is None:
            capacity_hints = stats.estimate_capacity_hints(session, root)
        if reseed_enabled(session):
            # the staged pages are the actual upstream rows: price the
            # expansion capacities from their key histograms
            apply_reseed(session, root, staged_pages, 1, capacity_hints)
        capacity_hints.update(df_hints)
        flat_inputs: List[torch.Tensor] = []
        specs: Dict[int, PageSpec] = {}
        layout: List[Tuple[int, int]] = []  # (node_id, number of tensors)
        for nid, page in staged_pages.items():
            arrays, spec = flatten_page(page)
            specs[nid] = spec
            layout.append((nid, len(arrays)))
            flat_inputs.extend(arrays)
        cq = cls(session, root, flat_inputs, specs, dict(capacity_hints))
        cq.phase1_s = phase1_s
        cq.df_apply_s = base.df_apply_s
        cq.scan_rows = dict(base.scan_stats)
        cq.staging_s = staging_s
        cq.cache_hits = cache_hits
        cq.fresh_staged_rows = int(fresh_staged)
        cq._layout = layout
        cq._device_df = device_df
        cq._reset()
        return cq

    # ------------------------------------------------------------ body
    def _reset(self) -> None:
        """Drop the captured graph (if any): the next run captures anew."""
        graph = getattr(self, "_graph", None)
        if graph is not None:
            # work still queued may read the graph's pool or the constants
            torch.cuda.synchronize(self.session.device)
            graph.reset()
        self._graph = None
        self._outputs: Optional[List[torch.Tensor]] = None
        self._fired: Optional[torch.Tensor] = None
        self._out_spec: Optional[PageSpec] = None
        self._codes: List[str] = []
        self._store = ConstantStore()
        self._fresh = True

    def _execute_body(self, count_tiers: bool):
        """One execution of the query body over the staged inputs:
        (flat outputs, output spec, error codes, error flags)."""
        pages: Dict[int, Page] = {}
        i = 0
        for nid, count in self._layout:
            pages[nid] = unflatten_page(self.input_specs[nid], self.input_arrays[i:i + count])
            i += count
        ex = PreloadedExecutor(self.session, pages, dict(self.capacity_hints), self._device_df)
        ex.count_tiers = count_tiers
        with constant_store(self._store):
            out_page = ex.execute(self.root)
        out_arrays, out_spec = flatten_page(out_page)
        return out_arrays, out_spec, [c for c, _ in ex.errors], [f for _, f in ex.errors]

    def _capture(self) -> None:
        """Warm up on a side stream, then capture the body into one CUDA
        graph whose outputs are the flat output page and the vector of
        fired error flags."""
        from trino_tpu_torch.ops import merge

        device = self.session.device
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        t0 = time.perf_counter()
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            # a host synchronisation in the body raises here, with its stack
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._execute_body(count_tiers=True)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(side)
        torch.cuda.synchronize(device)
        warmup_s = time.perf_counter() - t0
        self._store.frozen = True
        graph = torch.cuda.CUDAGraph()
        captured0 = merge.captured
        # the capture empties the allocator's cache first: do it here, so
        # the growth in reserved bytes is the graph's private pool
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(device)
        t1 = time.perf_counter()
        with torch.cuda.graph(graph):
            out_arrays, out_spec, codes, flags = self._execute_body(count_tiers=False)
            fired = torch.stack([f.reshape(-1).any() for f in flags]) if flags else None
        torch.cuda.synchronize(device)
        capture_s = time.perf_counter() - t1
        self._graph, self._outputs, self._fired = graph, out_arrays, fired
        self._out_spec, self._codes = out_spec, codes
        # one record per capture; ``replays`` counts the graph's replays, so
        # the merge kernel ran merge_launches * (1 + replays) times for it
        # (the warm-up's launches are the wrapper's own count)
        self.captures.append({
            "warmup_s": warmup_s, "capture_s": capture_s,
            "pool_bytes": torch.cuda.memory_reserved(device) - reserved0,
            "merge_launches": merge.captured - captured0, "replays": 0,
            "constants": len(self._store)})

    def _run_once(self, events=None):
        """(flat outputs, output spec, codes, fired flags as host bools).
        ``events``: a pair of CUDA events recorded around the replay. The
        ``device/replay`` span enqueues the graph (on the CPU: runs the
        body); ``device/flag-read`` waits for it, and on a replay its
        seconds go to ``trino_tpu_replay_wait_seconds_total``."""
        wait = None if self._fresh else M.REPLAY_WAIT_SECONDS
        if self.session.device.type != "cuda":
            with tracing.timed("device/replay", detail=True):
                out_arrays, out_spec, codes, flags = self._execute_body(count_tiers=self._fresh)
            with tracing.timed("device/flag-read", wait, detail=True):
                return out_arrays, out_spec, codes, fired_flags(flags)
        if self._graph is None:
            self._capture()
        with tracing.timed("device/replay", detail=True):
            if events is not None:
                events[0].record()
            self._graph.replay()
            if events is not None:
                events[1].record()
        self.captures[-1]["replays"] += 1
        with tracing.timed("device/flag-read", wait, detail=True):
            fired = self._fired.tolist() if self._fired is not None else []  # one read
        return self._outputs, self._out_spec, self._codes, fired

    def _profile_run(self, fresh: bool, dispatch_wall_s: float, body_device_s: float,
                     estimated: bool) -> None:
        """Feed the device profiler after a run: one compile-ledger event (a
        miss on a run that captured, a hit on a replay) and the
        ``CompiledBody`` kernel row. A capturing run's wall goes to the
        compile ledger, not to the row, so the row's dispatch overhead
        stays a steady-state signal."""
        from trino_tpu_torch.cache.plan_key import plan_fingerprint
        from trino_tpu_torch.obs.devprofiler import shape_signature

        if not self._fingerprint:
            self._fingerprint = plan_fingerprint(self.root)
        if fresh:
            # the inputs are fixed between captures: sign them once a capture
            self._shape_sig = shape_signature(self.input_arrays)
        DEVICE_PROFILER.record_compile(
            "compiled", self._fingerprint, self._shape_sig,
            dispatch_wall_s if fresh else 0.0, "miss" if fresh else "hit", started=fresh)
        wall = body_device_s if fresh else dispatch_wall_s + (0.0 if estimated else body_device_s)
        key = (str(self.root.id), "CompiledBody", "compiled")
        ks = self.kernel_stats.get(key)
        if ks is None:
            ks = self.kernel_stats[key] = {
                "planNodeId": key[0], "operator": key[1], "tier": "compiled", "launches": 0,
                "wallS": 0.0, "deviceS": 0.0, "inputBytes": 0, "outputBytes": 0,
                "estimated": estimated}
        ks["launches"] += 1
        ks["wallS"] += wall
        ks["deviceS"] += body_device_s
        ks["estimated"] = bool(ks["estimated"] or estimated)
        DEVICE_PROFILER.count_launch(wall, 0.0 if estimated else body_device_s)

    def run(self) -> Page:
        """Replay the captured body (capturing it first when needed); on a
        capacity overflow, double the offending hint and capture again.

        A replay is the ``device/execute`` span, whose seconds go to
        ``trino_tpu_compiled_run_seconds_total``; its children are
        ``device/replay`` and ``device/flag-read`` (``_run_once``),
        ``device/ledger`` (the device profiler's rows, the hint and flag
        checks) and ``device/outputs`` (the outputs' clone into a page). A
        run that captures is ``device/compile`` around ``_run_once`` alone,
        and its ledger and outputs follow it."""
        from trino_tpu_torch.sql.planner import stats

        props = getattr(self.session, "properties", None) or {}
        profiling = bool(props.get("device_profiling", False))
        for _ in range(self.MAX_RECOMPILES):
            fresh = self._fresh
            events = None
            if profiling and self.session.device.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            if fresh:
                DEVICE_PROFILER.compile_started()
            with contextlib.ExitStack() as run_span:
                sp = run_span.enter_context(tracing.timed(
                    "device/compile" if fresh else "device/execute",
                    None if fresh else M.COMPILED_RUN_SECONDS))
                t0 = time.perf_counter()
                out_arrays, out_spec, codes, fired = self._run_once(events)
                device_s = time.perf_counter() - t0
                sp.set("device_seconds", round(device_s, 6))
                sp.set("staged_rows", int(sum(self.scan_rows.values())))
                if fresh:
                    run_span.close()  # device/compile: the capturing run alone
                with tracing.timed("device/ledger", detail=True):
                    # the body's device seconds: with device_profiling, the
                    # CUDA events around the replay (the flag read above
                    # waited for it), or on the CPU the body's own wall (it
                    # ran synchronously); otherwise estimated from the
                    # wall, 0 on a capturing run
                    if events is not None:
                        events[1].synchronize()
                        body_device_s = events[0].elapsed_time(events[1]) / 1e3
                        estimated = False
                    elif profiling:
                        body_device_s, estimated = device_s, False
                    else:
                        body_device_s, estimated = (0.0 if fresh else device_s), True
                    self._profile_run(fresh, device_s, body_device_s, estimated)
                    self._fresh = False
                    (M.COMPILE_CACHE_MISSES if fresh else M.COMPILE_CACHE_HITS).inc()
                    (M.COMPILE_SECONDS if fresh else M.DEVICE_SECONDS).inc(device_s)
                    # capacity overflows first: another flag of the same run
                    # may be an artifact of the truncated output
                    grown = stats.grow_overflowed_hints(self.capacity_hints, codes, fired)
                    if grown is None:
                        raise_fired(codes, fired)
                if grown is None:
                    # the graph's outputs are overwritten by the next replay
                    with tracing.timed("device/outputs", detail=True):
                        return unflatten_page(out_spec, [t.clone() for t in out_arrays])
            self.capacity_hints = grown
            self.recompiles += 1
            self._reset()
        raise QueryError("capacity still exceeded after recompiles (join or exchange bucket)")

    def close(self) -> None:
        """Release the captured graph and its memory pool."""
        self._reset()
