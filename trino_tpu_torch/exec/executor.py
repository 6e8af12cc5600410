"""Eager plan executor over device Pages: the port of
trino_tpu/exec/executor.py for the local path.

Each plan node is a whole-column tensor transformation on the session's
device: filters keep selection masks instead of compacting, aggregations
emit padded outputs with a live-group prefix, sorts move dead rows last.
Ported nodes: TableScan (adaptive splits staged in parallel through the
host-RAM tier and double-buffered copies, exec/staging.py, behind the
opt-in device table cache, devcache/), Values, Filter, Compact, Project,
Aggregation (single step: count, sum, avg, min, max, the variance family,
bool_and/bool_or, count_if, arbitrary, geometric_mean, checksum,
min_by/max_by, corr/covar/regr, approx_distinct and approx_percentile;
DISTINCT for count and approx_distinct; array_agg, histogram and map_agg),
Window (ops/window.py), UNION ALL and INTERSECT/EXCEPT DISTINCT, Unnest
(single, zipped, WITH ORDINALITY, maps), MatchRecognize (the host matcher
of exec/match_recognize.py), Join (N:1 lookup and
semi/anti through the dense / fused / merge tier gate, where a bare
cached scan's sorted build goes to the merge tier; M:N inner and left
expansion, semi/anti with a residual filter, the singleton cross join of a
scalar subquery and the true cross join), Sort, TopN, Limit and Output.
Nested (array, map, row) columns pass through every operator but as join
payloads, where both packages refuse them; a page holding one is sorted on
the host and keeps its selection mask where others compact.
An expansion's output is sized by one host read of its exact total. A
per-query MemoryContext (exec/memory.py) observes every node's output
bytes; over the ``query_max_device_memory`` budget, joins and grouped
aggregations hash-partition their inputs on the host and run in passes.

The compiled tier (exec/compiled.py) runs this executor with
``eager_tier`` off, as the body of a captured CUDA graph: no host read of
the device and no upload of host data once its constants are in the
query's store. There every expansion and compaction takes its capacity
from a hint and raises a deferred CAPACITY_EXCEEDED flag when it
overflows; nothing spills; no sorted build comes from the device cache;
MATCH_RECOGNIZE and the ORDER BY of a page holding nested columns, both
host steps, are refused.

Data-dependent runtime errors (division by zero, decimal overflow, an
invalid function argument, capacity overflow, a scalar subquery without
exactly one row) are collected as boolean flags and checked once after
execution.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.page import (Column, Page, column_data_from_python, column_to_device,
                                      host_take, numpy_dtype, to_device, to_numpy,
                                      torch_dtype)
from trino_tpu_torch.exec import memory as _mem
from trino_tpu_torch.exec.operator_stats import OperatorStats
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER
from trino_tpu_torch.ops import aggregate as agg_ops
from trino_tpu_torch.ops import expr_lower as L
from trino_tpu_torch.ops import fused_join as fused_ops
from trino_tpu_torch.ops import groupby as gb
from trino_tpu_torch.ops import hll
from trino_tpu_torch.ops import join as join_ops
from trino_tpu_torch.ops import ranks as ranks_ops
from trino_tpu_torch.ops import segments as seg
from trino_tpu_torch.ops import sort as sort_ops
from trino_tpu_torch.ops import window as win_ops
from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.planner import plan as P

_SIGN64 = -(2**63)
_CHECKSUM_NULL = -7046029254386353131  # the hash a NULL adds to checksum()
# aggregates and window functions whose result is one of the argument's
# values, so the result keeps the argument's dictionary
_VALUE_AGGREGATES = ("min", "max", "arbitrary", "any_value", "min_by", "max_by")
_VALUE_WINDOW_FUNCTIONS = ("min", "max", "lag", "lead", "first_value", "last_value",
                           "nth_value")
_BIVARIATE = ("corr", "covar_samp", "covar_pop", "regr_slope", "regr_intercept")
_NESTED_AGGREGATES = ("array_agg", "histogram", "map_agg")


class QueryError(RuntimeError):
    def __init__(self, message: str, code: str = ""):
        super().__init__(message)
        self.code = code


def fired_flags(flags) -> List[bool]:
    """Whether each deferred error flag fired: one device-to-host read."""
    if not flags:
        return []
    return torch.stack([f.reshape(-1).any() for f in flags]).tolist()


def raise_fired(codes, fired) -> None:
    """Raise the first deferred runtime error whose flag fired."""
    for code, hit in zip(codes, fired):
        if hit:
            raise QueryError(code.replace("_", " ").capitalize(), code=code)


def raise_query_errors(codes, flags):
    """Raise the first deferred runtime error whose flag fired; every flag
    is read in one device-to-host read."""
    raise_fired(codes, fired_flags(flags))


def _col_from_lowered(t: T.Type, lv: L.LoweredVal) -> Column:
    nulls = None if lv.valid is None else ~lv.valid
    if lv.children is not None:
        return Column(t, lv.vals, nulls, children=[
            _col_from_lowered(ct, k) for ct, k in zip(T.type_children(t), lv.children)])
    # a static |value| bound proven by the lowering becomes the vrange
    vrange = (-lv.bound, lv.bound) if lv.bound is not None and lv.hi is None else None
    return Column(t, lv.vals, nulls, lv.dictionary, vrange, hi=lv.hi)


def _col_to_lowered(c: Column) -> join_ops.Lowered:
    return (c.values, None if c.nulls is None else ~c.nulls)


def _key_lowereds(c: Column, force_two_limb: bool = False) -> List[join_ops.Lowered]:
    """Key operands for grouping/joining/sorting one column. Two-limb long
    decimals contribute (hi, lo-with-flipped-sign-bit): the flip makes the
    unsigned low word order correctly as a signed int64."""
    if c.hi is None and not force_two_limb:
        return [_col_to_lowered(c)]
    valid = None if c.nulls is None else ~c.nulls
    lo = c.values.to(torch.int64)
    hi = c.hi if c.hi is not None else (lo >> 63)
    return [(hi, valid), (lo ^ _SIGN64, valid)]


def _flat_arrays(cols: List[Column]) -> List[torch.Tensor]:
    """Every array of ``cols`` (values, then nulls and hi where present),
    to ride one permutation or gather together."""
    out = []
    for c in cols:
        out.append(c.values)
        if c.nulls is not None:
            out.append(c.nulls)
        if c.hi is not None:
            out.append(c.hi)
    return out


def _cols_from_flat(cols: List[Column], arrays: List[torch.Tensor]) -> List[Column]:
    """``cols`` rebuilt from their ``_flat_arrays`` after a permutation."""
    out = []
    it = iter(arrays)
    for c in cols:
        v = next(it)
        nulls = next(it) if c.nulls is not None else None
        hi = next(it) if c.hi is not None else None
        out.append(Column(c.type, v, nulls, c.dictionary,
                          c.vrange if hi is None else None, hi=hi))
    return out


def scan_constraint_with(node: P.TableScanNode, dyn_domains):
    """Effective TupleDomain for a scan: static pushdown ∩ available
    dynamic-filter domains."""
    from trino_tpu_torch.connector.predicate import TupleDomain

    td = node.constraint
    for join_id, key_idx, column in node.dynamic_filters or ():
        dom = dyn_domains.get((join_id, key_idx))
        if dom is None:
            continue
        extra = TupleDomain({column: dom})
        td = extra if td is None else td.intersect(extra)
    return td


def dynamic_domain_map(node, dyn_domains):
    """column -> available dynamic-filter Domain for a scan."""
    dyn = {}
    for join_id, key_idx, column in node.dynamic_filters or ():
        dom = dyn_domains.get((join_id, key_idx))
        if dom is None or dom.is_all():
            continue
        dyn[column] = dom.intersect(dyn[column]) if column in dyn else dom
    return dyn


def apply_dynamic_domains(node, dyn_domains, datas, allow=None):
    """Drop scanned host rows outside the scan's dynamic-filter domains
    before the device transfer (connectors treat constraints as advisory).
    Varchar domains are skipped: dictionary codes are page-local.
    ``allow(node, column, domain)`` restricts which domains apply here (the
    compiled tier prunes strong domains on the host and enforces the weak
    ones on the device)."""
    from trino_tpu_torch.connector.spi import column_data_take
    from trino_tpu_torch.exec.host_eval import domain_mask

    dyn = dynamic_domain_map(node, dyn_domains)
    if allow is not None:
        dyn = {c: d for c, d in dyn.items() if allow(node, c, d)}
    if not dyn:
        return datas
    out = []
    for d in datas:
        if not d:
            out.append(d)
            continue
        n = len(next(iter(d.values())).values)
        keep = np.ones(n, dtype=bool)
        for column, dom in dyn.items():
            cd = d.get(column)
            if cd is None or cd.dictionary is not None:
                continue
            keep &= domain_mask(
                dom, np.asarray(cd.values),
                np.asarray(cd.nulls) if cd.nulls is not None else None)
        if keep.all():
            out.append(d)
            continue
        out.append({name: column_data_take(cd, keep) for name, cd in d.items()})
    return out


def _int64_bits(x: torch.Tensor) -> torch.Tensor:
    """A 0-d integer or float tensor carried exactly in an int64."""
    if x.is_floating_point():
        return x.to(torch.float64).view(torch.int64)
    return x.to(torch.int64)


def _from_int64_bits(bits: int, dtype: np.dtype):
    """The Python scalar ``_int64_bits`` carried, as ``.item()`` of a numpy
    scalar of ``dtype`` gives it."""
    a = np.array(bits, dtype=np.int64)
    if dtype.kind == "f":
        a = a.view(np.float64)
    return a.astype(dtype).item()


def reduced_key_domains(build: Page, cols: List[Column], max_set: int):
    """The key columns' domains reduced on the device: each key's live
    count, min and max (masked by a sentinel, NaN propagating as in numpy),
    read for all keys at once. A key of no live row is provably empty; one
    of at most ``max_set`` live rows (duplicates counted) copies those rows
    alone for the set of its distinct values; a larger one is the [min, max]
    range. [(Domain, kind)], the bytes copied and the number of keys whose
    rows were copied."""
    from trino_tpu_torch.connector.predicate import Domain

    if not cols or build.num_rows == 0:
        return [(Domain(values=frozenset()), "empty")] * len(cols), 0, 0
    lives, parts = [], []
    for col in cols:
        v = col.values.view(torch.uint8) if col.values.dtype == torch.bool else col.values
        live = build.sel
        if col.nulls is not None:
            live = ~col.nulls if live is None else live & ~col.nulls
        lives.append(live)
        if live is None:
            count, lo, hi = v.new_full((), len(v), dtype=torch.int64), v.amin(), v.amax()
        else:
            if v.is_floating_point():
                top, bottom = float("inf"), float("-inf")
            else:
                top, bottom = torch.iinfo(v.dtype).max, torch.iinfo(v.dtype).min
            count = live.sum()
            lo = torch.where(live, v, top).amin()
            hi = torch.where(live, v, bottom).amax()
        parts.append(torch.stack([count, _int64_bits(lo), _int64_bits(hi)]))
    scalars = torch.stack(parts)
    nbytes = scalars.numel() * scalars.element_size()
    out, copied = [], 0
    for col, live, (count, lo, hi) in zip(cols, lives, scalars.tolist()):
        if count == 0:
            out.append((Domain(values=frozenset()), "empty"))  # provably empty probe
        elif count <= max_set:
            lv = to_numpy(col.values if live is None else col.values[live])
            nbytes += lv.nbytes
            copied += 1
            out.append((Domain.from_values(np.unique(lv).tolist()), "set"))
        else:
            dtype = numpy_dtype(col.values.dtype)
            out.append((Domain.range(low=_from_int64_bits(lo, dtype),
                                     high=_from_int64_bits(hi, dtype)), "range"))
    return out, nbytes, copied


class Executor:
    """Eager plan interpreter on ``session.device``; ``execute_checked``
    runs the plan and raises deferred errors.

    Every eager execution keeps the kernel ledger (``kernel_stats``, the
    reference's row shape, obs/devprofiler.py): launches, exclusive host
    wall and bytes a plan node, with device seconds estimated as the wall
    (``estimated``) unless ``device_profiling`` synchronizes after each
    node. None of it reads the device. ``collect_stats`` (on, as in the
    reference; the compiled tier turns it off) adds the per-operator stats
    EXPLAIN ANALYZE prints and the tasks report (``node_stats``). The
    reference's per-node live count is a device-to-host read and sync per
    plan node. Here each node's live count stays a device scalar, and
    ``execute_checked`` reads them all in one batch when the plan has run.

    The class flags mark the tier. The eager tier reads the device where
    the host must decide (an expansion's exact total, dynamic-filter
    domains, spill partitions); the compiled tier's subclasses
    (exec/compiled.py) turn ``eager_tier`` off. A scan prunes its host rows
    by the dynamic domains before the transfer, limited to those
    ``df_host_allow(node, column, domain)`` accepts where it is set.
    ``count_tiers`` off keeps a repeated execution of one body from
    counting its join-tier selections again."""

    DYNAMIC_FILTER_MAX_SET = 1024  # in-set domain cap
    eager_tier = True
    collect_stats = True
    df_host_allow = None
    count_tiers = True

    def __init__(self, session, collect_stats: Optional[bool] = None,
                 capacity_hints: Optional[Dict[str, int]] = None):
        self.session = session
        self.props = getattr(session, "properties", None) or {}
        # device_profiling: a torch.cuda.synchronize() after each node, so
        # its device seconds are measured and not estimated from its wall
        # (the eager tier only: a compiled body is never synchronized)
        self.profile_sync = self.eager_tier and bool(self.props.get("device_profiling", False))
        if collect_stats is not None:
            self.collect_stats = collect_stats
        self.device = session.device
        self.errors: List[Tuple[str, torch.Tensor]] = []
        # static output capacities by hint key ("cmp:<id>" for Compact,
        # "join:<id>" for an expansion, "dfc:<id>" for a filtered scan)
        self.capacity_hints: Dict[str, int] = (
            capacity_hints if capacity_hints is not None else {})
        # build-side key domains by (join_id, key_index), consumed by probe
        # scans annotated by the optimizer
        self.dyn_domains: Dict[Tuple[int, int], object] = {}
        self.enable_dynamic_filtering = bool(
            self.props.get("dynamic_filtering_enabled", True))
        # per scan node: the device-cache disposition (hit | miss | bypass)
        # and the rows its page holds
        self.scan_cache: Dict[int, str] = {}
        self.scan_stats: Dict[int, int] = {}
        # device-memory budget, peak and spill decisions (exec/memory.py)
        self.memory = _mem.MemoryContext(self.props.get("query_max_device_memory"))
        self.spill_enabled = bool(self.props.get("spill_enabled", True))
        # host seconds spent applying dynamic domains at scans
        self.df_apply_s = 0.0
        # per-operator stats by plan-node id (collect_stats), accumulated
        # across repeated executions of a node
        self.node_stats: Dict[int, OperatorStats] = {}
        # per-(node, operator) kernel ledger: launches, wall and device
        # seconds, input and output bytes (EXPLAIN ANALYZE VERBOSE's
        # launches= and dispatch_overhead=; the task's kernelStats)
        self.kernel_stats: Dict[Tuple[int, str], dict] = {}
        # live rows a node produced on its latest execution (an int, or a
        # device scalar until read): parents charge them as their input
        self._last_output_rows: Dict[int, object] = {}
        # (stats, field, live rows) still to add once the device scalars
        # are read, in one batch (resolve_stats)
        self._row_terms: List[Tuple[OperatorStats, str, object]] = []
        # stack of accumulated child wall time: a node's wall is exclusive
        # of the subtree it executes inside its method
        self._child_wall: List[float] = [0.0]
        # (splits, scanned rows) of the scan that just ran, for its stats
        self._pending_scan: Dict[int, Tuple[int, int]] = {}
        # output bytes of each node's latest execution: parents charge them
        # as their kernel rows' input bytes
        self._last_output_bytes: Dict[int, int] = {}

    # ------------------------------------------------------------------ api
    def execute_checked(self, node: P.PlanNode) -> Page:
        """Run the plan, raise its deferred errors and read its stats: the
        ``exec/run`` span, whose seconds go to
        ``trino_tpu_executor_seconds_total``."""
        with tracing.timed("exec/run", M.EXECUTOR_SECONDS, detail=True):
            page = self.execute(node)
            self.raise_errors()
            if self.collect_stats:
                self.resolve_stats()
        return page

    def raise_errors(self):
        raise_query_errors([c for c, _ in self.errors], [f for _, f in self.errors])

    def execute(self, node: P.PlanNode) -> Page:
        method = getattr(self, f"_exec_{type(node).__name__}", None)
        if method is None:
            raise NotImplementedError(f"executor: {type(node).__name__} is not ported")
        if not self.eager_tier:
            # a compiled body runs once and is replayed whole: its ledger
            # row is the CompiledQuery's (exec/compiled.py)
            page = method(node)
            # each operator's output rolls into the query's peak (exact bytes)
            self.memory.observe(_mem.page_bytes(page))
            return page
        operator = type(node).__name__.replace("Node", "")
        self._child_wall.append(0.0)
        # under a tracer that keeps detail, the node's inclusive wall is its
        # exec/<operator> span, from the same clock reads
        cur = tracing.current(detail=True)
        t0 = time.perf_counter()
        if cur is not None:
            span, token = tracing.open_span(cur, f"exec/{operator}", t0, node=node.id)
        try:
            page = method(node)
        finally:
            # keep the stack balanced on error paths: the parent is still
            # charged the subtree's time
            wall = time.perf_counter() - t0
            if cur is not None:
                tracing.close_span(cur, span, token, wall)
            child_wall = self._child_wall.pop()
            self._child_wall[-1] += wall
        excl_wall = max(0.0, wall - child_wall)
        # device_profiling on: the synchronize's wait is this node's device
        # time (the ops above only enqueued); off: no sync is added and the
        # device time is estimated as the exclusive wall
        device_s, estimated = excl_wall, True
        if self.profile_sync:
            t_sync = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            device_s, estimated = time.perf_counter() - t_sync, False
            # the wait is elapsed inside this node's subtree: the parent's
            # exclusive wall stays exclusive of it
            self._child_wall[-1] += device_s
        nbytes = _mem.page_bytes(page)
        # one launch a node execution (each _exec_ dispatches this node's
        # device ops); the wall is exclusive, with the measured wait added
        # back, so wall - device is the node's dispatch overhead
        kwall = excl_wall + (0.0 if estimated else device_s)
        ks = self.kernel_stats.get((node.id, operator))
        if ks is None:
            ks = self.kernel_stats[(node.id, operator)] = {
                "planNodeId": str(node.id), "operator": operator, "tier": "eager",
                "launches": 0, "wallS": 0.0, "deviceS": 0.0, "inputBytes": 0,
                "outputBytes": 0, "estimated": estimated}
        ks["launches"] += 1
        ks["wallS"] += kwall
        ks["deviceS"] += device_s
        ks["inputBytes"] += sum(self._last_output_bytes.get(s.id, 0) for s in node.sources)
        ks["outputBytes"] += nbytes
        ks["estimated"] = bool(ks["estimated"] or estimated)
        DEVICE_PROFILER.count_launch(kwall, 0.0 if estimated else device_s)
        self._last_output_bytes[node.id] = nbytes
        if self.collect_stats:
            live = page.num_rows if page.sel is None else page.sel.sum()
            st = self.node_stats.get(node.id)
            if st is None:
                st = self.node_stats[node.id] = OperatorStats(node.id, operator)
            st.wall_s += excl_wall
            st.output_bytes += nbytes
            st.invocations += 1
            st.peak_bytes = max(st.peak_bytes, nbytes)
            self._row_terms.append((st, "output_rows", live))
            for s in node.sources:
                self._row_terms.append((st, "input_rows", self._last_output_rows.get(s.id, 0)))
            splits, scanned = self._pending_scan.pop(node.id, (0, 0))
            st.splits += splits
            st.input_rows += scanned  # a scan's input is the connector's rows
            self._last_output_rows[node.id] = live
        self.memory.observe(nbytes)
        return page

    def resolve_stats(self) -> None:
        """Add the live row counts still held as device scalars into
        ``node_stats``: one device-to-host read for the whole plan. The
        counts read replace their scalars in ``_last_output_rows``, so an
        executor kept after its run (a query's root or local executor)
        holds nothing on the card."""
        terms, self._row_terms = self._row_terms, []
        scalars = [v for _, _, v in terms if isinstance(v, torch.Tensor)]
        read = dict(zip(map(id, scalars), torch.stack(scalars).tolist() if scalars else ()))
        for st, field, v in terms:
            n = read[id(v)] if isinstance(v, torch.Tensor) else v
            setattr(st, field, getattr(st, field) + int(n))
        for nid, v in self._last_output_rows.items():
            if isinstance(v, torch.Tensor):
                self._last_output_rows[nid] = int(read[id(v)])

    def _narrowed_or_flag(self, col: Column, sel=None) -> Column:
        """A two-limb column degraded to its low word for consumers without
        limb kernels (the map-building aggregates' keys); live rows that do
        not fit int64 raise the deferred DECIMAL_OVERFLOW error."""
        if col.hi is None:
            return col
        self._narrow_lowered_or_flag(_col_to_lowered(col), col.hi, sel)
        return Column(col.type, col.values, col.nulls, col.dictionary)

    def _narrow_lowered_or_flag(self, arg, hi_l, sel_l=None):
        """Degrade a two-limb argument to its low word for consumers without
        limb kernels; live rows that do not fit int64 raise the deferred
        DECIMAL_OVERFLOW error."""
        if hi_l is None:
            return arg
        vals_l, valid_l = arg
        fits = hi_l == (vals_l.to(torch.int64) >> 63)
        if valid_l is not None:
            fits = fits | ~valid_l
        if sel_l is not None:
            fits = fits | ~sel_l
        self.errors.append((L.DECIMAL_OVERFLOW, (~fits).any()))
        return arg

    def _lower(self, e: ir.Expr, page: Page) -> L.LoweredVal:
        ctx = L.LowerCtx(page.columns, page.num_rows, page.sel, self.device,
                         getattr(self.session, "generator", None))
        out = L.lower(e, ctx)
        self.errors.extend(ctx.errors)
        return out

    # ----------------------------------------------------------------- scan
    def _host_applied_domains(self, node: P.TableScanNode) -> Dict:
        """The dynamic domains this executor applies on the host at the scan:
        part of the cache signature (devcache/keys.py)."""
        dyn = dynamic_domain_map(node, self.dyn_domains)
        if self.df_host_allow is not None:
            dyn = {c: d for c, d in dyn.items() if self.df_host_allow(node, c, d)}
        return dyn

    def _exec_TableScanNode(self, node: P.TableScanNode) -> Page:
        from trino_tpu_torch import devcache
        from trino_tpu_torch.exec import staging

        conn = self.session.catalogs[node.catalog]
        constraint = scan_constraint_with(node, self.dyn_domains)
        applied = self._host_applied_domains(node)

        def load():
            t0 = time.perf_counter()
            # adaptive split sizing (a pushdown handle stays one split)
            target = staging.target_split_count(
                self.session, conn, node.schema, node.table,
                handle=node.table_handle)
            splits = conn.get_splits(node.schema, node.table, target,
                                     constraint=constraint, handle=node.table_handle)

            def prune(datas):
                return apply_dynamic_domains(node, self.dyn_domains, datas,
                                             allow=self.df_host_allow)

            page, scanned, prof = staging.staged_scan_page(
                self.session, node, conn, splits, constraint,
                prune=prune, applied_domains=applied)
            self.df_apply_s += prof.prune_s
            M.STAGING_SECONDS.inc(time.perf_counter() - t0)
            return page, scanned, _mem.page_bytes(page), len(splits)

        ent, disposition = devcache.cached_stage(
            self.session, node, constraint, applied, "table", load)
        self.scan_cache[node.id] = disposition
        self.scan_stats[node.id] = ent.rows
        if self.collect_stats:
            self._pending_scan[node.id] = (ent.splits, ent.rows)
        return ent.value

    def _exec_ValuesNode(self, node: P.ValuesNode) -> Page:
        cols = [column_to_device(column_data_from_python(t, [r[i] for r in node.rows]),
                                 self.device)
                for i, t in enumerate(node.types)]
        # the same rows on every rank under SPMD: replicated
        if not cols:
            # zero-column rows (SELECT without FROM)
            return Page([Column(T.BIGINT, torch.zeros((len(node.rows),), dtype=torch.int64,
                                                      device=self.device))], replicated=True)
        return Page(cols, replicated=True)

    # -------------------------------------------------------------- set ops
    def _exec_UnionNode(self, node: P.UnionNode) -> Page:
        """UNION ALL: row-wise concatenation of the branches (dead rows stay
        dead; differing varchar vocabularies merge)."""
        pages = [self.execute(s) for s in node.sources_]
        with tracing.timed("exec/set-op", M.SET_OP_SECONDS, detail=True, op="union_all",
                           branches=len(pages)):
            out = pages[0]
            for p in pages[1:]:
                out = Page.concat_pages(out, p)
        return out

    def _exec_SetOpNode(self, node: P.SetOpNode) -> Page:
        left = self.execute(node.left)
        right = self.execute(node.right)
        with tracing.timed("exec/set-op", M.SET_OP_SECONDS, detail=True, op=node.op):
            return self.set_op_pages(node, left, right)

    def set_op_pages(self, node: P.SetOpNode, left: Page, right: Page) -> Page:
        """INTERSECT/EXCEPT DISTINCT: both sides concatenated with a side
        tag, grouped by every column (grouping equality makes NULLs equal,
        the set-operation semantics), groups kept by per-side counts."""
        both = Page.concat_pages(left, right)
        side_right = torch.arange(both.num_rows, device=self.device) >= left.num_rows
        return self._set_op_grouped(node, both, side_right)

    def _set_op_grouped(self, node: P.SetOpNode, both: Page, side_right) -> Page:
        """The grouping half of a set operation over a combined page with
        an explicit side tag a row: the SPMD tier calls it after a
        whole-row hash exchange, where the tag cannot be positional."""
        channels = list(range(len(both.columns)))
        layout, out_sel, (side_right_l,), sel_l = self.group_structure(
            channels, both, [side_right])
        l_cnt = seg.seg_sum(layout, (~side_right_l).to(torch.int64), sel_l, torch.int64)
        r_cnt = seg.seg_sum(layout, side_right_l.to(torch.int64), sel_l, torch.int64)
        if node.op == "intersect":
            keep = (l_cnt > 0) & (r_cnt > 0)
        else:  # except
            keep = (l_cnt > 0) & (r_cnt == 0)
        return Page(self._gathered_key_cols(both, channels, layout), out_sel & keep,
                    both.replicated)

    # --------------------------------------------------------------- filter
    def _exec_FilterNode(self, node: P.FilterNode) -> Page:
        page = self.execute(node.source)
        lv = self._lower(node.predicate, page)
        passed = lv.vals if lv.valid is None else (lv.vals & lv.valid)
        sel = passed if page.sel is None else (page.sel & passed)
        return Page(page.columns, sel, page.replicated)

    def _exec_CompactNode(self, node: P.CompactNode) -> Page:
        """Squeeze live rows into a smaller static-capacity page (skipped
        when there is no selection mask)."""
        page = self.execute(node.source)
        if page.sel is None:
            return page
        capacity = self.hint_capacity(f"cmp:{node.id}", page.sel.to(torch.int32))
        return self.compact_to(page, capacity, f"cmp:{node.id}")

    def hint_capacity(self, key: str, emit_counts: torch.Tensor) -> int:
        """Static output capacity by hint key; without a hint, the eager
        tier reads the exact total (one device sync) padded to a power of
        two (at least 16), and the compiled tier raises."""
        cap = self.capacity_hints.get(key)
        if cap is not None:
            return cap
        if not self.eager_tier:
            raise RuntimeError(
                f"{key} has no capacity hint in the compiled tier (its hints "
                "come from sql/planner/stats.py estimate_capacity_hints)")
        total = int(emit_counts.sum().item())
        cap = max(16, 1 << (max(total, 1) - 1).bit_length())
        self.capacity_hints[key] = cap
        return cap

    def compact_to(self, page: Page, capacity: int, key: str) -> Page:
        """Live rows first (one stable flag sort), then one gather per array
        at the first ``capacity`` indices. Original row order is kept, so
        ``ascending`` survives."""
        n = page.num_rows
        if page.sel is None or capacity >= n:
            return page
        if any(c.type.is_nested for c in page.columns):
            # a row gather cannot re-flatten variable-length children on the
            # device: the page keeps its selection mask instead
            return page
        live = page.sel
        total = live.to(torch.int32).sum()
        self.errors.append((f"CAPACITY_EXCEEDED:{key}", total > capacity))
        idx = ranks_ops.argsort32(~live)[:capacity].long()
        cols = []
        for c in page.columns:
            cols.append(Column(
                c.type, c.values[idx],
                c.nulls[idx] if c.nulls is not None else None,
                c.dictionary, c.vrange, ascending=c.ascending,
                hi=c.hi[idx] if c.hi is not None else None))
        sel = torch.arange(capacity, dtype=torch.int32, device=self.device) < \
            torch.clamp(total, max=capacity)
        return Page(cols, sel, page.replicated, live_prefix=True)

    def _exec_ProjectNode(self, node: P.ProjectNode) -> Page:
        page = self.execute(node.source)
        cols = []
        for e in node.expressions:
            if isinstance(e, ir.ColumnRef):
                # pass-through keeps vrange, dictionary and sort order
                cols.append(page.columns[e.index])
                continue
            cols.append(_col_from_lowered(e.type, self._lower(e, page)))
        return Page(cols, page.sel, page.replicated, live_prefix=page.live_prefix)

    # --------------------------------------------------------------- unnest
    def _exec_UnnestNode(self, node: P.UnnestNode) -> Page:
        return self.unnest_page(node, self.execute(node.source))

    def unnest_page(self, node: P.UnnestNode, page: Page) -> Page:
        """UNNEST as one expansion of exact host shape: the output capacity
        is the sum of the unnested values' flat child sizes (the exact row
        count for one array, a bound when several zip). Each output slot's
        parent row is one searchsorted over the output offsets; a
        replicated channel is a gather at the parent row, an unnested one a
        clamped gather of the flat child at ``offset[parent] + position``
        (NULL past the end of a shorter zipped array)."""
        from trino_tpu_torch.ops import array_ops as A

        n = page.num_rows
        lows = [self._lower(e, page) for e in node.unnest_exprs]
        if any(lv.children is None for lv in lows):
            raise NotImplementedError("UNNEST argument must be array/map-typed")
        if any(page.columns[c].type.is_nested for c in node.replicate_channels):
            raise NotImplementedError(
                "replicating an array/map column through UNNEST "
                "(project it before/after instead)")
        raw_lens = [lv.vals.to(torch.int32) for lv in lows]
        out_len = None
        for lv, ln in zip(lows, raw_lens):
            eff = ln if lv.valid is None else torch.where(lv.valid, ln, torch.zeros_like(ln))
            out_len = eff if out_len is None else torch.maximum(out_len, eff)
        if page.sel is not None:
            out_len = torch.where(page.sel, out_len, torch.zeros_like(out_len))
        out_offsets = A.offsets_from_lengths(out_len)
        # a host shape, not a device read
        capacity = max(1, sum(int(lv.children[0].vals.shape[0]) for lv in lows))
        slot = torch.arange(capacity, dtype=torch.int32, device=self.device)
        rowid = (torch.searchsorted(out_offsets, slot, right=True).to(torch.int32) - 1) \
            .clamp(0, n - 1).long()
        pos = slot - out_offsets[rowid]  # 0-based position in the parent row
        sel = slot < out_offsets[-1]
        cols: List[Column] = []
        for ci in node.replicate_channels:
            c = page.columns[ci]
            hi = c.hi[rowid] if c.hi is not None else None
            cols.append(Column(c.type, c.values[rowid],
                               c.nulls[rowid] if c.nulls is not None else None,
                               c.dictionary, c.vrange if hi is None else None, hi=hi))
        child_types = iter(node.output_types[len(node.replicate_channels):])
        for lv, raw_ln in zip(lows, raw_lens):
            child_off = A.offsets_from_lengths(raw_ln)
            in_range = pos < raw_ln[rowid]
            if lv.valid is not None:
                in_range = in_range & lv.valid[rowid]
            for child in lv.children:
                flat_n = int(child.vals.shape[0])
                idx = (child_off[rowid] + pos).clamp(0, max(flat_n - 1, 0)).long()
                valid = in_range
                if child.valid is not None:
                    valid = valid & A.nonempty(child.valid)[idx]
                cols.append(Column(next(child_types), A.nonempty(child.vals)[idx], ~valid,
                                   child.dictionary))
        if node.ordinality:
            cols.append(Column(T.BIGINT, (pos + 1).to(torch.int64)))
        return Page(cols, sel)

    # ---------------------------------------------------------- aggregation
    def _exec_AggregationNode(self, node: P.AggregationNode) -> Page:
        page = self.execute(node.source)
        if node.step == "partial":
            return self.aggregate_partial(node, page)
        if node.step == "final":
            return self.aggregate_final(node, page)
        return self.aggregate_page(node, page)

    def aggregate_partial(self, node: P.AggregationNode, page: Page) -> Page:
        """Partial aggregation: the group keys and each aggregate's
        accumulator states. State column types follow ``plan._acc_types``,
        so the page can cross the wire."""
        payload_arrays, slots = self._agg_payloads(node.aggregates, page.columns)
        layout, part_sel, payloads_l, sel_l = self.group_structure(
            node.group_channels, page, payload_arrays)
        out_cols: List[Column] = []
        if node.group_channels:
            out_cols.extend(self._gathered_key_cols(page, node.group_channels, layout))
        src_types = node.source.output_types
        for call, slot in zip(node.aggregates, slots):
            s1 = slot[0] if slot is not None else None
            hi_l = self._slot_hi(payloads_l, s1)
            arg1 = self._slot_arg(payloads_l, s1)
            if hi_l is not None and call.function not in ("sum", "count"):
                arg1 = self._narrow_lowered_or_flag(arg1, hi_l, sel_l)
                hi_l = None
            states = self._partial_states(call, page, layout, arg1, sel_l, hi_l=hi_l)
            for (sv, valid), st in zip(states, P._acc_types(call, src_types)):
                out_cols.append(Column(st, sv, None if valid is None else ~valid, None))
        return Page(out_cols, part_sel, page.replicated)

    def _state_payloads(self, page: Page, k: int, what: str):
        """The state columns after the ``k`` group keys as sort payloads
        (values, then validity where a column has NULLs), and each
        column's slot. Long-decimal two-limb states are refused."""
        payload_arrays: List = []
        state_slots: List = []
        for c in page.columns[k:]:
            if c.hi is not None:
                raise NotImplementedError(
                    f"{what} over long-decimal states beyond int64 (single-process "
                    "paths support them)")
            vi = len(payload_arrays)
            payload_arrays.append(c.values)
            hv = c.nulls is not None
            if hv:
                payload_arrays.append(~c.nulls)
            state_slots.append((vi, hv, None))
        return payload_arrays, state_slots

    def aggregate_final(self, node: P.AggregationNode, page: Page) -> Page:
        """Final aggregation over gathered partial-state pages."""
        k = len(node.group_channels)
        payload_arrays, state_slots = self._state_payloads(
            page, k, "distributed final aggregation")
        layout, out_sel, payloads_l, sel_l = self.group_structure(
            list(range(k)), page, payload_arrays)
        out_cols: List[Column] = []
        if k:
            out_cols.extend(self._gathered_key_cols(page, list(range(k)), layout))
        ci = 0
        for call in node.aggregates:
            n_states = P._acc_state_count(call)
            states = [self._slot_arg(payloads_l, state_slots[ci + j]) for j in range(n_states)]
            ci += n_states
            out_cols.append(self._combine_state(call, states, sel_l, layout))
        return Page(out_cols, out_sel, page.replicated)

    # aggregates whose partial states merge into states of the same dtypes
    # by plain sum/min/max reductions: what the streaming consumer's
    # intermediate fold supports
    MERGEABLE_STATE_FNS = {"count", "sum", "avg", "min", "max", "count_if"}

    def aggregate_intermediate(self, node: P.AggregationNode, page: Page) -> Page:
        """Merge partial-state pages into one partial-state page of the same
        schema (the fold step of the streaming consumer: its memory stays
        the groups plus one batch)."""
        k = len(node.group_channels)
        payload_arrays, state_slots = self._state_payloads(page, k, "intermediate merge")
        layout, out_sel, payloads_l, sel_l = self.group_structure(
            list(range(k)), page, payload_arrays)
        out_cols: List[Column] = []
        if k:
            out_cols.extend(self._gathered_key_cols(page, list(range(k)), layout))
        ci = 0
        for call in node.aggregates:
            n_states = P._acc_state_count(call)
            states = [self._slot_arg(payloads_l, state_slots[ci + j]) for j in range(n_states)]
            types = [page.columns[k + ci + j].type for j in range(n_states)]
            ci += n_states
            fn = call.function
            if fn not in self.MERGEABLE_STATE_FNS or call.distinct:
                raise NotImplementedError(f"intermediate merge of {fn}")
            if fn in ("count", "count_if"):
                merged = [agg_ops.agg_sum(layout, states[0], sel_l, torch.int64)]
            elif fn == "sum" and n_states == 2:
                lo_vals, lo_valid = states[0]
                hi_vals, _ = states[1]
                (m_hi, m_lo), nonempty = agg_ops.agg_sum_128(
                    layout, lo_vals, hi_vals, lo_valid, sel_l)
                merged = [(m_lo, nonempty), (m_hi, None)]
            elif fn == "sum":
                merged = [agg_ops.agg_sum(layout, states[0], sel_l,
                                          torch_dtype(types[0].np_dtype))]
            elif fn == "avg":
                merged = [
                    agg_ops.agg_sum(layout, states[0], sel_l, torch_dtype(types[0].np_dtype)),
                    agg_ops.agg_sum(layout, states[1], sel_l, torch.int64),
                ]
            elif fn == "min":
                merged = [agg_ops.agg_min(layout, states[0], sel_l)]
            else:  # max
                merged = [agg_ops.agg_max(layout, states[0], sel_l)]
            for (sv, valid), st in zip(merged, types):
                out_cols.append(Column(st, sv, None if valid is None else ~valid, None))
        return Page(out_cols, out_sel, page.replicated)

    def _partial_states(self, call: P.AggregateCall, page, layout, arg_l, sel_l, hi_l=None):
        """State arrays of one aggregate, [(values, valid)], as
        ``plan._acc_types`` lays them out; ``arg_l``/``sel_l`` in layout
        space."""
        if call.distinct:
            raise NotImplementedError(
                "DISTINCT aggregates cannot be split partial/final (the planner "
                "routes them through a gather exchange instead)")
        fn = call.function
        sel = sel_l
        if fn == "count" and call.arg_channel is None:
            v, _ = agg_ops.agg_count_star(layout, sel)
            return [(v, None)]
        arg = arg_l
        if fn == "count":
            v, _ = agg_ops.agg_count(layout, arg, sel)
            return [(v, None)]
        if fn == "sum":
            if P._is_long_decimal(call.output_type):
                # a two-limb running state: exact across the split over p38
                vals_l, valid_l = arg
                (s_hi, s_lo), nonempty = agg_ops.agg_sum_128(layout, vals_l, hi_l, valid_l, sel)
                return [(s_lo, nonempty), (s_hi, None)]
            return [agg_ops.agg_sum(layout, arg, sel, torch_dtype(call.output_type.np_dtype))]
        if fn == "avg":
            base = (torch_dtype(call.output_type.np_dtype) if call.output_type.is_decimal
                    else torch.float64)
            s, s_valid = agg_ops.agg_sum(layout, arg, sel, base)
            cnt, _ = agg_ops.agg_count(layout, arg, sel)
            return [(s, s_valid), (cnt, None)]
        if fn == "min":
            return [agg_ops.agg_min(layout, arg, sel)]
        if fn == "max":
            return [agg_ops.agg_max(layout, arg, sel)]
        if fn in P._VAR_FAMILY:
            t = page.columns[call.arg_channel].type
            cnt, mean, m2 = agg_ops.var_states(layout, arg, sel, t.scale if t.is_decimal else 0)
            return [(cnt, None), (mean, None), (m2, None)]
        if fn == "approx_percentile":
            vals_l, valid_l = arg
            return hll.percentile_states(layout, vals_l, agg_ops._live(sel, valid_l))
        if fn in ("bool_and", "bool_or"):
            red = agg_ops.agg_min if fn == "bool_and" else agg_ops.agg_max
            v, valid = red(layout, arg, sel)
            return [(v.to(torch.bool), valid)]
        if fn == "count_if":
            vals_l, valid_l = arg
            m = vals_l if valid_l is None else (vals_l & valid_l)
            v, _ = agg_ops.agg_count_star(layout, m if sel is None else m & sel)
            return [(v, None)]
        raise NotImplementedError(fn)

    def _combine_state(self, call: P.AggregateCall, states, sel, layout) -> Column:
        """One aggregate's result from its gathered states; ``states`` are
        (values, valid) pairs in layout space, as is ``sel``."""
        fn = call.function
        out_t = call.output_type

        def col(v, valid, t=out_t):
            return Column(t, v, None if valid is None else ~valid, None)

        if fn in ("count", "count_if"):
            v, _ = agg_ops.agg_sum(layout, states[0], sel, torch.int64)
            return Column(T.BIGINT, v, None, None)
        if fn == "sum":
            if P._is_long_decimal(out_t):
                lo_v, lo_valid = states[0]
                hi_v, _ = states[1]
                (s_hi, s_lo), nonempty = agg_ops.agg_sum_128(layout, lo_v, hi_v, lo_valid, sel)
                return Column(out_t, s_lo, ~nonempty, None, hi=s_hi)
            return col(*agg_ops.agg_sum(layout, states[0], sel, torch_dtype(out_t.np_dtype)))
        if fn == "avg":
            base = torch_dtype(out_t.np_dtype) if out_t.is_decimal else torch.float64
            s, _ = agg_ops.agg_sum(layout, states[0], sel, base)
            cnt, _ = agg_ops.agg_sum(layout, states[1], sel, torch.int64)
            return col(*agg_ops.finish_avg(s, cnt, out_t))
        if fn == "min":
            return col(*agg_ops.agg_min(layout, states[0], sel))
        if fn == "max":
            return col(*agg_ops.agg_max(layout, states[0], sel))
        if fn in P._VAR_FAMILY:
            cnt_i, m = states[0]
            if sel is not None:
                m = sel if m is None else (m & sel)
            cnt, mean, m2 = agg_ops.combine_var_states(
                layout, cnt_i, states[1][0], states[2][0], m)
            return col(*agg_ops.finish_var(cnt, mean, m2, fn))
        if fn == "approx_percentile":
            cnt_state = states[-1]
            if sel is not None:
                cv, cm = cnt_state
                cnt_state = (torch.where(sel, cv, torch.zeros_like(cv)), cm)
            return col(*hll.percentile_merge(layout, states[:-1], cnt_state, call.param))
        if fn in ("bool_and", "bool_or"):
            red = agg_ops.agg_min if fn == "bool_and" else agg_ops.agg_max
            v, valid = red(layout, states[0], sel)
            return col(v.to(torch.bool), valid, T.BOOLEAN)
        raise NotImplementedError(fn)

    def group_structure(self, group_channels: List[int], page: Page, payloads=(),
                        force_sort: bool = False):
        """(GroupLayout, out_sel, payloads_l, sel_l): direct-mapped for
        small dictionary/boolean key products (unless ``force_sort``), a
        boundary compare for a presorted single key, else the sort-based
        grouping. ``payloads`` and ``sel_l`` come back in layout space."""
        n = page.num_rows
        keys = [kl for c in group_channels for kl in _key_lowereds(page.columns[c])]
        sel = page.sel
        if not group_channels:
            gids = torch.zeros((n,), dtype=torch.int32, device=self.device)
            layout = seg.direct_layout(gids, 1, sel)
            return layout, torch.ones((1,), dtype=torch.bool, device=self.device), \
                list(payloads), sel
        direct = None if force_sort else self._direct_strides(group_channels, page)
        if direct is not None:
            strides, capacity = direct
            gids = torch.zeros((n,), dtype=torch.int32, device=self.device)
            for (vals, _), stride in zip(keys, strides):
                gids = gids + vals.to(torch.int32) * stride
            layout = seg.direct_layout(gids, capacity, sel)
            return layout, seg.occupancy(layout, sel), list(payloads), sel
        presorted = self._presorted_group(group_channels, page)
        if presorted is not None:
            # input already group-contiguous: boundaries are one compare
            vals = presorted
            dead = torch.zeros((n,), dtype=torch.bool, device=self.device) \
                if sel is None else ~sel
            first = torch.ones((1,), dtype=torch.bool, device=self.device)
            boundary = torch.cat([first, (vals[1:] != vals[:-1]) | (dead[1:] != dead[:-1])])
            gid_sorted = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
            num_groups = (boundary & ~dead).sum()
            layout = seg.sorted_layout(ranks_ops._iota32(n, self.device), gid_sorted,
                                       num_groups)
            return layout, torch.arange(n, device=self.device) < num_groups, \
                list(payloads), sel
        order, gid_sorted, num_groups, payloads_l = gb.group_plan(keys, sel, payloads)
        layout = seg.sorted_layout(order, gid_sorted, num_groups)
        sel_l = None
        if sel is not None:
            n_live = sel.to(torch.int32).sum()
            sel_l = torch.arange(n, dtype=torch.int32, device=self.device) < n_live
        return layout, torch.arange(n, device=self.device) < num_groups, payloads_l, sel_l

    @staticmethod
    def _agg_payloads(aggregates, columns):
        """(payload_arrays, slots): every non-distinct aggregate argument
        (values + validity + high limb) flattened into sort payloads; a
        call's slot is (first argument, second argument or None), or None
        for count(*) and DISTINCT."""
        payload_arrays: List = []
        slots: List = []

        def add(col):
            vi = len(payload_arrays)
            payload_arrays.append(col.values)
            hv = col.nulls is not None
            if hv:
                payload_arrays.append(~col.nulls)
            hii = None
            if col.hi is not None:
                hii = len(payload_arrays)
                payload_arrays.append(col.hi)
            return (vi, hv, hii)

        for call in aggregates:
            if call.arg_channel is None or call.distinct:
                slots.append(None)
                continue
            s2 = add(columns[call.arg2_channel]) if call.arg2_channel is not None else None
            slots.append((add(columns[call.arg_channel]), s2))
        return payload_arrays, slots

    @staticmethod
    def _slot_arg(payloads_l, slot):
        if slot is None:
            return None
        vi, hv, _ = slot
        return (payloads_l[vi], payloads_l[vi + 1] if hv else None)

    @staticmethod
    def _slot_hi(payloads_l, slot):
        if slot is None or slot[2] is None:
            return None
        return payloads_l[slot[2]]

    @staticmethod
    def _presorted_group(group_channels: List[int], page: Page):
        """The single group-key column when the page is already
        group-contiguous (ascending, null-free, dead rows a tail)."""
        if len(group_channels) != 1:
            return None
        col = page.columns[group_channels[0]]
        if not col.ascending or col.nulls is not None:
            return None
        if page.sel is not None and not page.live_prefix:
            return None
        return col.values

    @staticmethod
    def _direct_strides(group_channels: List[int], page: Page):
        sizes = []
        for c in group_channels:
            col = page.columns[c]
            if col.nulls is not None:
                return None
            if col.type.is_varchar and col.dictionary is not None:
                sizes.append(max(len(col.dictionary), 1))
            elif col.type == T.BOOLEAN:
                sizes.append(2)
            else:
                return None
        capacity = 1
        for s in sizes:
            capacity *= s
        if not 1 <= capacity <= seg.DIRECT_CAPACITY_MAX:
            return None
        strides = []
        acc = 1
        for s in reversed(sizes):
            strides.append(acc)
            acc *= s
        return list(reversed(strides)), capacity

    def aggregate_page(self, node: P.AggregationNode, page: Page) -> Page:
        """Group and aggregate; the output has ``capacity`` rows with sel
        marking live groups."""
        if node.group_channels and self.eager_tier:
            spilled = self._maybe_spill_aggregation(node, page)
            if spilled is not None:
                return spilled
        if page.num_rows == 0:
            page = Page(
                [Column(c.type, torch.zeros((1,), dtype=c.values.dtype, device=self.device),
                        None, c.dictionary) for c in page.columns],
                torch.zeros((1,), dtype=torch.bool, device=self.device))
        payload_arrays, slots = self._agg_payloads(node.aggregates, page.columns)
        # the nested aggregates' outputs are the per-group row runs of the
        # layout, and the direct layout never permutes: force the sort
        force_sort = any(c.function in _NESTED_AGGREGATES for c in node.aggregates)
        layout, out_sel, payloads_l, sel_l = self.group_structure(
            node.group_channels, page, payload_arrays, force_sort=force_sort)
        out_cols: List[Column] = []
        if node.group_channels:
            out_cols.extend(self._gathered_key_cols(page, node.group_channels, layout))
        for call, slot in zip(node.aggregates, slots):
            s1, s2 = slot if slot is not None else (None, None)
            if call.function in _NESTED_AGGREGATES:
                if call.distinct:
                    raise NotImplementedError(
                        f"{call.function}(DISTINCT): not yet supported")
                out_cols.append(self._nested_agg_column(
                    call, page, layout, self._slot_arg(payloads_l, s1), sel_l,
                    hi_l=self._slot_hi(payloads_l, s1)))
                continue
            res = self._exec_aggregate(
                call, page, layout, self._slot_arg(payloads_l, s1), sel_l,
                hi_l=self._slot_hi(payloads_l, s1),
                arg2_l=self._slot_arg(payloads_l, s2), hi2_l=self._slot_hi(payloads_l, s2))
            vals, valid = res[0], res[1]
            hi_out = res[2] if len(res) > 2 else None
            # value-carrying aggregates keep the argument's dictionary
            dictionary = None
            if call.function in _VALUE_AGGREGATES and call.arg_channel is not None:
                dictionary = page.columns[call.arg_channel].dictionary
            out_cols.append(Column(call.output_type, vals,
                                   (~valid) if valid is not None else None,
                                   dictionary, hi=hi_out))
        return Page(out_cols, out_sel, page.replicated)

    _in_spill_pass = False  # reentrancy guard for the aggregation passes

    def _maybe_spill_aggregation(self, node: P.AggregationNode, page: Page):
        """Over-budget group-by: hash-partition the rows by group key on the
        host, aggregate each partition fully on the device, concatenate.
        Partitions hold disjoint key sets, so each pass's result is exact."""
        if self._in_spill_pass or not self.spill_enabled:
            return None
        projected = _mem.page_bytes(page)
        parts = self.memory.spill_partitions(projected)
        if parts <= 1:
            return None
        self.memory.record_spill(node.id, "aggregation", parts, projected)
        out = None
        self._in_spill_pass = True
        try:
            for part in _mem.partition_page_host(page, node.group_channels, parts):
                res = self.aggregate_page(node, part).compact()
                out = res if out is None else Page.concat_pages(out, res)
        finally:
            self._in_spill_pass = False
        return out

    def _gathered_key_cols(self, page: Page, channels, layout) -> List[Column]:
        """Group-key columns gathered at each slot's representative row,
        rebuilding two-limb long decimals from their key operand pairs."""
        keys, spans = [], []
        for c in channels:
            parts = _key_lowereds(page.columns[c])
            spans.append((len(keys), len(parts)))
            keys.extend(parts)
        key_cols = gb.gather_group_keys(keys, layout.rep)
        out = []
        for (start, cnt), c in zip(spans, channels):
            src = page.columns[c]
            if cnt == 2:
                hi_v, valid = key_cols[start]
                lo_flip, _ = key_cols[start + 1]
                out.append(Column(src.type, lo_flip ^ _SIGN64,
                                  None if valid is None else ~valid, None, hi=hi_v))
            else:
                v, valid = key_cols[start]
                out.append(Column(src.type, v, None if valid is None else ~valid,
                                  src.dictionary, src.vrange))
        return out

    def _nested_agg_column(self, call, page, layout, arg_l, sel_l, hi_l=None) -> Column:
        """The aggregates with nested outputs. array_agg's array column is
        the layout's group-contiguous row runs: its lengths are the group
        ranges and its flat child the layout-space argument itself (NULL
        inputs stay NULL elements). A sorted layout puts live rows first
        from position 0, so the lengths' prefix sums are the group starts.
        The global case (the direct single-slot layout) moves the live rows
        to a prefix with one stable flag sort. histogram and map_agg go to
        ``_map_agg_column``."""
        if call.function in ("histogram", "map_agg"):
            return self._map_agg_column(call, page, layout)
        vals_l, valid_l = arg_l
        src = page.columns[call.arg_channel]
        if layout.is_direct:
            assert layout.capacity == 1, "grouped array_agg must use a sorted layout"
            flat, flat_valid, flat_hi = vals_l, valid_l, hi_l
            if sel_l is None:
                count = torch.full((1,), layout.n, dtype=torch.int32, device=self.device)
            else:
                order = ranks_ops.argsort32(~sel_l).long()
                flat = vals_l[order]
                flat_valid = valid_l[order] if valid_l is not None else None
                flat_hi = hi_l[order] if hi_l is not None else None
                count = sel_l.sum(dtype=torch.int32).reshape(1)
            lengths = count
        else:
            lengths = (layout.ends - layout.starts).to(torch.int32)
            flat, flat_valid, flat_hi = vals_l, valid_l, hi_l
        child = Column(call.output_type.element, flat,
                       None if flat_valid is None else ~flat_valid, src.dictionary,
                       hi=flat_hi)
        # an aggregate over no rows is NULL (an empty group arises only from
        # an empty input)
        return Column(call.output_type, lengths, lengths == 0, children=[child])

    def _map_agg_column(self, call, page, layout) -> Column:
        """histogram(x) / map_agg(k, v): each distinct (group, key) pair is
        one entry (``grouped_pairs`` over the original row order; NULL keys
        drop). histogram's values are the run counts, map_agg's the value at
        the run's representative row."""
        key_col = self._narrowed_or_flag(page.columns[call.arg_channel], page.sel)
        entry_counts, rep, run_counts, _live = agg_ops.grouped_pairs(
            layout, _col_to_lowered(key_col), page.sel)
        rep = rep.long()
        keys_flat = Column(call.output_type.key, key_col.values[rep], None, key_col.dictionary)
        if call.function == "histogram":
            vals_flat = Column(T.BIGINT, run_counts)
        else:
            vcol = page.columns[call.arg2_channel]
            vals_flat = Column(call.output_type.value, vcol.values[rep],
                               vcol.nulls[rep] if vcol.nulls is not None else None,
                               vcol.dictionary, hi=vcol.hi[rep] if vcol.hi is not None else None)
        # NULL for a group whose input is empty once NULL keys drop
        return Column(call.output_type, entry_counts, entry_counts == 0,
                      children=[keys_flat, vals_flat])

    def _exec_aggregate(self, call: P.AggregateCall, page, layout, arg_l, sel_l,
                        hi_l=None, arg2_l=None, hi2_l=None):
        """``arg_l``/``sel_l``/``hi_l`` (and the second argument's) in layout
        space; the DISTINCT calls re-group and take the original-order page
        column instead. Returns (vals, valid), or (lo, valid, hi) for
        two-limb sums."""
        if hi_l is not None and call.function not in ("sum", "count"):
            arg_l = self._narrow_lowered_or_flag(arg_l, hi_l, sel_l)
            hi_l = None
        if hi2_l is not None:
            arg2_l = self._narrow_lowered_or_flag(arg2_l, hi2_l, sel_l)
        fn = call.function
        if fn == "approx_percentile":
            if call.distinct:
                raise NotImplementedError("approx_percentile(DISTINCT) is not supported")
            vals_l, valid_l = arg_l
            return hll.approx_percentile(layout, vals_l, agg_ops._live(sel_l, valid_l),
                                         call.param)
        if call.distinct:
            arg = _col_to_lowered(page.columns[call.arg_channel])
            if fn == "approx_distinct":
                return hll.approx_distinct(layout, arg, page.sel)
            if fn != "count":
                raise NotImplementedError(f"{fn}(DISTINCT) is not ported")
            return agg_ops.agg_count_distinct(layout, arg, page.sel)
        sel = sel_l
        if fn == "count" and call.arg_channel is None:
            return agg_ops.agg_count_star(layout, sel)
        arg = arg_l
        if fn == "count":
            return agg_ops.agg_count(layout, arg, sel)
        if fn == "sum":
            vals_l, valid_l = arg
            out_t = call.output_type
            need128 = hi_l is not None
            if (not need128 and isinstance(out_t, T.DecimalType)
                    and out_t.precision > 18):
                # int64 accumulation is exact only when stats bound the
                # total; otherwise take the limb path
                src = page.columns[call.arg_channel]
                bound_ok = False
                if src.vrange is not None:
                    b = max(abs(int(src.vrange[0])), abs(int(src.vrange[1])))
                    bound_ok = b * max(layout.n, 1) < 2**62
                need128 = not bound_ok
            if need128:
                (s_hi, s_lo), nonempty = agg_ops.agg_sum_128(
                    layout, vals_l, hi_l, valid_l, sel)
                return s_lo, nonempty, s_hi
            return agg_ops.agg_sum(layout, arg, sel, torch_dtype(out_t.np_dtype))
        if fn == "avg":
            base = (torch_dtype(call.output_type.np_dtype) if call.output_type.is_decimal
                    else torch.float64)
            s, _ = agg_ops.agg_sum(layout, arg, sel, base)
            cnt, _ = agg_ops.agg_count(layout, arg, sel)
            return agg_ops.finish_avg(s, cnt, call.output_type)
        if fn == "min":
            return agg_ops.agg_min(layout, arg, sel)
        if fn == "max":
            return agg_ops.agg_max(layout, arg, sel)
        src_t = page.columns[call.arg_channel].type
        scale = src_t.scale if src_t.is_decimal else 0
        if fn in P._VAR_FAMILY:
            return agg_ops.agg_var(layout, arg, sel, fn, scale)
        if fn in ("bool_and", "bool_or"):
            # boolean min/max
            red = agg_ops.agg_max if fn == "bool_or" else agg_ops.agg_min
            v, valid = red(layout, arg, sel)
            return v.to(torch.bool), valid
        if fn == "count_if":
            vals_l, valid_l = arg
            m = vals_l if valid_l is None else (vals_l & valid_l)
            return agg_ops.agg_count_star(layout, m if sel is None else m & sel)
        if fn in ("arbitrary", "any_value"):
            return agg_ops.agg_first(layout, arg, sel)
        if fn == "geometric_mean":
            vals_l, valid_l = arg
            x = vals_l.to(torch.float64)
            if scale:
                x = x / (10.0 ** scale)
            # non-positive values give NaN, as log does
            ln = torch.where(x > 0, torch.log(x.clamp(min=1e-300)),
                             torch.full_like(x, float("nan")))
            s, nonempty = agg_ops.agg_sum(layout, (ln, valid_l), sel, torch.float64)
            cnt, _ = agg_ops.agg_count(layout, arg, sel)
            return torch.exp(s / cnt.clamp(min=1)), nonempty
        if fn == "checksum":
            return agg_ops.agg_sum(layout, (self._checksum_hashes(page, call, arg), None),
                                   sel, torch.int64)[0], None
        if fn in ("min_by", "max_by"):
            return agg_ops.agg_minmax_by(layout, arg, arg2_l, sel, fn == "min_by")
        if fn in _BIVARIATE:
            ty = page.columns[call.arg2_channel].type
            return agg_ops.agg_bivariate(layout, arg, arg2_l, sel, fn, scale,
                                         ty.scale if ty.is_decimal else 0)
        raise NotImplementedError(f"aggregate {fn} is not ported")

    def _checksum_hashes(self, page: Page, call: P.AggregateCall, arg) -> torch.Tensor:
        """Per-row content hashes whose sum (mod 2^64) is the reference's
        order-independent checksum: a varchar hashes its string (blake2b of
        the UTF-8, one table a vocabulary), a float its bits, anything else
        its int64 value through splitmix64; NULL has a fixed hash."""
        import hashlib

        vals_l, valid_l = arg
        src = page.columns[call.arg_channel]
        if src.dictionary is not None:
            lut = np.array([int.from_bytes(hashlib.blake2b(v.encode(), digest_size=8).digest(),
                                           "little", signed=True)
                            for v in src.dictionary.values] or [0], dtype=np.int64)
            h = to_device(lut, self.device)[vals_l.long().clamp(0, len(lut) - 1)]
        else:
            x = vals_l
            if x.dtype.is_floating_point:
                x = x.to(torch.float64).view(torch.int64)
            h = hll._mix64(x.to(torch.int64))
        if valid_l is not None:
            h = torch.where(valid_l, h, torch.full_like(h, _CHECKSUM_NULL))
        return h

    # -------------------------------------------------------------- window
    def _exec_WindowNode(self, node: P.WindowNode) -> Page:
        page = self.execute(node.source)
        with tracing.timed("exec/window", M.WINDOW_SECONDS, detail=True,
                           calls=len(node.calls)):
            return self.window_over_page(node, page)

    def window_over_page(self, node: P.WindowNode, page: Page) -> Page:
        """Every window call of the node over one shared sorted layout; the
        output is the source's channels followed by one per call."""
        n = page.num_rows
        pkeys = [kl for c in node.partition_channels
                 for kl in _key_lowereds(page.columns[c])]
        okeys = [(kl, asc, nf) for c, asc, nf in node.order_channels
                 for kl in _key_lowereds(page.columns[c])]
        layout = win_ops.build_layout(pkeys, okeys, page.sel, n, self.device)
        out_cols = list(page.columns)
        for call in node.calls:
            arg = None
            if call.arg_channel is not None:
                col = page.columns[call.arg_channel]
                arg = self._narrow_lowered_or_flag(_col_to_lowered(col), col.hi, page.sel)
            fn = call.function
            flo, fhi = call.frame_lo, call.frame_hi
            if fn == "row_number":
                v, valid = win_ops.row_number(layout)
            elif fn == "rank":
                v, valid = win_ops.rank(layout)
            elif fn == "dense_rank":
                v, valid = win_ops.dense_rank(layout)
            elif fn == "ntile":
                v, valid = win_ops.ntile(layout, call.offset)
            elif fn == "percent_rank":
                v, valid = win_ops.percent_rank(layout)
            elif fn == "cume_dist":
                v, valid = win_ops.cume_dist(layout)
            elif fn == "sum":
                v, valid = win_ops.agg_sum(layout, arg, call.frame,
                                           torch_dtype(call.output_type.np_dtype), flo, fhi)
            elif fn == "avg":
                base = (torch_dtype(call.output_type.np_dtype)
                        if call.output_type.is_decimal else torch.float64)
                s, s_valid = win_ops.agg_sum(layout, arg, call.frame, base, flo, fhi)
                cnt, _ = win_ops.agg_count(layout, arg, call.frame, flo, fhi)
                v, dvalid = agg_ops.finish_avg(s, cnt, call.output_type)
                valid = dvalid if s_valid is None else (s_valid & dvalid)
            elif fn in ("count", "count_star"):
                v, valid = win_ops.agg_count(layout, arg, call.frame, flo, fhi)
            elif fn in ("min", "max"):
                v, valid = win_ops.agg_minmax(layout, arg, call.frame, fn == "min")
            elif fn in ("lag", "lead"):
                v, valid = win_ops.shifted_value(layout, arg, call.offset, fn == "lead")
            elif fn == "nth_value":
                v, valid = win_ops.nth_value(layout, arg, call.offset, call.frame, flo, fhi)
            elif fn in ("first_value", "last_value"):
                v, valid = win_ops.edge_value(layout, arg, call.frame,
                                              fn == "first_value", flo, fhi)
            else:
                raise NotImplementedError(f"window function {fn}")
            # value-carrying functions keep the source column's dictionary
            dictionary = None
            if fn in _VALUE_WINDOW_FUNCTIONS:
                dictionary = page.columns[call.arg_channel].dictionary
            out_cols.append(Column(call.output_type, v,
                                   None if valid is None else ~valid, dictionary))
        return Page(out_cols, page.sel, page.replicated)

    # -------------------------------------------------------------- joins
    def _exec_JoinNode(self, node: P.JoinNode) -> Page:
        # build side first, so its key domains can narrow the probe scans
        right = self.execute(node.right)
        if self.enable_dynamic_filtering and node.dyn_filter_keys:
            self._collect_dynamic_filters(node, right)
        left = self.execute(node.left)
        if node.left_keys and self.eager_tier:
            spilled = self._maybe_spill_join(node, left, right)
            if spilled is not None:
                return spilled
        return self._run_join_kernel(node, left, right)

    _in_join_spill = False  # the join passes run on partitions, not scans

    def _maybe_spill_join(self, node: P.JoinNode, left: Page, right: Page):
        """When probe + build exceed the device budget, hash-partition both
        sides by join key on the host and run the join as independent
        passes; equal keys co-locate, so the union of the passes is the
        exact join."""
        if not self.spill_enabled:
            return None
        projected = _mem.page_bytes(left) + _mem.page_bytes(right)
        parts = self.memory.spill_partitions(projected)
        if parts <= 1:
            return None
        self.memory.record_spill(node.id, "join", parts, projected)
        lparts = _mem.partition_page_host(left, node.left_keys, parts)
        rparts = _mem.partition_page_host(right, node.right_keys, parts)
        out = None
        hint_key = f"join:{node.id}"
        self._in_join_spill = True
        try:
            for lp, rp in zip(lparts, rparts):
                # each pass sizes its own expansion
                self.capacity_hints.pop(hint_key, None)
                res = self._run_join_kernel(node, lp, rp).compact()
                out = res if out is None else Page.concat_pages(out, res)
        finally:
            self._in_join_spill = False
            self.capacity_hints.pop(hint_key, None)
        return out

    def _run_join_kernel(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        """The one join dispatch, shared by the direct path and the spilled
        passes."""
        if node.join_type in ("semi", "anti"):
            if node.filter is not None:
                return self.semi_join_filtered(node, left, right)
            return self.semi_join(node, left, right)
        if not node.left_keys:
            if node.singleton:
                return self.singleton_cross(node, left, right)
            return self.expand_join(node, left, right)  # true cross join
        if node.right_unique:
            return self.lookup_join(node, left, right)
        return self.expand_join(node, left, right)

    def _collect_dynamic_filters(self, node: P.JoinNode, build: Page) -> None:
        """Build-side key domains for the probe scans the optimizer
        annotated, reduced on the device (``reduced_key_domains``): one read
        a join, and a key's live rows copied only where they form a set. The
        ``exec/dynamic-filter`` span, whose seconds go to
        ``trino_tpu_dynamic_filter_seconds_total`` and whose copies' bytes
        to ``trino_tpu_dynamic_filter_host_bytes_total``; the keys whose
        rows were copied count in ``trino_tpu_dynamic_filter_copied_keys_total``."""
        with tracing.timed("exec/dynamic-filter", M.DYNAMIC_FILTER_SECONDS, detail=True,
                           node=node.id, keys=len(node.dyn_filter_keys),
                           rows=build.num_rows) as sp:
            keys, cols = [], []
            for i in node.dyn_filter_keys:
                col = build.columns[node.right_keys[i]]
                # varchar dictionary codes are page-local, not portable; a
                # two-limb key's ``values`` holds its low limb alone
                if not col.type.is_varchar and col.hi is None:
                    keys.append(i)
                    cols.append(col)
            found, nbytes, copied = reduced_key_domains(build, cols, self.DYNAMIC_FILTER_MAX_SET)
            for i, (dom, _) in zip(keys, found):
                self.dyn_domains[(node.id, i)] = dom
            M.DYNAMIC_FILTER_COPIED_KEYS.inc(copied)
            M.DYNAMIC_FILTER_HOST_BYTES.inc(nbytes)
            sp.set("bytes", nbytes)
            sp.set("kind", ",".join(kind for _, kind in found))

    @staticmethod
    def _join_keys_aligned(left: Page, right: Page, left_keys, right_keys):
        """(build_keys, probe_keys) aligned for the join kernels, expanding
        two-limb key columns into (hi, lo-flipped) pairs on both sides."""
        build_keys, probe_keys, bvr, pvr = [], [], [], []
        for lc, rc in zip(left_keys, right_keys):
            bc, pc = right.columns[rc], left.columns[lc]
            if bc.hi is not None or pc.hi is not None:
                build_keys.extend(_key_lowereds(bc, force_two_limb=True))
                probe_keys.extend(_key_lowereds(pc, force_two_limb=True))
                bvr.extend([None, None])
                pvr.extend([None, None])
            else:
                build_keys.append(_col_to_lowered(bc))
                probe_keys.append(_col_to_lowered(pc))
                bvr.append(bc.vrange)
                pvr.append(pc.vrange)
        return join_ops.align_join_keys(build_keys, probe_keys, bvr, pvr)

    @staticmethod
    def _gather_right_cols(right_cols, rows, mask) -> List[Column]:
        """Build-side payload columns gathered at the matched row ids."""
        _refuse_nested_payloads(right_cols)
        lows = [_col_to_lowered(rc) for rc in right_cols]
        hi_map = {}
        for i, rc in enumerate(right_cols):
            if rc.hi is not None:
                hi_map[i] = len(lows)
                lows.append((rc.hi, None))
        g = join_ops.gather_columns(lows, rows, mask)
        out = []
        for i, rc in enumerate(right_cols):
            v, valid = g[i]
            hi = g[hi_map[i]][0] if i in hi_map else None
            out.append(Column(rc.type, v, ~valid if valid is not None else None,
                              rc.dictionary, rc.vrange if hi is None else None, hi=hi))
        return out

    @staticmethod
    def _build_presorted(page: Page, key_channels) -> bool:
        """True when the build page's single join key is ascending,
        null-free, and dead rows form a tail — the build sort is skipped."""
        if len(key_channels) != 1:
            return False
        col = page.columns[key_channels[0]]
        if not col.ascending or col.nulls is not None:
            return False
        return page.sel is None or page.live_prefix

    def _dense_join_cols(self, node: P.JoinNode, left: Page, right: Page):
        """(build_col, probe_col, lo, span) when the single-int-key dense
        direct-address kernel applies, else None."""
        if len(node.right_keys) != 1:
            return None
        bc = right.columns[node.right_keys[0]]
        pc = left.columns[node.left_keys[0]]
        if bc.hi is not None or pc.hi is not None:
            return None
        if bc.type.is_varchar or pc.type.is_varchar:
            return None
        if not (join_ops._is_int(bc.values.dtype) and join_ops._is_int(pc.values.dtype)):
            return None
        ds = join_ops.dense_span(bc.vrange, right.num_rows)
        if ds is None:
            return None
        return bc, pc, ds[0], ds[1]

    def _count_tier(self, tier: str) -> None:
        if self.count_tiers:
            M.FUSED_JOIN_SELECTIONS.inc(1, tier)

    def _fused_join_enabled(self) -> bool:
        return bool(self.props.get("fused_join_enabled", True))

    def _merge_sentinel_safe(self, node: P.JoinNode, left: Page, right: Page,
                             build_keys) -> bool:
        """The merge kernel's contract: a single int32 key whose proven value
        range keeps INT32_MAX (the dead-row sentinel and pad) unreachable."""
        if len(node.right_keys) != 1 or len(build_keys) != 1:
            return False
        bc = right.columns[node.right_keys[0]]
        pc = left.columns[node.left_keys[0]]
        if bc.hi is not None or pc.hi is not None:
            return False
        if bc.type.is_varchar or pc.type.is_varchar:
            return False
        if build_keys[0][0].dtype != torch.int32:
            return False
        return (bc.vrange is not None and pc.vrange is not None
                and max(int(bc.vrange[1]), int(pc.vrange[1])) < 2**31 - 1)

    def _merge_sorted_tier(self, node: P.JoinNode, left: Page, right: Page,
                           build, build_keys, probe_keys, record: bool = True):
        """(rows, matched) by merging probes against an already-sorted
        build: the merge kernel (ops/merge.py) when the session enables it
        (``fused_join_pallas``) and its contract holds, the rank merge
        otherwise. ``record=False`` skips the tier count (the overlapped
        exchange merges once a send block, but selects once a join)."""
        use_kernel = (bool(self.props.get("fused_join_pallas"))
                      and self._merge_sentinel_safe(node, left, right, build_keys))
        if record:
            self._count_tier("merge-pallas" if use_kernel else "merge-sorted")
        return fused_ops.merge_sorted_build(build, probe_keys, use_pallas=use_kernel)

    def _cached_sorted_build(self, node: P.JoinNode, right: Page, build_keys):
        """The SortedBuild served by the device cache, or None. The build
        side must be a bare versioned TableScanNode, so the artifact's
        identity is provable from the scan signature and the join-key
        signature. Never inside a spilled join: there ``right`` is one
        hash partition of the scan, not the scan. Never in the compiled
        tier, which sorts in its captured body."""
        scan = node.right
        if (not self.eager_tier or self._in_join_spill
                or not isinstance(scan, P.TableScanNode)):
            return None
        from trino_tpu_torch import devcache

        constraint = scan_constraint_with(scan, self.dyn_domains)
        dtypes = ",".join(str(v.dtype).replace("torch.", "") for v, _ in build_keys)

        def load():
            build = join_ops.build_side(build_keys, right.sel)
            arrays = list(build.cols) + [build.rows, build.live]
            nbytes = sum(int(a.numel()) * a.element_size() for a in arrays)
            return build, int(build.n), nbytes, 0

        built, _disposition = devcache.cached_build(
            self.session, scan, constraint, self._host_applied_domains(scan),
            tuple(node.right_keys), dtypes, load)
        return built

    def _sortmerge_probe(self, node: P.JoinNode, left: Page, right: Page):
        """(build_row_idx, matched) for the N:1 lookup join when the dense
        table does not apply: the merge tier for a presorted build key or a
        device-cached sorted build, the fused sort-merge tier otherwise;
        legacy build_side + probe_unique when the fused tier is disabled."""
        build_keys, probe_keys = self._join_keys_aligned(
            left, right, node.left_keys, node.right_keys)
        presorted = self._build_presorted(right, node.right_keys)
        if self._fused_join_enabled():
            cached = None if presorted else self._cached_sorted_build(
                node, right, build_keys)
            if presorted or cached is not None:
                build = cached if cached is not None else join_ops.build_side(
                    build_keys, right.sel, presorted=True)
                return self._merge_sorted_tier(node, left, right, build,
                                               build_keys, probe_keys)
            self._count_tier("fused")
            return fused_ops.fused_probe_unique(build_keys, right.sel, probe_keys)
        self._count_tier("legacy")
        build = join_ops.build_side(build_keys, right.sel, presorted=presorted)
        return join_ops.probe_unique(build, probe_keys)

    def lookup_join(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        dense = self._dense_join_cols(node, left, right)
        if dense is not None:
            self._count_tier("dense")
            bc, pc, lo, span = dense
            table = join_ops.dense_unique_table(_col_to_lowered(bc), right.sel, lo, span)
            rows, matched = join_ops.dense_probe_unique(table, _col_to_lowered(pc), lo)
        else:
            rows, matched = self._sortmerge_probe(node, left, right)
        return self._assemble_lookup_output(node, left, right, rows, matched)

    def _assemble_lookup_output(self, node: P.JoinNode, left: Page, right: Page,
                                rows, matched) -> Page:
        """Gather build payloads at the matched rows and apply join-type and
        residual-filter semantics."""
        out_cols = list(left.columns)
        out_cols.extend(self._gather_right_cols(right.columns, rows, matched))
        if node.join_type == "inner":
            sel = matched if left.sel is None else (left.sel & matched)
        else:  # left outer: probe rows survive; build cols null when unmatched
            sel = left.sel
        page = Page(out_cols, sel, left.replicated)
        if node.filter is not None:
            lv = self._lower(node.filter, page)
            passed = lv.vals if lv.valid is None else (lv.vals & lv.valid)
            if node.join_type == "left":
                keep_match = matched & passed
                new_cols = list(left.columns)
                for oc in out_cols[len(left.columns):]:
                    nulls = ~keep_match if oc.nulls is None else (oc.nulls | ~keep_match)
                    new_cols.append(Column(oc.type, oc.values, nulls, oc.dictionary))
                return Page(new_cols, left.sel, left.replicated)
            page = Page(out_cols, passed if page.sel is None else page.sel & passed,
                        left.replicated)
        return page

    def semi_join(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        dense = self._dense_join_cols(node, left, right)
        if dense is not None:
            self._count_tier("dense")
            bc, pc, lo, span = dense
            hit = join_ops.dense_membership(
                _col_to_lowered(bc), right.sel, _col_to_lowered(pc), lo, span)
        else:
            build_keys, probe_keys = self._join_keys_aligned(
                left, right, node.left_keys, node.right_keys)
            presorted = self._build_presorted(right, node.right_keys)
            if self._fused_join_enabled():
                # the lookup join's gate: presorted or cached sorted builds
                # take the merge tier (build duplicates are fine for
                # membership), everything else fuses
                cached = None if presorted else self._cached_sorted_build(
                    node, right, build_keys)
                if presorted or cached is not None:
                    build = cached if cached is not None else join_ops.build_side(
                        build_keys, right.sel, presorted=True)
                    _rows, hit = self._merge_sorted_tier(
                        node, left, right, build, build_keys, probe_keys)
                else:
                    self._count_tier("fused")
                    hit = fused_ops.fused_membership(build_keys, right.sel, probe_keys)
            else:
                self._count_tier("legacy")
                hit = join_ops.membership(build_keys, right.sel, probe_keys,
                                          presorted=presorted)
        keep = hit if node.join_type == "semi" else ~hit
        sel = keep if left.sel is None else left.sel & keep
        return Page(left.columns, sel, left.replicated)

    def _expansion_keys(self, node: P.JoinNode, left: Page, right: Page):
        if node.left_keys:
            return self._join_keys_aligned(left, right, node.left_keys, node.right_keys)
        # cross join: everything matches everything (a constant key)
        return ([(torch.zeros((right.num_rows,), dtype=torch.int32, device=self.device), None)],
                [(torch.zeros((left.num_rows,), dtype=torch.int32, device=self.device), None)])

    def _expand_matches(self, node: P.JoinNode, left: Page, right: Page, plain_outer: bool):
        """The probe-major M:N expansion: (p, live, matched, columns) with
        the probe columns gathered at each output slot's probe row ``p`` and
        the build columns at its match (NULL where ``matched`` is false).
        ``plain_outer`` gives every live probe row at least one slot. One
        host read of the exact total sizes the output in the eager tier; the
        compiled tier takes the ``join:<id>`` hint and flags an overflow."""
        build_keys, probe_keys = self._expansion_keys(node, left, right)
        build = join_ops.build_side(
            build_keys, right.sel,
            presorted=bool(node.left_keys) and self._build_presorted(right, node.right_keys))
        lo, counts = join_ops.probe_counts(build, probe_keys, left.sel)
        emit = counts
        if plain_outer:
            probe_live = (torch.ones_like(counts, dtype=torch.bool) if left.sel is None
                          else left.sel)
            emit = torch.where(probe_live, counts.clamp(min=1), torch.zeros_like(counts))
        if self.eager_tier:
            capacity = max(int(emit.to(torch.int64).sum().item()), 1)
        else:
            capacity = self.hint_capacity(f"join:{node.id}", emit)
        p, k, live, total = join_ops.expand(emit, capacity)
        if not self.eager_tier:
            self.errors.append((f"CAPACITY_EXCEEDED:join:{node.id}", total > capacity))
        _refuse_nested_payloads(left.columns)
        g = ranks_ops.batched_gather([lo, counts] + _flat_arrays(left.columns), p)
        matched = live & (k < g[1])
        rows = build.rows[(g[0] + k).clamp(0, build.n - 1)]
        out_cols = _cols_from_flat(left.columns, g[2:])
        out_cols.extend(self._gather_right_cols(right.columns, rows, matched))
        return p, live, matched, out_cols

    def expand_join(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        """General M:N inner/left join (and the true cross join): count the
        matches per probe row, then gather into an exact-size probe-major
        output."""
        outer = node.join_type == "left"
        p, live, matched, out_cols = self._expand_matches(
            node, left, right, plain_outer=outer and node.filter is None)
        replicated = left.replicated and right.replicated
        if node.filter is None:
            return Page(out_cols, live, replicated)
        lv = self._lower(node.filter, Page(out_cols, live))
        passed = lv.vals if lv.valid is None else (lv.vals & lv.valid)
        if not outer:
            return Page(out_cols, live & passed, replicated)
        # left join with a filter: the expanded rows that pass, plus one
        # null-build row for each probe row with no passing match
        passing = live & matched & passed
        n = left.num_rows
        any_pass = seg.monotonic_segment_sum(passing.to(torch.int32), p, n) > 0
        probe_live = torch.ones_like(any_pass) if left.sel is None else left.sel
        tail_cols = list(left.columns)
        for rc in right.columns:
            tail_cols.append(Column(rc.type, torch.zeros((n,), dtype=rc.values.dtype,
                                                         device=self.device),
                                    torch.ones((n,), dtype=torch.bool, device=self.device),
                                    rc.dictionary))
        return Page.concat_pages(Page(out_cols, passing, replicated),
                                 Page(tail_cols, probe_live & ~any_pass, replicated))

    def semi_join_filtered(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        """Semi/anti join with a residual filter (a correlated EXISTS with
        non-equality predicates): expand the matches, evaluate the filter,
        then reduce any-passing back onto the probe rows."""
        p, live, _, exp_cols = self._expand_matches(node, left, right, plain_outer=False)
        lv = self._lower(node.filter, Page(exp_cols, live))
        passed = lv.vals if lv.valid is None else (lv.vals & lv.valid)
        hit = seg.monotonic_segment_sum((live & passed).to(torch.int32), p,
                                        left.num_rows) > 0
        keep = hit if node.join_type == "semi" else ~hit
        sel = keep if left.sel is None else left.sel & keep
        return Page(left.columns, sel, left.replicated)

    def singleton_cross(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        """Cross join against a single-row relation (a scalar subquery);
        zero or several live rows raise through the deferred error flags."""
        if right.sel is None:
            live = torch.full((), right.num_rows, dtype=torch.int64, device=self.device)
            idx = torch.zeros((1,), dtype=torch.int64, device=self.device)
        else:
            live = right.sel.sum()
            # a one-element index gathers on the device (a 0-d one is read
            # to the host)
            idx = torch.argmax(right.sel.to(torch.int32)).reshape(1)
        self.errors.append(("SCALAR_SUBQUERY_MULTIPLE_ROWS", live > 1))
        self.errors.append(("SCALAR_SUBQUERY_NO_ROWS", live < 1))
        n = left.num_rows
        out_cols = list(left.columns)
        for rc in right.columns:
            nulls = rc.nulls[idx].expand(n) if rc.nulls is not None else None
            out_cols.append(Column(rc.type, rc.values[idx].expand(n), nulls, rc.dictionary,
                                   rc.vrange))
        page = Page(out_cols, left.sel, left.replicated)
        if node.filter is not None:
            lv = self._lower(node.filter, page)
            passed = lv.vals if lv.valid is None else lv.vals & lv.valid
            page = Page(out_cols, passed if page.sel is None else page.sel & passed,
                        left.replicated)
        return page

    # ----------------------------------------------------- pattern matching
    def _exec_MatchRecognizeNode(self, node: P.MatchRecognizeNode) -> Page:
        """MATCH_RECOGNIZE on the host (exec/match_recognize.py): the
        backtracking matcher is sequential, and its input is
        post-aggregation scale. Partitions run in the order of their keys'
        text; rows within one follow the ORDER BY, NULLs last ascending.
        Refused in the compiled tier, as in the reference."""
        if not self.eager_tier:
            raise NotImplementedError("MATCH_RECOGNIZE executes on the host tier")
        page = self.execute(node.source)
        with tracing.timed("exec/host-pass", M.NESTED_HOST_SECONDS, detail=True,
                           fn="match_recognize",
                           entries=page.num_rows):
            return self._match_recognize_host(node, page)

    def _match_recognize_host(self, node: P.MatchRecognizeNode, page: Page) -> Page:
        from trino_tpu_torch.exec.match_recognize import run_match_recognize

        names = node.input_names or node.source.output_names
        # case-insensitive, as the analyzer resolves names
        lnames = [n.lower() for n in names]
        parts: Dict[tuple, List[dict]] = {}
        part_names = [lnames[c] for c in node.partition_channels]
        for r in page.to_pylist():
            row = dict(zip(lnames, r))
            parts.setdefault(tuple(row[n] for n in part_names), []).append(row)
        sort_cols = [(lnames[c], asc) for c, asc, _n in node.sort_channels]

        def order_key(row):
            return tuple(_SortKey(row[n], asc) for n, asc in sort_cols)

        out_rows: List[tuple] = []
        for key in sorted(parts, key=lambda k: tuple(map(repr, k))):
            for mvals in run_match_recognize(
                    parts[key], order_key, list(node.pattern), list(node.defines),
                    list(node.measures), node.after_match):
                out_rows.append(key + mvals)
        if not out_rows:
            return Page.all_dead(node.output_types, self.device)
        return Page([column_to_device(column_data_from_python(t, [r[i] for r in out_rows]),
                                      self.device)
                     for i, t in enumerate(node.output_types)])

    # ------------------------------------------------------------- ordering
    def _exec_SortNode(self, node: P.SortNode) -> Page:
        return self.sorted_page(self.execute(node.source), node.sort_channels)

    def sorted_page(self, page: Page, sort_channels, limit: Optional[int] = None) -> Page:
        """Rows in sort order (dead rows last); sel becomes a prefix mask of
        the live (and limit-capped) rows. Every array rides the one sort
        permutation; a page with a nested column sorts on the host (not in
        the compiled tier, whose body has no host step)."""
        if any(c.type.is_nested for c in page.columns):
            if not self.eager_tier:
                raise NotImplementedError(
                    "ORDER BY of a page with array/map columns in the compiled tier")
            with tracing.timed("exec/host-pass", M.NESTED_HOST_SECONDS, detail=True,
                           fn="sort_nested",
                               entries=page.num_rows):
                return self._sorted_page_host(page, sort_channels, limit)
        n = page.num_rows
        keys = [(kl, asc, nf) for c, asc, nf in sort_channels
                for kl in _key_lowereds(page.columns[c])]
        sorted_arrays = sort_ops.sort_payloads(keys, page.sel, _flat_arrays(page.columns))
        live = (torch.full((), n, dtype=torch.int64, device=self.device)
                if page.sel is None else page.sel.sum())
        if limit is not None:
            live = torch.clamp(live, max=limit)
        sel = torch.arange(n, device=self.device) < live
        return Page(_cols_from_flat(page.columns, sorted_arrays), sel, page.replicated)

    @staticmethod
    def _sorted_page_host(page: Page, sort_channels, limit=None) -> Page:
        """ORDER BY on the host for a page with nested columns: compact,
        one stable lexsort with SQL NULL placement, then ``host_take`` of
        the permutation, which re-flattens the children."""
        compacted = page.compact()
        lex_keys = []  # least significant first, for np.lexsort
        for c, asc, nf in reversed(list(sort_channels)):
            col = compacted.columns[c]
            if col.type.is_nested:
                raise NotImplementedError("ORDER BY an array/map column")
            v = to_numpy(col.values)
            if v.dtype == np.bool_:
                v = v.astype(np.int8)
            if not asc:
                v = -v if np.issubdtype(v.dtype, np.floating) else ~v
            nulls_first = (not asc) if nf is None else nf
            if col.nulls is not None:
                isnull = to_numpy(col.nulls)
                lex_keys.append(np.where(isnull, np.zeros((), v.dtype), v))
                lex_keys.append((~isnull if nulls_first else isnull).astype(np.int8))
            else:
                lex_keys.append(v)
        order = np.lexsort(lex_keys) if lex_keys else np.arange(compacted.num_rows)
        if limit is not None:
            order = order[:limit]
        return Page([host_take(c, order) for c in compacted.columns], None, page.replicated)

    def _exec_TopNNode(self, node: P.TopNNode) -> Page:
        return self.sorted_page(self.execute(node.source), node.sort_channels,
                                limit=node.count)

    def _exec_LimitNode(self, node: P.LimitNode) -> Page:
        return self.sorted_page(self.execute(node.source), [], limit=node.count)

    def _exec_OutputNode(self, node: P.OutputNode) -> Page:
        return self.execute(node.source)


def _refuse_nested_payloads(cols: List[Column]) -> None:
    """Join payloads are flat: a nested column is refused, as in the
    reference."""
    if any(c.type.is_nested for c in cols):
        raise NotImplementedError("array/map columns through join payloads")


class _SortKey:
    """A total-order sort key with SQL NULL placement (last ascending,
    first descending)."""

    __slots__ = ("v", "asc")

    def __init__(self, v, asc):
        self.v, self.asc = v, asc

    def __lt__(self, other):
        a, b = self.v, other.v
        if a is None or b is None:
            if a is None and b is None:
                return False
            return (a is None) != self.asc  # None last when ascending
        return (a < b) if self.asc else (b < a)

    def __eq__(self, other):
        # value equality: a tuple compares a later key only when the
        # earlier ones are equal
        return self.v == other.v


@dataclasses.dataclass
class QueryResult:
    column_names: List[str]
    columns: List[Column]
    rows: List[tuple]

    def __repr__(self):
        return f"QueryResult({self.column_names}, {len(self.rows)} rows)"
