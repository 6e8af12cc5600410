"""Eager plan executor over device Pages: the port of
trino_tpu/exec/executor.py for the local path.

Each plan node is a whole-column tensor transformation on the session's
device: filters keep selection masks instead of compacting, aggregations
emit padded outputs with a live-group prefix, sorts move dead rows last.
Ported nodes: TableScan (adaptive splits staged in parallel through the
host-RAM tier and double-buffered copies, exec/staging.py, behind the
opt-in device table cache, devcache/), Values, Filter, Compact, Project,
Aggregation (single step, count(DISTINCT) included), Join (N:1 lookup and
semi/anti through the dense / fused / merge tier gate, where a bare
cached scan's sorted build goes to the merge tier; M:N inner and left
expansion, semi/anti with a residual filter, the singleton cross join of a
scalar subquery and the true cross join), Sort, TopN, Limit and Output.
An expansion's output is sized by one host read of its exact total. A
per-query MemoryContext (exec/memory.py) observes every node's output
bytes; over the ``query_max_device_memory`` budget, joins and grouped
aggregations hash-partition their inputs on the host and run in passes.
The compiled tier is not ported.

Data-dependent runtime errors (division by zero, decimal overflow,
capacity overflow, a scalar subquery without exactly one row) are
collected as boolean flags and checked once after execution.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.page import (Column, Page, column_data_from_python, to_device,
                                      to_numpy, torch_dtype)
from trino_tpu_torch.exec import memory as _mem
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.ops import aggregate as agg_ops
from trino_tpu_torch.ops import expr_lower as L
from trino_tpu_torch.ops import fused_join as fused_ops
from trino_tpu_torch.ops import groupby as gb
from trino_tpu_torch.ops import join as join_ops
from trino_tpu_torch.ops import ranks as ranks_ops
from trino_tpu_torch.ops import segments as seg
from trino_tpu_torch.ops import sort as sort_ops
from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.planner import plan as P

_SIGN64 = -(2**63)


class QueryError(RuntimeError):
    def __init__(self, message: str, code: str = ""):
        super().__init__(message)
        self.code = code


def raise_query_errors(codes, flags):
    """Raise the first deferred runtime error whose flag fired."""
    for code, flag in zip(codes, flags):
        if bool(flag.any().item()):
            raise QueryError(code.replace("_", " ").capitalize(), code=code)


def _col_from_lowered(t: T.Type, lv: L.LoweredVal) -> Column:
    nulls = None if lv.valid is None else ~lv.valid
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


def apply_dynamic_domains(node, dyn_domains, datas):
    """Drop scanned host rows outside the scan's dynamic-filter domains
    before the device transfer (connectors treat constraints as advisory).
    Varchar domains are skipped: dictionary codes are page-local."""
    from trino_tpu_torch.connector.spi import column_data_take
    from trino_tpu_torch.exec.host_eval import domain_mask

    dyn = dynamic_domain_map(node, dyn_domains)
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


class Executor:
    """Eager plan interpreter on ``session.device``; ``execute_checked``
    runs the plan and raises deferred errors."""

    DYNAMIC_FILTER_MAX_SET = 1024  # in-set domain cap

    def __init__(self, session):
        self.session = session
        self.device = session.device
        self.errors: List[Tuple[str, torch.Tensor]] = []
        # static output capacities by hint key ("cmp:<id>" for Compact)
        self.capacity_hints: Dict[str, int] = {}
        # build-side key domains by (join_id, key_index), consumed by probe
        # scans annotated by the optimizer
        self.dyn_domains: Dict[Tuple[int, int], object] = {}
        self.props = getattr(session, "properties", None) or {}
        self.enable_dynamic_filtering = bool(
            self.props.get("dynamic_filtering_enabled", True))
        # per scan node: the device-cache disposition (hit | miss | bypass)
        # and the rows its page holds
        self.scan_cache: Dict[int, str] = {}
        self.scan_stats: Dict[int, int] = {}
        # device-memory budget, peak and spill decisions (exec/memory.py)
        self.memory = _mem.MemoryContext(self.props.get("query_max_device_memory"))
        self.spill_enabled = bool(self.props.get("spill_enabled", True))

    # ------------------------------------------------------------------ api
    def execute_checked(self, node: P.PlanNode) -> Page:
        page = self.execute(node)
        self.raise_errors()
        return page

    def raise_errors(self):
        raise_query_errors([c for c, _ in self.errors], [f for _, f in self.errors])

    def execute(self, node: P.PlanNode) -> Page:
        method = getattr(self, f"_exec_{type(node).__name__}", None)
        if method is None:
            raise NotImplementedError(f"executor: {type(node).__name__} is not ported")
        page = method(node)
        # each operator's output rolls into the query's peak (exact bytes)
        self.memory.observe(_mem.page_bytes(page))
        return page

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
        ctx = L.LowerCtx(page.columns, page.num_rows, page.sel, self.device)
        out = L.lower(e, ctx)
        self.errors.extend(ctx.errors)
        return out

    # ----------------------------------------------------------------- scan
    def _host_applied_domains(self, node: P.TableScanNode) -> Dict:
        """The dynamic domains this executor applies on the host at the scan:
        part of the cache signature (devcache/keys.py)."""
        return dynamic_domain_map(node, self.dyn_domains)

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
                return apply_dynamic_domains(node, self.dyn_domains, datas)

            page, scanned, _prof = staging.staged_scan_page(
                self.session, node, conn, splits, constraint,
                prune=prune, applied_domains=applied)
            M.STAGING_SECONDS.inc(time.perf_counter() - t0)
            return page, scanned, _mem.page_bytes(page), len(splits)

        ent, disposition = devcache.cached_stage(
            self.session, node, constraint, applied, "table", load)
        self.scan_cache[node.id] = disposition
        self.scan_stats[node.id] = ent.rows
        return ent.value

    def _exec_ValuesNode(self, node: P.ValuesNode) -> Page:
        cols = []
        for i, t in enumerate(node.types):
            cd = column_data_from_python(t, [r[i] for r in node.rows])
            cols.append(Column(
                t, to_device(cd.values, self.device),
                to_device(cd.nulls, self.device) if cd.nulls is not None else None,
                cd.dictionary,
                hi=to_device(cd.hi, self.device) if cd.hi is not None else None))
        if not cols:
            # zero-column rows (SELECT without FROM)
            return Page([Column(T.BIGINT, torch.zeros((len(node.rows),), dtype=torch.int64,
                                                      device=self.device))])
        return Page(cols)

    # --------------------------------------------------------------- filter
    def _exec_FilterNode(self, node: P.FilterNode) -> Page:
        page = self.execute(node.source)
        lv = self._lower(node.predicate, page)
        passed = lv.vals if lv.valid is None else (lv.vals & lv.valid)
        sel = passed if page.sel is None else (page.sel & passed)
        return Page(page.columns, sel)

    def _exec_CompactNode(self, node: P.CompactNode) -> Page:
        """Squeeze live rows into a smaller static-capacity page (skipped
        when there is no selection mask)."""
        page = self.execute(node.source)
        if page.sel is None:
            return page
        capacity = self.hint_capacity(f"cmp:{node.id}", page.sel.to(torch.int32))
        return self.compact_to(page, capacity, f"cmp:{node.id}")

    def hint_capacity(self, key: str, emit_counts: torch.Tensor) -> int:
        """Static output capacity by hint key; without a hint, the exact
        total (one device sync) padded to a power of two (at least 16)."""
        cap = self.capacity_hints.get(key)
        if cap is not None:
            return cap
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
        return Page(cols, sel, live_prefix=True)

    def _exec_ProjectNode(self, node: P.ProjectNode) -> Page:
        page = self.execute(node.source)
        cols = []
        for e in node.expressions:
            if isinstance(e, ir.ColumnRef):
                # pass-through keeps vrange, dictionary and sort order
                cols.append(page.columns[e.index])
                continue
            cols.append(_col_from_lowered(e.type, self._lower(e, page)))
        return Page(cols, page.sel, live_prefix=page.live_prefix)

    # ---------------------------------------------------------- aggregation
    def _exec_AggregationNode(self, node: P.AggregationNode) -> Page:
        if node.step != "single":
            raise NotImplementedError(f"{node.step} aggregation is not ported")
        return self.aggregate_page(node, self.execute(node.source))

    def group_structure(self, group_channels: List[int], page: Page, payloads=()):
        """(GroupLayout, out_sel, payloads_l, sel_l): direct-mapped for
        small dictionary/boolean key products, a boundary compare for a
        presorted single key, else the sort-based grouping. ``payloads``
        and ``sel_l`` come back in layout space."""
        n = page.num_rows
        keys = [kl for c in group_channels for kl in _key_lowereds(page.columns[c])]
        sel = page.sel
        if not group_channels:
            gids = torch.zeros((n,), dtype=torch.int32, device=self.device)
            layout = seg.direct_layout(gids, 1, sel)
            return layout, torch.ones((1,), dtype=torch.bool, device=self.device), \
                list(payloads), sel
        direct = self._direct_strides(group_channels, page)
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
        (values + validity + high limb) flattened into sort payloads."""
        payload_arrays: List = []
        slots: List = []
        for call in aggregates:
            if call.arg_channel is None or call.distinct:
                slots.append(None)
                continue
            if call.arg2_channel is not None:
                raise NotImplementedError(f"two-argument aggregate {call.function}")
            col = columns[call.arg_channel]
            vi = len(payload_arrays)
            payload_arrays.append(col.values)
            hv = col.nulls is not None
            if hv:
                payload_arrays.append(~col.nulls)
            hii = None
            if col.hi is not None:
                hii = len(payload_arrays)
                payload_arrays.append(col.hi)
            slots.append((vi, hv, hii))
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
        if node.group_channels:
            spilled = self._maybe_spill_aggregation(node, page)
            if spilled is not None:
                return spilled
        if page.num_rows == 0:
            page = Page(
                [Column(c.type, torch.zeros((1,), dtype=c.values.dtype, device=self.device),
                        None, c.dictionary) for c in page.columns],
                torch.zeros((1,), dtype=torch.bool, device=self.device))
        payload_arrays, slots = self._agg_payloads(node.aggregates, page.columns)
        layout, out_sel, payloads_l, sel_l = self.group_structure(
            node.group_channels, page, payload_arrays)
        out_cols: List[Column] = []
        if node.group_channels:
            out_cols.extend(self._gathered_key_cols(page, node.group_channels, layout))
        for call, slot in zip(node.aggregates, slots):
            res = self._exec_aggregate(
                call, page, layout, self._slot_arg(payloads_l, slot), sel_l,
                hi_l=self._slot_hi(payloads_l, slot))
            vals, valid = res[0], res[1]
            hi_out = res[2] if len(res) > 2 else None
            dictionary = None
            if call.function in ("min", "max") and call.arg_channel is not None:
                dictionary = page.columns[call.arg_channel].dictionary
            out_cols.append(Column(call.output_type, vals,
                                   (~valid) if valid is not None else None,
                                   dictionary, hi=hi_out))
        return Page(out_cols, out_sel)

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

    def _exec_aggregate(self, call: P.AggregateCall, page, layout, arg_l, sel_l,
                        hi_l=None):
        """``arg_l``/``sel_l``/``hi_l`` in layout space; count(DISTINCT)
        re-groups and takes the original-order page column instead. Returns
        (vals, valid), or (lo, valid, hi) for two-limb sums."""
        if call.distinct:
            if call.function != "count":
                raise NotImplementedError(f"{call.function}(DISTINCT) is not ported")
            return agg_ops.agg_count_distinct(
                layout, _col_to_lowered(page.columns[call.arg_channel]), page.sel)
        if hi_l is not None and call.function not in ("sum", "count"):
            arg_l = self._narrow_lowered_or_flag(arg_l, hi_l, sel_l)
            hi_l = None
        sel = sel_l
        if call.function == "count" and call.arg_channel is None:
            return agg_ops.agg_count_star(layout, sel)
        arg = arg_l
        if call.function == "count":
            return agg_ops.agg_count(layout, arg, sel)
        if call.function == "sum":
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
        if call.function == "avg":
            base = (torch_dtype(call.output_type.np_dtype) if call.output_type.is_decimal
                    else torch.float64)
            s, _ = agg_ops.agg_sum(layout, arg, sel, base)
            cnt, _ = agg_ops.agg_count(layout, arg, sel)
            return agg_ops.finish_avg(s, cnt, call.output_type)
        if call.function == "min":
            return agg_ops.agg_min(layout, arg, sel)
        if call.function == "max":
            return agg_ops.agg_max(layout, arg, sel)
        raise NotImplementedError(f"aggregate {call.function} is not ported")

    # -------------------------------------------------------------- joins
    def _exec_JoinNode(self, node: P.JoinNode) -> Page:
        # build side first, so its key domains can narrow the probe scans
        right = self.execute(node.right)
        if self.enable_dynamic_filtering and node.dyn_filter_keys:
            self._collect_dynamic_filters(node, right)
        left = self.execute(node.left)
        if node.left_keys:
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
        """Build-side key domains, extracted host-side (one device sync per
        key), for the probe scans the optimizer annotated."""
        from trino_tpu_torch.connector.predicate import Domain

        for i in node.dyn_filter_keys:
            col = build.columns[node.right_keys[i]]
            if col.type.is_varchar:
                continue  # dictionary codes are page-local, not portable
            vals = to_numpy(col.values)
            live = (np.ones(len(vals), bool) if build.sel is None
                    else to_numpy(build.sel).copy())
            if col.nulls is not None:
                live &= ~to_numpy(col.nulls)
            lv = vals[live]
            if len(lv) == 0:
                dom = Domain(values=frozenset())  # provably empty probe
            elif len(lv) <= self.DYNAMIC_FILTER_MAX_SET:
                dom = Domain.from_values(np.unique(lv).tolist())
            else:
                dom = Domain.range(low=lv.min().item(), high=lv.max().item())
            self.dyn_domains[(node.id, i)] = dom

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
                           build, build_keys, probe_keys):
        """(rows, matched) by merging probes against an already-sorted
        build: the merge kernel (ops/merge.py) when the session enables it
        (``fused_join_pallas``) and its contract holds, the rank merge
        otherwise."""
        use_kernel = (bool(self.props.get("fused_join_pallas"))
                      and self._merge_sentinel_safe(node, left, right, build_keys))
        M.FUSED_JOIN_SELECTIONS.inc(1, "merge-pallas" if use_kernel else "merge-sorted")
        return fused_ops.merge_sorted_build(build, probe_keys, use_pallas=use_kernel)

    def _cached_sorted_build(self, node: P.JoinNode, right: Page, build_keys):
        """The SortedBuild served by the device cache, or None. The build
        side must be a bare versioned TableScanNode, so the artifact's
        identity is provable from the scan signature and the join-key
        signature. Never inside a spilled join: there ``right`` is one
        hash partition of the scan, not the scan."""
        scan = node.right
        if self._in_join_spill or not isinstance(scan, P.TableScanNode):
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
            M.FUSED_JOIN_SELECTIONS.inc(1, "fused")
            return fused_ops.fused_probe_unique(build_keys, right.sel, probe_keys)
        M.FUSED_JOIN_SELECTIONS.inc(1, "legacy")
        build = join_ops.build_side(build_keys, right.sel, presorted=presorted)
        return join_ops.probe_unique(build, probe_keys)

    def lookup_join(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        dense = self._dense_join_cols(node, left, right)
        if dense is not None:
            M.FUSED_JOIN_SELECTIONS.inc(1, "dense")
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
        page = Page(out_cols, sel)
        if node.filter is not None:
            lv = self._lower(node.filter, page)
            passed = lv.vals if lv.valid is None else (lv.vals & lv.valid)
            if node.join_type == "left":
                keep_match = matched & passed
                new_cols = list(left.columns)
                for oc in out_cols[len(left.columns):]:
                    nulls = ~keep_match if oc.nulls is None else (oc.nulls | ~keep_match)
                    new_cols.append(Column(oc.type, oc.values, nulls, oc.dictionary))
                return Page(new_cols, left.sel)
            page = Page(out_cols, passed if page.sel is None else page.sel & passed)
        return page

    def semi_join(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        dense = self._dense_join_cols(node, left, right)
        if dense is not None:
            M.FUSED_JOIN_SELECTIONS.inc(1, "dense")
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
                    M.FUSED_JOIN_SELECTIONS.inc(1, "fused")
                    hit = fused_ops.fused_membership(build_keys, right.sel, probe_keys)
            else:
                M.FUSED_JOIN_SELECTIONS.inc(1, "legacy")
                hit = join_ops.membership(build_keys, right.sel, probe_keys,
                                          presorted=presorted)
        keep = hit if node.join_type == "semi" else ~hit
        sel = keep if left.sel is None else left.sel & keep
        return Page(left.columns, sel)

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
        host read of the exact total sizes the output."""
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
        total = int(emit.to(torch.int64).sum().item())
        p, k, live, _ = join_ops.expand(emit, max(total, 1))
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
        if node.filter is None:
            return Page(out_cols, live)
        lv = self._lower(node.filter, Page(out_cols, live))
        passed = lv.vals if lv.valid is None else (lv.vals & lv.valid)
        if not outer:
            return Page(out_cols, live & passed)
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
        return Page.concat_pages(Page(out_cols, passing),
                                 Page(tail_cols, probe_live & ~any_pass))

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
        return Page(left.columns, sel)

    def singleton_cross(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        """Cross join against a single-row relation (a scalar subquery);
        zero or several live rows raise through the deferred error flags."""
        if right.sel is None:
            live = torch.tensor(right.num_rows, dtype=torch.int64, device=self.device)
            idx = torch.zeros((), dtype=torch.int64, device=self.device)
        else:
            live = right.sel.sum()
            idx = torch.argmax(right.sel.to(torch.int32))
        self.errors.append(("SCALAR_SUBQUERY_MULTIPLE_ROWS", live > 1))
        self.errors.append(("SCALAR_SUBQUERY_NO_ROWS", live < 1))
        n = left.num_rows
        out_cols = list(left.columns)
        for rc in right.columns:
            nulls = rc.nulls[idx].expand(n) if rc.nulls is not None else None
            out_cols.append(Column(rc.type, rc.values[idx].expand(n), nulls, rc.dictionary,
                                   rc.vrange))
        page = Page(out_cols, left.sel)
        if node.filter is not None:
            lv = self._lower(node.filter, page)
            passed = lv.vals if lv.valid is None else lv.vals & lv.valid
            page = Page(out_cols, passed if page.sel is None else page.sel & passed)
        return page

    # ------------------------------------------------------------- ordering
    def _exec_SortNode(self, node: P.SortNode) -> Page:
        return self.sorted_page(self.execute(node.source), node.sort_channels)

    def sorted_page(self, page: Page, sort_channels, limit: Optional[int] = None) -> Page:
        """Rows in sort order (dead rows last); sel becomes a prefix mask of
        the live (and limit-capped) rows. Every array rides the one sort
        permutation."""
        n = page.num_rows
        keys = [(kl, asc, nf) for c, asc, nf in sort_channels
                for kl in _key_lowereds(page.columns[c])]
        sorted_arrays = sort_ops.sort_payloads(keys, page.sel, _flat_arrays(page.columns))
        live = (torch.tensor(n, dtype=torch.int64, device=self.device)
                if page.sel is None else page.sel.sum())
        if limit is not None:
            live = torch.clamp(live, max=limit)
        sel = torch.arange(n, device=self.device) < live
        return Page(_cols_from_flat(page.columns, sorted_arrays), sel)

    def _exec_TopNNode(self, node: P.TopNNode) -> Page:
        return self.sorted_page(self.execute(node.source), node.sort_channels,
                                limit=node.count)

    def _exec_LimitNode(self, node: P.LimitNode) -> Page:
        return self.sorted_page(self.execute(node.source), [], limit=node.count)

    def _exec_OutputNode(self, node: P.OutputNode) -> Page:
        return self.execute(node.source)


@dataclasses.dataclass
class QueryResult:
    column_names: List[str]
    columns: List[Column]
    rows: List[tuple]

    def __repr__(self):
        return f"QueryResult({self.column_names}, {len(self.rows)} rows)"
