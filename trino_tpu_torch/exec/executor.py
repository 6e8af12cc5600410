"""Eager plan executor over device Pages: the port of
trino_tpu/exec/executor.py for the local path.

Each plan node is a whole-column tensor transformation on the session's
device: filters keep selection masks instead of compacting, aggregations
emit padded outputs with a live-group prefix, sorts move dead rows last.
Ported nodes: TableScan (connector splits straight to the device, with
host-side dynamic-filter pruning), Filter, Compact, Project, Aggregation
(single step), Join (N:1 lookup and semi/anti, through the dense / fused /
merge tier gate), Sort, TopN, Limit and Output. The device cache, the
staging pool, spill, M:N expansion joins and the compiled tier are not
ported.

Data-dependent runtime errors (division by zero, decimal overflow,
capacity overflow) are collected as boolean flags and checked once after
execution.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.page import (Column, Page, fits_int32, to_device, to_numpy,
                                      torch_dtype)
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


def page_from_host_columns(column_types, host_cols, device) -> Page:
    """Host ColumnData list -> device Page, with the reference's physical
    int32 narrowing of provably fitting int64 columns (table-wide vrange)."""
    if host_cols is None:
        return Page.all_dead(column_types, device)
    cols = []
    for typ, cd in zip(column_types, host_cols):
        if typ.is_nested:
            raise NotImplementedError(f"scanning a {typ} column")
        vals = np.asarray(cd.values)
        if cd.hi is None and vals.dtype == np.int64 and fits_int32(cd.vrange):
            vals = vals.astype(np.int32)
        cols.append(Column(
            typ,
            to_device(vals, device),
            to_device(np.asarray(cd.nulls), device) if cd.nulls is not None else None,
            cd.dictionary,
            cd.vrange,
            ascending=bool(getattr(cd, "sorted", False)),
            hi=to_device(np.asarray(cd.hi), device) if cd.hi is not None else None,
        ))
    return Page(cols)


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
        return method(node)

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
    def _exec_TableScanNode(self, node: P.TableScanNode) -> Page:
        from trino_tpu_torch.connector.spi import concat_column_data

        conn = self.session.catalogs[node.catalog]
        constraint = scan_constraint_with(node, self.dyn_domains)
        splits = conn.get_splits(node.schema, node.table, 1, constraint=constraint,
                                 handle=node.table_handle)
        columns = list(node.column_names)
        datas = [conn.scan(s, columns, constraint=constraint) for s in splits]
        datas = apply_dynamic_domains(node, self.dyn_domains, datas)
        host_cols = None
        if datas:
            host_cols = [concat_column_data([d[c] for d in datas]) for c in columns]
            if len(np.asarray(host_cols[0].values)) == 0:
                host_cols = None
        return page_from_host_columns(node.column_types, host_cols, self.device)

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
        """``arg_l``/``sel_l``/``hi_l`` in layout space. Returns
        (vals, valid), or (lo, valid, hi) for two-limb sums."""
        if call.distinct:
            raise NotImplementedError(f"{call.function}(DISTINCT) is not ported")
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
        if node.join_type in ("semi", "anti"):
            if node.filter is not None:
                raise NotImplementedError("semi/anti join with a residual filter")
            return self.semi_join(node, left, right)
        if node.left_keys and node.right_unique:
            return self.lookup_join(node, left, right)
        raise NotImplementedError(
            "cross, singleton and M:N expansion joins are not ported")

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

    def _sortmerge_probe(self, node: P.JoinNode, left: Page, right: Page):
        """(build_row_idx, matched) for the N:1 lookup join when the dense
        table does not apply: the merge tier for a presorted build key, the
        fused sort-merge tier otherwise; legacy build_side + probe_unique
        when the fused tier is disabled."""
        build_keys, probe_keys = self._join_keys_aligned(
            left, right, node.left_keys, node.right_keys)
        presorted = self._build_presorted(right, node.right_keys)
        if self._fused_join_enabled():
            if presorted:
                build = join_ops.build_side(build_keys, right.sel, presorted=True)
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
                if presorted:
                    build = join_ops.build_side(build_keys, right.sel, presorted=True)
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
        payloads = []
        for c in page.columns:
            payloads.append(c.values)
            if c.nulls is not None:
                payloads.append(c.nulls)
            if c.hi is not None:
                payloads.append(c.hi)
        sorted_arrays = sort_ops.sort_payloads(keys, page.sel, payloads)
        live = (torch.tensor(n, dtype=torch.int64, device=self.device)
                if page.sel is None else page.sel.sum())
        if limit is not None:
            live = torch.clamp(live, max=limit)
        sel = torch.arange(n, device=self.device) < live
        cols = []
        i = 0
        for c in page.columns:
            v = sorted_arrays[i]
            i += 1
            nulls = None
            if c.nulls is not None:
                nulls = sorted_arrays[i]
                i += 1
            chi = None
            if c.hi is not None:
                chi = sorted_arrays[i]
                i += 1
            cols.append(Column(c.type, v, nulls, c.dictionary,
                               c.vrange if chi is None else None, hi=chi))
        return Page(cols, sel)

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
