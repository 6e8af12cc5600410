"""Phase-1 host evaluation for the compiled tier's two-phase dynamic
filtering: the port's copy of trino_tpu/exec/host_eval.py, numpy on the
host with its imports rewritten.

Reference role: ``DynamicFilterService.java:105`` (collect build-side key
domains at runtime, narrow probe scans) + ``sql/planner/AdaptivePlanner.java``
(replan from runtime facts). The compiled tier (exec/compiled.py) stages
every scan before its body is captured, so the eager tier's
execute-build-side-first dynamic filtering cannot run there. Instead a
**phase 1** runs on the host: evaluate each DF-producing join's build
subplan with numpy (dynamic shapes are free on the host), extract the key
domains, and only then stage the probe scans, physically narrowed. Phase 2
is the captured program over the narrowed inputs.

Exactness contract: a dynamic-filter domain must be a SUPERSET of the build
side's true key set (a too-narrow domain silently drops rows). Host numpy
arithmetic on ints/decimals(scaled ints)/dates/dictionary codes is exact;
float REDUCTIONS (sum/avg) and decimal division are order/rounding sensitive
and may differ from the device, so any filter consuming such a column makes
the subplan ``Unsupported`` and the DF is skipped (conservative = correct).

``domain_mask`` is the port's own: a NaN among a domain's values matches no
row, where the JAX package's calls ``int()`` on the largest value and raises
when that is NaN.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.connector.predicate import Domain, TupleDomain
from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.planner import plan as P

# In-set domain cap for phase-1 collected filters. Much larger than the eager
# tier's 1024: these sets are applied host-side with sorted np.isin (cheap)
# and physically shrink the staged probe pages, which is the whole point.
PHASE1_MAX_SET = 1 << 21


class Unsupported(Exception):
    """The subplan uses a node/expression/exactness the host evaluator does
    not handle; the caller skips that dynamic filter (never an error)."""


@dataclasses.dataclass
class HCol:
    """One host column: numpy values (+nulls mask, True = NULL). Varchar
    rides decoded numpy unicode arrays (vocabularies are host-side anyway).
    ``exact`` is False for order/rounding-sensitive results (float sums,
    decimal division) — see the module exactness contract."""

    type: T.Type
    values: np.ndarray
    nulls: Optional[np.ndarray] = None
    exact: bool = True

    def take(self, idx) -> "HCol":
        return HCol(
            self.type,
            self.values[idx],
            None if self.nulls is None else self.nulls[idx],
            self.exact,
        )

    def live_values(self) -> np.ndarray:
        if self.nulls is None:
            return self.values
        return self.values[~self.nulls]


@dataclasses.dataclass
class HPage:
    cols: List[HCol]

    @property
    def num_rows(self) -> int:
        return len(self.cols[0].values) if self.cols else 0

    def take(self, idx) -> "HPage":
        return HPage([c.take(idx) for c in self.cols])


def domain_mask(dom: Domain, values: np.ndarray, nulls=None) -> np.ndarray:
    """Vectorized Domain.contains over a host column."""
    if dom.values is not None:
        from trino_tpu_torch.connector.predicate import sorted_values_array

        sa = sorted_values_array(dom)
        if sa.dtype.kind == "f":
            sa = sa[~np.isnan(sa)]  # NaN equals nothing, not even NaN
        values = np.asarray(values)
        if len(sa) == 0:
            m = np.zeros(len(values), dtype=bool)
        elif sa.dtype.kind in "iu" and values.dtype.kind in "iu" \
                and int(sa[-1]) - int(sa[0]) + 1 <= max(8 * len(values), 1 << 22):
            # dense-span set: a boolean lookup table turns membership
            # into one bounded gather; cached on the Domain, which is
            # applied to every split of a scan
            lo, hi = int(sa[0]), int(sa[-1])
            cached = getattr(dom, "values_lut", None)
            if cached is not None and cached[0] == lo:
                lut = cached[1]
            else:
                lut = np.zeros(hi - lo + 1, dtype=bool)
                lut[sa.astype(np.int64) - lo] = True
                object.__setattr__(dom, "values_lut", (lo, lut))
            inb = (values >= lo) & (values <= hi)
            idx = np.where(inb, values.astype(np.int64) - lo, 0)
            m = inb & lut[idx]
        else:
            idx = np.clip(np.searchsorted(sa, values), 0, len(sa) - 1)
            m = sa[idx] == values
    else:
        m = np.ones(len(values), dtype=bool)
        if dom.low is not None:
            m &= values >= dom.low if dom.low_inclusive else values > dom.low
        if dom.high is not None:
            m &= values <= dom.high if dom.high_inclusive else values < dom.high
    if nulls is not None:
        m = np.where(np.asarray(nulls), dom.null_allowed, m)
    return m


def _decode_varchar(cd) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Dictionary codes -> numpy unicode ('<U') array + null mask. Unicode
    dtype (not object) so lexsort/isin/unique all work vectorized."""
    codes = np.asarray(cd.values)
    vocab = np.asarray(cd.dictionary.values if cd.dictionary else [], dtype=str)
    null = codes < 0
    if cd.nulls is not None:
        null = null | np.asarray(cd.nulls)
    if len(vocab) == 0:
        return np.full(len(codes), "", dtype=str), null
    vals = vocab[np.clip(codes, 0, None)]
    return vals, null if null.any() else None


class HostEvaluator:
    """Numpy interpreter for build subplans. Shares the channel-positional
    plan contract with the device executor but compacts rows freely (hosts
    have dynamic shapes). Raises ``Unsupported`` on anything outside its
    subset — callers degrade to no-DF, never to wrong answers."""

    def __init__(self, session, dyn_domains: Dict[Tuple[int, int], Domain]):
        self.session = session
        self.dyn_domains = dyn_domains
        # node.id -> HPage. Safe across collects: by resolve_dynamic_filters'
        # visit order, every domain that will ever target a scan inside a
        # subtree is resolved before any eval first touches that subtree, so
        # a subtree's result never changes between evaluations.
        self._memo: Dict[int, HPage] = {}

    # ------------------------------------------------------------- plan
    def eval(self, node: P.PlanNode) -> HPage:
        hit = self._memo.get(node.id)
        if hit is not None:
            return hit
        method = getattr(self, f"_eval_{type(node).__name__}", None)
        if method is None:
            raise Unsupported(type(node).__name__)
        out = method(node)
        self._memo[node.id] = out
        return out

    def _eval_TableScanNode(self, node: P.TableScanNode) -> HPage:
        from trino_tpu_torch.exec.executor import dynamic_domain_map

        conn = self.session.catalogs[node.catalog]
        td = node.constraint
        dyn = dynamic_domain_map(node, self.dyn_domains)
        if dyn:
            td = TupleDomain(dict(dyn)) if td is None else td.intersect(TupleDomain(dict(dyn)))
        # enumerate with the SAME adaptive target the staging tier will
        # use (exec/staging.target_split_count): phase-1 evaluation and
        # the staging loop then request identical split ranges, so the
        # generator-range cache (connector/gencache.py) fills here and
        # HITS there — mismatched boundaries would regenerate every
        # build-side table a second time at staging
        from trino_tpu_torch.exec import staging as _staging

        target = _staging.target_split_count(
            self.session, conn, node.schema, node.table,
            handle=node.table_handle)
        splits = conn.get_splits(node.schema, node.table, target,
                                 constraint=td, handle=node.table_handle)
        datas = [conn.scan(s, node.column_names, constraint=td) for s in splits]
        from trino_tpu_torch.connector.spi import concat_column_data

        cols: List[HCol] = []
        n_rows = None
        for name, typ in zip(node.column_names, node.column_types):
            parts = [d[name] for d in datas]
            cd = concat_column_data(parts) if parts else None
            if cd is None:
                cols.append(HCol(typ, np.empty(0, dtype=np.int64)))
                continue
            if typ.is_varchar:
                vals, nulls = _decode_varchar(cd)
            else:
                vals = np.asarray(cd.values)
                nulls = np.asarray(cd.nulls) if cd.nulls is not None else None
            n_rows = len(vals)
            cols.append(HCol(typ, vals, nulls))
        # engine-side enforcement of the dynamic part (connectors treat
        # constraints as advisory; monotone-key pushdown may have already
        # pruned most rows, this makes the narrowing exact)
        if dyn and n_rows:
            keep = np.ones(n_rows, dtype=bool)
            for name, dom in dyn.items():
                i = node.column_names.index(name)
                c = cols[i]
                if c.type.is_varchar:
                    continue
                keep &= domain_mask(dom, c.values, c.nulls)
            if not keep.all():
                cols = [c.take(keep) for c in cols]
        return HPage(cols)

    def _eval_FilterNode(self, node: P.FilterNode) -> HPage:
        page = self.eval(node.source)
        vals, valid, exact = self._expr(node.predicate, page)
        if not exact:
            raise Unsupported("filter over inexact input")
        mask = vals.astype(bool)
        if valid is not None:
            mask &= valid
        return page.take(mask)

    def _eval_ProjectNode(self, node: P.ProjectNode) -> HPage:
        page = self.eval(node.source)
        out: List[HCol] = []
        for e in node.expressions:
            if isinstance(e, ir.ColumnRef):
                out.append(page.cols[e.index])
                continue
            vals, valid, exact = self._expr(e, page)
            out.append(
                HCol(e.type, vals, None if valid is None else ~valid, exact)
            )
        return HPage(out)

    def _eval_CompactNode(self, node: P.CompactNode) -> HPage:
        return self.eval(node.source)  # host pages are always compact

    def _eval_ValuesNode(self, node: P.ValuesNode) -> HPage:
        cols = []
        for i, t in enumerate(node.types):
            pyvals = [r[i] for r in node.rows]
            if t.is_varchar:
                vals = np.asarray(
                    [v if v is not None else "" for v in pyvals], dtype=object)
            else:
                vals = np.asarray([v if v is not None else 0 for v in pyvals])
            nulls = np.asarray([v is None for v in pyvals])
            cols.append(HCol(t, vals, nulls if nulls.any() else None))
        return HPage(cols)

    def _eval_UnionNode(self, node: P.UnionNode) -> HPage:
        pages = [self.eval(s) for s in node.sources_]
        out: List[HCol] = []
        for ci in range(len(pages[0].cols)):
            parts = [p.cols[ci] for p in pages]
            vals = np.concatenate([np.asarray(c.values) for c in parts])
            if any(c.nulls is not None for c in parts):
                nulls = np.concatenate(
                    [c.nulls if c.nulls is not None
                     else np.zeros(len(c.values), bool) for c in parts])
            else:
                nulls = None
            out.append(HCol(parts[0].type, vals, nulls,
                            all(c.exact for c in parts)))
        return HPage(out)

    def _eval_SortNode(self, node: P.SortNode) -> HPage:
        return self.eval(node.source)  # row order is irrelevant to domains

    # ---------------------------------------------------------- aggregation
    def _eval_AggregationNode(self, node: P.AggregationNode) -> HPage:
        if node.step != "single":
            raise Unsupported("partial/final aggregation")
        page = self.eval(node.source)
        if not node.group_channels:
            return self._global_agg(node, page)
        dense = self._dense_group_agg(node, page)
        if dense is not None:
            return dense
        gid, uniq_idx, n_groups = self._group_ids(page, node.group_channels)
        out = [page.cols[c].take(uniq_idx) for c in node.group_channels]
        for a in node.aggregates:
            out.append(self._agg_call(a, page, gid, n_groups))
        return HPage(out)

    def _dense_group_agg(self, node: P.AggregationNode, page: HPage):
        """Single-int-key grouping via direct binning over the key RANGE —
        no sort, no gather. This is the per-run hot loop of phase 1 (Q18's
        HAVING subquery groups all of lineitem by orderkey every execution);
        dense ids = key - min make every aggregate one bincount/ufunc.at.
        Returns None when the shape doesn't fit (multi-key, nulls, sparse
        range, exotic aggregate) — the generic sort path handles those."""
        if len(node.group_channels) != 1:
            return None
        col = page.cols[node.group_channels[0]]
        k = np.asarray(col.values)
        if k.dtype.kind not in "iu" or k.size == 0:
            return None
        if col.nulls is not None and col.nulls.any():
            return None
        for a in node.aggregates:
            if a.distinct or a.function not in (
                    "count", "count_star", "sum", "min", "max", "avg"):
                return None
            if a.arg_channel is not None:
                ac = page.cols[a.arg_channel]
                if np.asarray(ac.values).dtype.kind not in "iuf":
                    return None
                if ac.nulls is not None and ac.nulls.any():
                    return None
        lo, hi = int(k.min()), int(k.max())
        span = hi - lo + 1
        if span > max(4 * k.size, 1 << 20):
            return None
        ids = k - lo
        counts = np.bincount(ids, minlength=span)
        present = counts > 0
        out = [HCol(col.type, (np.nonzero(present)[0] + lo).astype(k.dtype),
                    exact=col.exact)]
        for a in node.aggregates:
            fn = a.function
            if fn in ("count", "count_star"):
                out.append(HCol(a.output_type, counts[present].astype(np.int64)))
                continue
            ac = page.cols[a.arg_channel]
            vals = np.asarray(ac.values)
            if fn == "sum" and vals.dtype.kind in "iu":
                acc = np.zeros(span, dtype=np.int64)
                np.add.at(acc, ids, vals)
                out.append(HCol(a.output_type, acc[present], exact=ac.exact))
            elif fn in ("sum", "avg"):
                acc = np.zeros(span, dtype=np.float64)
                np.add.at(acc, ids, vals.astype(np.float64))
                v = acc[present] / counts[present] if fn == "avg" else acc[present]
                exact = False if fn == "avg" or vals.dtype.kind == "f" else ac.exact
                out.append(HCol(a.output_type, v, exact=exact))
            else:  # min / max
                op = np.minimum if fn == "min" else np.maximum
                if vals.dtype.kind == "f":
                    init = np.inf if fn == "min" else -np.inf
                    acc = np.full(span, init, dtype=np.float64)
                else:
                    ii = np.iinfo(vals.dtype)
                    init = ii.max if fn == "min" else ii.min
                    acc = np.full(span, init, dtype=vals.dtype)
                op.at(acc, ids, vals)
                out.append(HCol(a.output_type, acc[present], exact=ac.exact))
        return HPage(out)

    def _group_ids(self, page: HPage, channels):
        """(group id per row, representative row index per group, n_groups)."""
        keys = []
        for c in channels:
            col = page.cols[c]
            v = np.asarray(col.values)
            if col.nulls is not None:
                # NULL is its own group: (is_null, zeroed value) — the value
                # under a null slot is garbage and must not split the group
                keys.append(np.asarray(col.nulls))
                v = np.where(col.nulls, v.dtype.type(0) if v.dtype.kind != "U" else "", v)
            keys.append(v)
        if len(keys) == 1:
            uniq, uniq_idx, inv = np.unique(
                keys[0], return_index=True, return_inverse=True)
            return inv, uniq_idx, len(uniq)
        order = np.lexsort(keys[::-1])
        n = page.num_rows
        if n == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64), 0
        sorted_keys = [k[order] for k in keys]
        new_group = np.zeros(n, dtype=bool)
        new_group[0] = True
        for k in sorted_keys:
            new_group[1:] |= k[1:] != k[:-1]
        gid_sorted = np.cumsum(new_group) - 1
        gid = np.empty(n, dtype=np.int64)
        gid[order] = gid_sorted
        uniq_idx = order[new_group]
        return gid, uniq_idx, int(gid_sorted[-1]) + 1

    def _agg_call(self, a, page: HPage, gid, n_groups) -> HCol:
        if a.distinct or a.function not in ("count", "count_star", "sum",
                                            "min", "max", "avg"):
            raise Unsupported(f"aggregate {a.function}")
        if a.function == "count_star" or (a.function == "count" and a.arg_channel is None):
            cnt = np.bincount(gid, minlength=n_groups).astype(np.int64)
            return HCol(a.output_type, cnt)
        col = page.cols[a.arg_channel]
        live = np.ones(page.num_rows, bool) if col.nulls is None else ~col.nulls
        if a.function == "count":
            cnt = np.bincount(gid[live], minlength=n_groups).astype(np.int64)
            return HCol(a.output_type, cnt, exact=col.exact)
        vals, g = np.asarray(col.values)[live], gid[live]
        if vals.dtype.kind not in "iuf":
            raise Unsupported(f"{a.function} over {vals.dtype} column")
        present = np.bincount(g, minlength=n_groups) > 0
        nulls = None if present.all() else ~present
        if a.function == "sum":
            if np.issubdtype(vals.dtype, np.integer):
                acc = np.zeros(n_groups, dtype=np.int64)
                np.add.at(acc, g, vals.astype(np.int64))
                return HCol(a.output_type, acc, nulls, exact=col.exact)
            acc = np.zeros(n_groups, dtype=np.float64)
            np.add.at(acc, g, vals)
            return HCol(a.output_type, acc, nulls, exact=False)
        if a.function == "avg":
            cnt = np.bincount(g, minlength=n_groups)
            acc = np.zeros(n_groups, dtype=np.float64)
            np.add.at(acc, g, vals.astype(np.float64))
            return HCol(a.output_type, acc / np.maximum(cnt, 1), nulls, exact=False)
        # min / max via sorted reduceat-free extremes
        op = np.minimum if a.function == "min" else np.maximum
        init = vals.dtype.type(np.iinfo(vals.dtype).max if np.issubdtype(vals.dtype, np.integer) else np.inf)
        if a.function == "max":
            init = vals.dtype.type(np.iinfo(vals.dtype).min if np.issubdtype(vals.dtype, np.integer) else -np.inf)
        acc = np.full(n_groups, init)
        op.at(acc, g, vals)
        return HCol(a.output_type, acc, nulls, exact=col.exact)

    def _global_agg(self, node: P.AggregationNode, page: HPage) -> HPage:
        gid = np.zeros(page.num_rows, dtype=np.int64)
        out = [self._agg_call(a, page, gid, 1) for a in node.aggregates]
        return HPage(out)

    def eval_key_column(self, node: P.PlanNode, channel: int) -> HCol:
        """Values of one output channel of ``node``, join multiplicity
        IGNORED — exact for domain extraction (a domain is a value SET).
        Inner equi-joins reduce to a semi filter on the side carrying the
        channel, skipping the M:N expansion and the other side's gathers —
        the dominant phase-1 cost for large build sides."""
        if (isinstance(node, P.JoinNode) and node.join_type == "inner"
                and node.left_keys and node.filter is None
                and not node.singleton):
            nl = len(node.left.output_types)
            left = self.eval(node.left)
            right = self.eval(node.right)
            lkey, rkey = self._combined_key(
                left, node.left_keys, right, node.right_keys)
            if channel < nl:
                page, own, other, ch = left, lkey, rkey, channel
            else:
                page, own, other, ch = right, rkey, lkey, channel - nl
            keep = np.isin(np.asarray(own.values), other.live_values())
            if own.nulls is not None:
                keep &= ~own.nulls
            return page.cols[ch].take(keep)
        if isinstance(node, P.ProjectNode):
            e = node.expressions[channel]
            if isinstance(e, ir.ColumnRef):
                return self.eval_key_column(node.source, e.index)
        return self.eval(node).cols[channel]

    # --------------------------------------------------------------- joins
    def _eval_JoinNode(self, node: P.JoinNode) -> HPage:
        if node.singleton or not node.left_keys:
            raise Unsupported("cross/singleton join")
        if node.join_type not in ("inner", "semi", "anti", "left"):
            raise Unsupported(f"{node.join_type} join")
        left = self.eval(node.left)
        right = self.eval(node.right)
        lk = self._combined_key(left, node.left_keys, right, node.right_keys)
        lkey, rkey = lk
        if node.join_type in ("semi", "anti"):
            if node.filter is not None:
                raise Unsupported("filtered semi join")
            hit = np.isin(lkey.values, rkey.live_values())
            if lkey.nulls is not None:
                hit &= ~lkey.nulls
            return left.take(hit if node.join_type == "semi" else ~hit)
        # inner/left M:N sort-merge expansion
        l_idx, r_idx = _inner_match(lkey, rkey)
        joined = HPage(
            [c.take(l_idx) for c in left.cols] + [c.take(r_idx) for c in right.cols]
        )
        if node.filter is not None:
            vals, valid, exact = self._expr(node.filter, joined)
            if not exact:
                raise Unsupported("join filter over inexact input")
            mask = vals.astype(bool)
            if valid is not None:
                mask &= valid
            joined = joined.take(mask)
            l_idx = l_idx[mask]
        if node.join_type != "left":
            return joined
        # left outer: probe rows with no (filter-passing) match emit once
        # with NULL build columns
        matched = np.zeros(left.num_rows, bool)
        matched[l_idx] = True
        tail_idx = np.flatnonzero(~matched)
        tail_cols = [c.take(tail_idx) for c in left.cols] + [
            HCol(c.type, np.zeros(len(tail_idx), dtype=np.asarray(c.values).dtype),
                 np.ones(len(tail_idx), bool), c.exact)
            for c in right.cols
        ]
        out = []
        for jc, tc in zip(joined.cols, tail_cols):
            nulls = None
            if jc.nulls is not None or tc.nulls is not None:
                nulls = np.concatenate([
                    jc.nulls if jc.nulls is not None
                    else np.zeros(len(jc.values), bool),
                    tc.nulls if tc.nulls is not None
                    else np.zeros(len(tc.values), bool),
                ])
            out.append(HCol(jc.type, np.concatenate([jc.values, tc.values]),
                            nulls, jc.exact and tc.exact))
        return HPage(out)

    def _combined_key(self, left: HPage, lchs, right: HPage, rchs):
        """Reduce (possibly multi-column) join keys to one comparable array
        per side: single keys ride as-is; multi-keys densify each column over
        the union of both sides' values, then mix into one int64."""
        if len(lchs) == 1:
            return left.cols[lchs[0]], right.cols[rchs[0]]
        lcols = [left.cols[c] for c in lchs]
        rcols = [right.cols[c] for c in rchs]
        lmix = np.zeros(left.num_rows, dtype=np.int64)
        rmix = np.zeros(right.num_rows, dtype=np.int64)
        for lc, rc in zip(lcols, rcols):
            both = np.concatenate([np.asarray(lc.values), np.asarray(rc.values)])
            uniq, inv = np.unique(both, return_inverse=True)
            stride = len(uniq) + 1
            lmix = lmix * stride + inv[: left.num_rows]
            rmix = rmix * stride + inv[left.num_rows:]
        lnull = None
        for c in lcols:
            if c.nulls is not None:
                lnull = c.nulls if lnull is None else (lnull | c.nulls)
        rnull = None
        for c in rcols:
            if c.nulls is not None:
                rnull = c.nulls if rnull is None else (rnull | c.nulls)
        return (
            HCol(T.BIGINT, lmix, lnull),
            HCol(T.BIGINT, rmix, rnull),
        )

    # --------------------------------------------------------- expressions
    def _expr(self, e: ir.Expr, page: HPage):
        """-> (values ndarray, valid ndarray|None, exact bool). ``valid``
        True = non-null (matching expr_lower's LoweredVal convention)."""
        if isinstance(e, ir.Constant):
            n = page.num_rows
            if e.value is None:
                return np.zeros(n, np.int64), np.zeros(n, bool), True
            v = np.full(n, e.value)  # str constants infer '<U' dtype
            return v, None, True
        if isinstance(e, ir.ColumnRef):
            c = page.cols[e.index]
            valid = None if c.nulls is None else ~c.nulls
            return c.values, valid, c.exact
        if isinstance(e, ir.Cast):
            vals, valid, exact = self._expr(e.value, page)
            if e.type.is_floating:
                return vals.astype(np.float64), valid, exact
            if e.type.name in ("bigint", "integer", "date"):
                if np.issubdtype(np.asarray(vals).dtype, np.floating):
                    raise Unsupported("float->int cast (rounding semantics)")
                return vals.astype(np.int64), valid, exact
            raise Unsupported(f"cast to {e.type}")
        if isinstance(e, ir.Call):
            return self._call(e, page)
        raise Unsupported(type(e).__name__)

    _CMP = {
        "eq": np.equal, "ne": np.not_equal, "lt": np.less,
        "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal,
    }

    def _call(self, e: ir.Call, page: HPage):
        name = e.name
        if name in self._CMP:
            a, av, ax = self._expr(e.args[0], page)
            b, bv, bx = self._expr(e.args[1], page)
            a, b = _align_numeric(a, e.args[0].type, b, e.args[1].type)
            return self._CMP[name](a, b), _and_valid(av, bv), ax and bx
        if name in ("and", "or"):
            a, av, ax = self._expr(e.args[0], page)
            b, bv, bx = self._expr(e.args[1], page)
            # domain-collection filters only need Kleene-false = drop row:
            # treating NULL as false is exact for top-level conjunctions
            a = a.astype(bool) & (av if av is not None else True)
            b = b.astype(bool) & (bv if bv is not None else True)
            out = (a | b) if name == "or" else (a & b)
            return out, None, ax and bx
        if name == "not":
            a, av, ax = self._expr(e.args[0], page)
            return ~a.astype(bool), av, ax
        if name == "is_null":
            a, av, ax = self._expr(e.args[0], page)
            out = np.zeros(len(a), bool) if av is None else ~av
            return out, None, True
        if name == "between":
            v, lo, hi = (self._expr(a, page) for a in e.args)
            v1, lo1 = _align_numeric(v[0], e.args[0].type, lo[0], e.args[1].type)
            v2, hi2 = _align_numeric(v[0], e.args[0].type, hi[0], e.args[2].type)
            out = (v1 >= lo1) & (v2 <= hi2)
            return out, _and_valid(_and_valid(v[1], lo[1]), hi[1]), v[2] and lo[2] and hi[2]
        if name == "in_list":
            v, vv, vx = self._expr(e.args[0], page)
            consts = []
            for a in e.args[1:]:
                if not isinstance(a, ir.Constant) or a.value is None:
                    raise Unsupported("non-literal IN list")
                cv, _, _ = self._expr(a, page)
                v2, cv = _align_numeric(v, e.args[0].type, cv, a.type)
                consts.append(cv[:1])
            return np.isin(v2, np.concatenate(consts)), vv, vx
        if name in ("add", "sub", "mul"):
            a, av, ax = self._expr(e.args[0], page)
            b, bv, bx = self._expr(e.args[1], page)
            op = {"add": np.add, "sub": np.subtract, "mul": np.multiply}[name]
            # decimal arithmetic has result-scale/rounding semantics
            # (expr_lower._rescale_decimal) not reproduced here — inexact
            exact = ax and bx and not e.type.is_decimal
            return op(a, b), _and_valid(av, bv), exact
        if name == "negate":
            a, av, ax = self._expr(e.args[0], page)
            return -a, av, ax
        if name == "div":
            a, av, ax = self._expr(e.args[0], page)
            b, bv, bx = self._expr(e.args[1], page)
            with np.errstate(divide="ignore", invalid="ignore"):
                out = np.asarray(a, dtype=np.float64) / np.asarray(b, np.float64)
            # float elementwise div is IEEE-exact; decimal/int division has
            # engine rounding semantics we do not reproduce here
            exact = ax and bx and e.type.is_floating
            return out, _and_valid(av, bv), exact
        if name == "extract_year":
            a, av, ax = self._expr(e.args[0], page)
            y = a.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970
            return y, av, ax
        if name == "extract_month":
            a, av, ax = self._expr(e.args[0], page)
            d = a.astype("datetime64[D]")
            m = (d.astype("datetime64[M]").astype(np.int64) % 12) + 1
            return m, av, ax
        if name == "coalesce":
            out_v, out_valid, exact = None, None, True
            for arg in e.args:
                v, valid, ax = self._expr(arg, page)
                exact = exact and ax
                if out_v is None:
                    out_v = np.array(v)
                    out_valid = np.ones(len(v), bool) if valid is None else valid.copy()
                else:
                    fill = ~out_valid
                    out_v[fill] = v[fill]
                    out_valid[fill] = True if valid is None else valid[fill]
            return out_v, out_valid, exact
        raise Unsupported(f"call {name}")


def _align_numeric(av, at: T.Type, bv, bt: T.Type):
    """Mirror of ops/expr_lower._numeric_align (the device comparison
    semantics) in numpy: decimals compare at the max scale, mixed
    float/decimal at float64 — host and device must agree bit-for-bit."""
    if at.is_varchar or bt.is_varchar:
        return av, bv
    if at.is_decimal or bt.is_decimal:
        sa = at.scale if getattr(at, "scale", None) is not None and at.is_decimal else 0
        sb = bt.scale if getattr(bt, "scale", None) is not None and bt.is_decimal else 0
        if at.is_floating or bt.is_floating:
            fa = av / (10.0 ** sa) if at.is_decimal else av
            fb = bv / (10.0 ** sb) if bt.is_decimal else bv
            return np.asarray(fa, np.float64), np.asarray(fb, np.float64)
        s = max(sa, sb)
        return (
            np.asarray(av, np.int64) * (10 ** (s - sa)),
            np.asarray(bv, np.int64) * (10 ** (s - sb)),
        )
    if at.is_floating != bt.is_floating:
        return np.asarray(av, np.float64), np.asarray(bv, np.float64)
    return av, bv


def _and_valid(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _inner_match(lkey: HCol, rkey: HCol):
    """Sort-merge M:N inner-join row indices (null keys never match)."""
    lv, rv = np.asarray(lkey.values), np.asarray(rkey.values)
    l_live = np.arange(len(lv)) if lkey.nulls is None else np.nonzero(~lkey.nulls)[0]
    r_live = np.arange(len(rv)) if rkey.nulls is None else np.nonzero(~rkey.nulls)[0]
    lv, rv = lv[l_live], rv[r_live]
    order = np.argsort(rv, kind="stable")
    rs = rv[order]
    lo = np.searchsorted(rs, lv, "left")
    hi = np.searchsorted(rs, lv, "right")
    counts = hi - lo
    total = int(counts.sum())
    l_idx = np.repeat(np.arange(len(lv)), counts)
    starts = np.cumsum(counts) - counts  # exclusive prefix, empty-safe
    r_pos = np.arange(total) - np.repeat(starts, counts) + np.repeat(lo, counts)
    return l_live[l_idx], r_live[order[r_pos]]


def resolve_dynamic_filters(session, root: P.PlanNode) -> Dict[Tuple[int, int], Domain]:
    """Phase 1: host-evaluate every DF-producing join's build side and return
    {(join_id, key_index): Domain} for the staged-scan narrowing of phase 2.
    Joins whose build subplan the host evaluator cannot reproduce exactly are
    skipped (their probe scans simply stay unnarrowed).

    Ordering mirrors the eager executor's build-before-probe recursion: at
    each join the BUILD subtree resolves (and this join's domain is
    collected) before the PROBE subtree is visited, so scans inside the
    probe subtree — including build sides of nested joins there, e.g. the
    orders side of Q3's (lineitem ⨝ orders) under the customer join — see
    every enclosing join's domain before they are evaluated."""
    props = getattr(session, "properties", None) or {}
    if not props.get("dynamic_filtering_enabled", True):
        return {}
    domains: Dict[Tuple[int, int], Domain] = {}
    ev = HostEvaluator(session, domains)

    def collect(join: P.JoinNode) -> None:
        for i in join.dyn_filter_keys:
            try:
                col = ev.eval_key_column(join.right, join.right_keys[i])
            except Unsupported:
                continue
            if col.type.is_varchar or not col.exact:
                continue
            lv = col.live_values()
            if len(lv) == 0:
                dom = Domain(values=frozenset())
            elif len(lv) <= PHASE1_MAX_SET:
                dom = Domain.from_values(np.unique(lv))  # caches sorted array
                # an exact in-set domain means every surviving probe row has
                # >= 1 build match: the join's match-fraction estimate is 1
                join.df_exact = True
            else:
                dom = Domain.range(low=lv.min().item(), high=lv.max().item())
            domains[(join.id, i)] = dom

    def visit(node: P.PlanNode) -> None:
        if isinstance(node, P.JoinNode):
            visit(node.right)  # nested DF joins inside the build side first
            if node.dyn_filter_keys:
                collect(node)
            visit(node.left)  # probe subtree sees this join's domain
            return
        for s in node.sources:
            visit(s)

    visit(root)
    return domains
