"""SPMD execution over a mesh: the port of trino_tpu/parallel/spmd.py.

Reference: the distributed data plane (splits scheduled across workers,
hash-repartition shuffles between stages). The reference compiles the
whole multi-stage pipeline into one ``shard_map`` program over a device
mesh; here every rank of a :class:`~trino_tpu_torch.parallel.mesh.Mesh`
runs the same plan (the executor with ``eager_tier`` off, as the compiled
tier's body), captured on CUDA into graph segments cut at its collectives
and replayed (:class:`DistributedQuery`), and the exchanges are the
mesh's collectives:

- leaf scans = data-parallel splits, one shard a rank (padded to a common
  shape; the pad rows carry sel=False) — SOURCE_DISTRIBUTION;
- low-cardinality aggregation = local partial aggregate, ``all_gather`` of
  the small partial-state pages, local final aggregate;
- high-cardinality aggregation = hash-repartition raw rows by group key
  (``all_to_all``, parallel/exchange.py), aggregate locally, keep the
  result sharded;
- join build sides: ``all_gather`` (broadcast) when small, else
  co-partition both sides by key hash and join locally, by the same stats
  predicates (sql/planner/stats.py) that size the exchange hints;
- sort/top-N/limit: per-shard top-N gathered, or a range exchange by
  sampled splitters for a big ORDER BY.

Every rank must make the same sequence of collective calls. ``shard_map``
gets that from tracing one program; here each choice that leads to a
collective comes from the plan, the stats, the capacity hints, the
``replicated`` flags or the static shapes, which padding makes equal on
every rank, or from a value all ranks agree on (the all-reduced error
flags). No rank's own data decides one. A divergence would block in a
collective until the group's timeout; one that only changes a step's
bytes fails the compiling run's schedule check (``Comm.agree``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time as _time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from trino_tpu_torch.connector import spi as spi_mod
from trino_tpu_torch.data import page as page_mod
from trino_tpu_torch.data.page import Column, ConstantStore, Page, constant_store
from trino_tpu_torch.exec.executor import Executor, QueryError, _col_to_lowered
from trino_tpu_torch.exec.page_tree import ColSpec, PageSpec, flatten_page, unflatten_page
from trino_tpu_torch.parallel.mesh import RankProgram, Step
from trino_tpu_torch.sql.planner import plan as P


def gather_page(page: Page, comm) -> Page:
    """Replicate a sharded page on every rank (broadcast exchange): one
    all-gather of every array. Idempotent: replicated pages pass
    through."""
    if page.replicated:
        return page
    arrays = []
    for c in page.columns:
        if c.type.is_nested:
            raise NotImplementedError("device gather over nested columns")
        arrays.extend(a for a in (c.values, c.nulls, c.hi) if a is not None)
    if page.sel is not None:
        arrays.append(page.sel)
    it = iter(comm.all_gather(arrays))
    cols = []
    for c in page.columns:
        vals = next(it)
        nulls = next(it) if c.nulls is not None else None
        hi = next(it) if c.hi is not None else None
        cols.append(Column(c.type, vals, nulls, c.dictionary, c.vrange, hi=hi))
    sel = next(it) if page.sel is not None else None
    return Page(cols, sel, replicated=True)


class SpmdExecutor(Executor):
    """One rank's executor: the plan over this rank's shards, exchanges
    through ``comm``.

    Distribution choice a exchange (reference: AddExchanges +
    DetermineJoinDistributionType): broadcast (all_gather) for small build
    sides and low-cardinality aggregations, hash repartition (all_to_all)
    when stats say the data is too big to replicate; the same predicates
    size the capacity hints at build time, so every exchange finds its
    hint."""

    eager_tier = False  # no host read decides a shape: ranks stay in step
    collect_stats = False  # the ranks' stats would be per shard

    def __init__(self, session, staged: Dict[int, Page], capacity_hints, comm):
        super().__init__(session, capacity_hints=capacity_hints)
        # the scans were staged under phase 1's domains before the run
        self.enable_dynamic_filtering = False
        self.staged = staged
        self.comm = comm
        self.n_devices = comm.size
        self.device = comm.device

    def _exec_TableScanNode(self, node: P.TableScanNode) -> Page:
        return self.staged[node.id]

    # ------------------------------------------------------ hash exchange
    def _repartition(self, page: Page, key_channels, hint_key: str) -> Page:
        from trino_tpu_torch.parallel import exchange

        page = self._narrowed_for_exchange(page)
        capacity = self.hint_capacity(hint_key, None)
        out, overflow = exchange.repartition_page(
            page, key_channels, self.n_devices, capacity, self.comm)
        self.errors.append((f"CAPACITY_EXCEEDED:{hint_key}", overflow))
        return out

    def _join_repartitioned(self, node: P.JoinNode, left: Page, right: Page):
        """Co-partition both join sides by key hash when stats prefer it and
        neither side is replicated; None falls back to the broadcast."""
        from trino_tpu_torch.sql.planner import stats

        if left.replicated or right.replicated:
            return None
        if not stats.join_repartitions(self.session, node, self.n_devices):
            return None
        left2 = self._repartition(left, node.left_keys, f"xchgl:{node.id}")
        right2 = self._repartition(right, node.right_keys, f"xchgr:{node.id}")
        return left2, right2

    # ----------------------------------------------------- distributed agg
    def aggregate_page(self, node: P.AggregationNode, page: Page) -> Page:
        """Low cardinality: partial aggregate, all_gather of the partial
        states, final combine. High cardinality: hash-repartition the raw
        rows by group key and aggregate single-step locally, the output
        sharded. DISTINCT aggregates cannot split: gather the raw rows and
        aggregate single-step."""
        from trino_tpu_torch.sql.planner import stats

        if page.replicated:
            # every rank holds all rows: single-step local aggregate
            return super().aggregate_page(node, page)
        if stats.agg_repartitions(self.session, node, self.n_devices):
            page2 = self._repartition(page, node.group_channels, f"xchg:{node.id}")
            return Executor.aggregate_page(self, node, page2)  # sharded out
        if not P.can_split_aggs(node.aggregates):
            return super().aggregate_page(node, gather_page(page, self.comm))
        partial = self.aggregate_partial(node, page)
        gathered = gather_page(partial, self.comm)
        final = P.AggregationNode(
            None, list(range(len(node.group_channels))), node.aggregates,
            step="final", names=node.names,
        )
        out = self.aggregate_final(final, gathered)
        return Page(out.columns, out.sel, replicated=True)

    # -------------------------------------------------- distributed joins
    def _overlap_blocks(self) -> int:
        return int(self.props.get("exchange_overlap_blocks", 0) or 0)

    def _narrowed_for_exchange(self, page: Page) -> Page:
        """Two-limb columns degrade to their low words, with the deferred
        overflow check, before any exchange (no limb lanes)."""
        if not any(c.hi is not None for c in page.columns):
            return page
        return Page([self._narrowed_or_flag(c, page.sel) for c in page.columns],
                    page.sel, page.replicated, live_prefix=page.live_prefix)

    def _overlapped_join(self, node: P.JoinNode, left: Page, right: Page,
                         semi: bool) -> Optional[Page]:
        """Partitioned lookup/semi join with the probe side's exchange
        pipelined against the join: the build side co-partitions first,
        then the probe side ships in ``exchange_overlap_blocks`` blocks,
        block k+1's all-to-all in flight while block k is joined. The
        build artifacts (the dense table or the sorted build) are made once,
        outside the per-block consume. Bit-identical to the one-shot path:
        the consume is row-local and the blocks restack to its row order.
        None when the pipeline does not apply (off, broadcast distribution,
        replicated inputs, the fused tier off)."""
        from trino_tpu_torch.obs import metrics as M
        from trino_tpu_torch.obs import trace as tracing
        from trino_tpu_torch.ops import join as join_ops
        from trino_tpu_torch.parallel import exchange
        from trino_tpu_torch.sql.planner import stats

        blocks = self._overlap_blocks()
        if blocks <= 1 or left.replicated or right.replicated:
            return None
        if not self._fused_join_enabled():
            # the per-block consume rides the fused module's merge tier:
            # the fused kill switch turns the pipeline off too
            return None
        if not stats.join_repartitions(self.session, node, self.n_devices):
            return None
        right2 = self._repartition(right, node.right_keys, f"xchgr:{node.id}")
        left = self._narrowed_for_exchange(left)
        capacity = self.hint_capacity(f"xchgl:{node.id}", None)
        dense = self._dense_join_cols(node, left, right2)
        table = lut = build = None
        if dense is not None:
            bc, _pc, lo, span = dense
            if semi:
                lut = join_ops.dense_membership_table(
                    _col_to_lowered(bc), right2.sel, lo, span)
            else:
                table = join_ops.dense_unique_table(
                    _col_to_lowered(bc), right2.sel, lo, span)
            self._count_tier("dense")
        else:
            bk, _pk = self._join_keys_aligned(left, right2, node.left_keys, node.right_keys)
            build = join_ops.build_side(
                bk, right2.sel, presorted=self._build_presorted(right2, node.right_keys))
        recorded = [False]  # the first block records the merge-tier selection

        def consume(lp: Page) -> Page:
            if dense is not None:
                lo = dense[2]
                plowered = _col_to_lowered(lp.columns[node.left_keys[0]])
                if semi:
                    hit = join_ops.dense_membership_probe(lut, plowered, lo)
                else:
                    rows, matched = join_ops.dense_probe_unique(table, plowered, lo)
            else:
                bkeys, pkeys = self._join_keys_aligned(
                    lp, right2, node.left_keys, node.right_keys)
                rows, matched = self._merge_sorted_tier(
                    node, lp, right2, build, bkeys, pkeys, record=not recorded[0])
                recorded[0] = True
                hit = matched
            if semi:
                keep = hit if node.join_type == "semi" else ~hit
                sel = keep if lp.sel is None else lp.sel & keep
                return Page(lp.columns, sel, lp.replicated)
            return self._assemble_lookup_output(node, lp, right2, rows, matched)

        with tracing.span("exchange/overlap") as sp:
            sp.set("blocks", blocks)
            sp.set("join", node.id)
            out, overflow = exchange.repartition_page_overlapped(
                left, node.left_keys, self.n_devices, capacity, self.comm, blocks, consume)
        self.errors.append((f"CAPACITY_EXCEEDED:xchgl:{node.id}", overflow))
        if self.count_tiers:
            M.EXCHANGE_OVERLAPPED.inc(1, str(blocks))
        return out

    def lookup_join(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        out = self._overlapped_join(node, left, right, semi=False)
        if out is not None:
            return out
        rp = self._join_repartitioned(node, left, right)
        if rp is not None:
            return Executor.lookup_join(self, node, *rp)
        # broadcast exchange: replicate the (small, unique-keyed) build side
        return super().lookup_join(node, left, gather_page(right, self.comm))

    def semi_join(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        out = self._overlapped_join(node, left, right, semi=True)
        if out is not None:
            return out
        rp = self._join_repartitioned(node, left, right)
        if rp is not None:
            return Executor.semi_join(self, node, *rp)
        return super().semi_join(node, left, gather_page(right, self.comm))

    def singleton_cross(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        return super().singleton_cross(node, left, gather_page(right, self.comm))

    def expand_join(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        rp = self._join_repartitioned(node, left, right)
        if rp is not None:
            return Executor.expand_join(self, node, *rp)
        # M:N expansion probes stay local against a broadcast build; the
        # stats-sized hint bounds every shard's match count (a probe shard
        # is a subset of all probes)
        return super().expand_join(node, left, gather_page(right, self.comm))

    def semi_join_filtered(self, node: P.JoinNode, left: Page, right: Page) -> Page:
        rp = self._join_repartitioned(node, left, right)
        if rp is not None:
            return Executor.semi_join_filtered(self, node, *rp)
        return super().semi_join_filtered(node, left, gather_page(right, self.comm))

    # ----------------------------------------------------------- set ops
    def _exec_UnionNode(self, node) -> Page:
        """UNION ALL of shards is the union of per-shard concatenations,
        unless the branches' replication differs, where a local concat
        would multiply the replicated side: then gather everything."""
        pages = [self.execute(s) for s in node.sources_]
        if len({p.replicated for p in pages}) > 1:
            pages = [gather_page(p, self.comm) for p in pages]
        out = pages[0]
        for p in pages[1:]:
            out = Page.concat_pages(out, p)
        return out

    def set_op_pages(self, node, left: Page, right: Page) -> Page:
        """Whole-row membership needs equal rows co-located: big inputs
        co-partition by a hash of every column (NULLs hash to one constant,
        so the set semantics' NULL equality survives), the side tag riding
        the exchange as a column. Small inputs gather."""
        from trino_tpu_torch import types as T
        from trino_tpu_torch.sql.planner import stats

        if (left.replicated or right.replicated
                or not stats.setop_repartitions(self.session, node, self.n_devices)):
            return super().set_op_pages(node, gather_page(left, self.comm),
                                        gather_page(right, self.comm))
        both = Page.concat_pages(left, right)
        side = torch.arange(both.num_rows, dtype=torch.int32,
                            device=self.device) >= left.num_rows
        tagged = Page(both.columns + [Column(T.BOOLEAN, side)], both.sel, both.replicated)
        recv = self._repartition(tagged, list(range(len(both.columns))), f"xchgs:{node.id}")
        body = Page(recv.columns[:-1], recv.sel, recv.replicated)
        return self._set_op_grouped(node, body, recv.columns[-1].values)

    # --------------------------------------------------- distributed sort
    def _exec_TopNNode(self, node: P.TopNNode) -> Page:
        """Per-shard top-N (the global top-N lies in the union of the
        shards' top-Ns), all_gather of the N x ranks survivors, a final
        local sort."""
        page = self.execute(node.source)
        if page.replicated:
            return Executor.sorted_page(self, page, node.sort_channels, node.count)
        local = Executor.sorted_page(self, page, node.sort_channels, node.count)
        gathered = gather_page(_take_prefix(local, node.count), self.comm)
        return Executor.sorted_page(self, gathered, node.sort_channels, node.count)

    def _exec_LimitNode(self, node: P.LimitNode) -> Page:
        """LIMIT without ordering: any N rows qualify; take N a shard and
        gather only those."""
        page = self.execute(node.source)
        if page.replicated:
            return Executor.sorted_page(self, page, [], node.count)
        local = Executor.sorted_page(self, page, [], node.count)
        gathered = gather_page(_take_prefix(local, node.count), self.comm)
        return Executor.sorted_page(self, gathered, [], node.count)

    def _exec_SortNode(self, node: P.SortNode) -> Page:
        """Full ORDER BY: big inputs range-partition by sampled splitters
        and sort locally; the output stays sharded, globally ordered by
        rank (the gather at the root concatenates in rank order). Small
        inputs gather and sort locally."""
        from trino_tpu_torch.sql.planner import stats

        page = self.execute(node.source)
        if page.replicated or not stats.sort_repartitions(
                self.session, node.source, self.n_devices):
            return Executor.sorted_page(self, gather_page(page, self.comm),
                                        node.sort_channels)
        recv = self._range_exchange(page, node.sort_channels, f"xchgo:{node.id}")
        return Executor.sorted_page(self, recv, node.sort_channels)

    SORT_SAMPLES_PER_SHARD = 32

    def _range_exchange(self, page: Page, sort_channels, hint_key: str) -> Page:
        """Route rows to ranks by lexicographic comparison against sampled
        splitters, so rank d receives exactly the d-th key range:
        evenly spaced samples of each shard's sorted live keys, gathered
        and sorted, give the splitters (sample sort); skew beyond the
        capacity hint doubles it and runs again."""
        from trino_tpu_torch.ops import ranks
        from trino_tpu_torch.ops import sort as sort_ops
        from trino_tpu_torch.parallel import exchange

        n = page.num_rows
        live = page.sel if page.sel is not None else torch.ones(
            (n,), dtype=torch.bool, device=self.device)
        keys = [((page.columns[c].values,
                  None if page.columns[c].nulls is None else ~page.columns[c].nulls),
                 asc, nf)
                for c, asc, nf in sort_channels]
        t_ops = sort_ops._sort_operands(keys, None)  # ascending-comparable
        # local live-first key sort -> evenly spaced live samples
        s_ops = ranks.lex_sort([~live] + t_ops)[0][1:]
        nlive = torch.clamp(live.sum(dtype=torch.int32), min=1)
        m = self.SORT_SAMPLES_PER_SHARD
        pos = torch.clamp(
            ((torch.arange(m, dtype=torch.int32, device=self.device) * 2 + 1) * nlive)
            // (2 * m), 0, n - 1).long()
        gathered = self.comm.all_gather([o[pos] for o in s_ops])
        gsorted = ranks.lex_sort(gathered)[0]
        total = m * self.n_devices
        sp_pos = (torch.arange(1, self.n_devices, dtype=torch.int64, device=self.device)
                  * total) // self.n_devices
        splitters = [g[sp_pos] for g in gsorted]
        # pid = the number of splitters the row is lexicographically
        # greater than (ties co-locate on the lower rank)
        pid = torch.zeros((n,), dtype=torch.int32, device=self.device)
        for d in range(self.n_devices - 1):
            gt = torch.zeros((n,), dtype=torch.bool, device=self.device)
            eq = torch.ones((n,), dtype=torch.bool, device=self.device)
            for o, sp in zip(t_ops, splitters):
                gt = gt | (eq & (o > sp[d]))
                eq = eq & (o == sp[d])
            pid = pid + gt.to(torch.int32)
        capacity = self.hint_capacity(hint_key, None)
        out, overflow = exchange.repartition_by_pid(
            page, pid, self.n_devices, capacity, self.comm)
        self.errors.append((f"CAPACITY_EXCEEDED:{hint_key}", overflow))
        return out

    def sorted_page(self, page: Page, sort_channels, limit=None) -> Page:
        return super().sorted_page(gather_page(page, self.comm), sort_channels, limit)

    def window_over_page(self, node, page: Page) -> Page:
        """Windows need whole partitions co-located: big partitioned inputs
        hash-repartition by the PARTITION BY keys; global frames (no
        partition keys) and small inputs gather."""
        from trino_tpu_torch.sql.planner import stats

        if (page.replicated
                or not stats.window_repartitions(self.session, node, self.n_devices)):
            return super().window_over_page(node, gather_page(page, self.comm))
        recv = self._repartition(page, node.partition_channels, f"xchgw:{node.id}")
        return Executor.window_over_page(self, node, recv)


def _take_prefix(page: Page, k: int) -> Page:
    """The first k slots of a page (a static slice: sorted pages hold
    their live rows as a prefix)."""
    k = min(k, page.num_rows)
    return Page(
        [Column(c.type, c.values[:k], None if c.nulls is None else c.nulls[:k],
                c.dictionary, c.vrange, hi=None if c.hi is None else c.hi[:k])
         for c in page.columns],
        page.sel[:k] if page.sel is not None else None,
        page.replicated,
    )


# --------------------------------------------------------------- staging
def stage_sharded_scans(session, root: P.OutputNode, mesh, dyn_domains=None,
                        profile=None):
    """Every scan's splits staged as ``mesh.size`` shards, padded to one
    length: ``({scan id: [arrays of rank r for each rank]}, {scan id:
    PageSpec})``. This is the SOURCE_DISTRIBUTION split assignment done
    statically. ``dyn_domains`` are phase 1's dynamic-filter domains
    (exec/host_eval.py): probe splits are enumerated and row-filtered
    under them before any rank sees them. A rank's shard lands on its
    device through ``exec/staging.blocked_transfer``; shards of ranks
    another process runs stay in host memory.

    Each scan consults the device table cache (devcache/) first; the
    ``spmd:<n>`` shard of the key pins the mesh width, so a cache built
    for one mesh width never serves another."""
    from trino_tpu_torch import devcache
    from trino_tpu_torch.exec.executor import dynamic_domain_map, scan_constraint_with
    from trino_tpu_torch.exec import staging as _staging
    from trino_tpu_torch.obs import metrics as _M
    from trino_tpu_torch.obs import trace as _tracing

    n_devices = mesh.size
    dyn_domains = dyn_domains or {}
    staged: Dict[int, List[List[torch.Tensor]]] = {}
    specs: Dict[int, PageSpec] = {}
    for node in P.walk_plan(root):
        if not isinstance(node, P.TableScanNode):
            continue
        constraint = scan_constraint_with(node, dyn_domains)

        def load(node=node, constraint=constraint):
            arrays, spec, total_rows = _stage_scan_shards(
                session, node, n_devices, constraint, dyn_domains, profile)
            t0 = _time.perf_counter()
            shards = []
            with _tracing.span("staging/transfer", table=node.table) as sp:
                for r in range(n_devices):
                    if r in mesh.local:
                        xfer = _staging.blocked_transfer(mesh.devices[r])
                        shards.append([xfer(a[r]) for a in arrays])
                    else:
                        shards.append([torch.from_numpy(np.ascontiguousarray(a[r]))
                                       for a in arrays])
                sp.set("arrays", len(arrays))
            _M.STAGING_PHASE_SECONDS.inc(_time.perf_counter() - t0, "transfer")
            nbytes = sum(int(t.numel()) * t.element_size()
                         for arrs in shards for t in arrs if t.device.type != "cpu")
            return (shards, spec, total_rows), total_rows, nbytes, n_devices

        ent, _disposition = devcache.cached_stage(
            session, node, constraint, dynamic_domain_map(node, dyn_domains),
            f"spmd:{n_devices}", load)
        shards, spec, total_rows = ent.value
        staged[node.id] = shards
        specs[node.id] = spec
        node.runtime_rows = total_rows  # staged truth for capacity estimates
    return staged, specs


def _stage_scan_shards(session, node, n_devices: int, constraint, dyn_domains,
                       profile=None):
    """Stage ONE scan's shards on the host: ``(stacked arrays [n_devices,
    rows], PageSpec, total_rows)``, the cold path behind the device-cache
    loader. Split reads run through the pipelined engine
    (exec/staging.py): big tables fan out finer than the mesh (contiguous
    groups of splits a rank), every split consults the host-RAM tier, and
    scans overlap on the shared pool."""
    from trino_tpu_torch.exec import staging
    from trino_tpu_torch.exec.executor import apply_dynamic_domains, dynamic_domain_map

    if any(t.is_nested for t in node.column_types):
        raise NotImplementedError("array/map columns in a sharded scan")
    conn = session.catalogs[node.catalog]
    target = staging.target_split_count(
        session, conn, node.schema, node.table, floor=n_devices,
        handle=node.table_handle)
    splits = conn.get_splits(node.schema, node.table, target, constraint=constraint,
                             handle=node.table_handle)

    def prune(datas):
        return apply_dynamic_domains(node, dyn_domains, datas)

    split_datas, prof = staging.stage_splits(
        session, node, conn, splits, constraint, prune=prune,
        applied_domains=dynamic_domain_map(node, dyn_domains))
    if profile is not None:
        profile["df_apply_s"] = profile.get("df_apply_s", 0.0) + prof.prune_s
    # contiguous split groups a rank: with <= n_devices splits, split i
    # stages on rank i; finer split sets group into n_devices contiguous
    # covers, so each shard reads an ascending key range
    if len(split_datas) <= n_devices:
        groups = [[split_datas[i]] if i < len(split_datas) else []
                  for i in range(n_devices)]
    else:
        bounds = [len(split_datas) * i // n_devices for i in range(n_devices + 1)]
        groups = [split_datas[bounds[i]:bounds[i + 1]] for i in range(n_devices)]
    total_rows = 0
    shard_cols = []
    for di in range(n_devices):
        group = [d for d in groups[di] if d]
        if group:
            data = group[0] if len(group) == 1 else {
                name: spi_mod.concat_column_data([g[name] for g in group])
                for name in node.column_names
            }
            if data:
                total_rows += len(next(iter(data.values())).values)
        else:
            # ranks beyond the split count scan nothing: empty columns from
            # the scan node's own schema, no connector round trip (a
            # synthetic empty split would lose or re-run a pushdown handle)
            data = {name: page_mod.column_data_from_python(typ, [])
                    for name, typ in zip(node.column_names, node.column_types)}
        cols = []
        for name, typ in zip(node.column_names, node.column_types):
            cd = data[name]
            vals = np.asarray(cd.values)
            # the physical narrowing of staging: table-wide ranges keep
            # every shard's dtype alike
            if vals.dtype == np.int64 and page_mod.fits_int32(cd.vrange):
                vals = vals.astype(np.int32)
            cols.append(spi_mod.ColumnData(
                typ, vals, np.asarray(cd.nulls) if cd.nulls is not None else None,
                cd.dictionary, cd.vrange, hi=np.asarray(cd.hi) if cd.hi is not None else None))
        shard_cols.append(cols)
    max_rows = max(max((len(c[0].values) if c else 0) for c in shard_cols), 1)
    # one dictionary a column across shards: a code means the same string
    # on every rank
    for ci, typ in enumerate(node.column_types):
        if not typ.is_varchar:
            continue
        merged = shard_cols[0][ci].dictionary
        for p in shard_cols[1:]:
            if p[ci].dictionary.values != merged.values:
                merged = merged.merge(p[ci].dictionary)
        for p in shard_cols:
            d = p[ci].dictionary
            codes = p[ci].values
            if d.values != merged.values:
                table = np.asarray(d.recode_table(merged))
                codes = np.where(codes >= 0, table[np.clip(codes, 0, None)],
                                 -1).astype(np.int32)
            p[ci] = spi_mod.ColumnData(typ, codes, p[ci].nulls, merged)
    arrays: List[np.ndarray] = []
    col_specs = []
    for ci, typ in enumerate(node.column_types):
        anyhi = any(p[ci].hi is not None for p in shard_cols)
        vals = np.stack([_pad(p[ci].values.astype(np.int64) if anyhi else p[ci].values,
                              max_rows) for p in shard_cols])
        anynull = any(p[ci].nulls is not None for p in shard_cols)
        nulls = np.stack([
            _pad(p[ci].nulls if p[ci].nulls is not None
                 else np.zeros(len(p[ci].values), bool), max_rows)
            for p in shard_cols]) if anynull else None
        # the high limb is on every shard or none (the spec is one for all
        # ranks): shards without one sign-extend their low words
        hi = np.stack([
            _pad(p[ci].hi if p[ci].hi is not None
                 else (p[ci].values.astype(np.int64) >> 63), max_rows)
            for p in shard_cols]) if anyhi else None
        arrays.append(vals)
        if nulls is not None:
            arrays.append(nulls)
        if hi is not None:
            arrays.append(hi)
        col_specs.append(ColSpec(typ, shard_cols[0][ci].dictionary, nulls is not None,
                                 shard_cols[0][ci].vrange, has_hi=hi is not None))
    arrays.append(np.stack([np.arange(max_rows) < len(p[0].values) if p
                            else np.zeros(max_rows, bool) for p in shard_cols]))
    return arrays, PageSpec(col_specs, True), total_rows


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    if len(a) == n:
        return a
    pad = np.zeros((n - len(a),) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad])


# ----------------------------------------------------------------- query
@dataclasses.dataclass
class DistributedQuery:
    """One query over a mesh: built once (phase 1, sharded staging, hints),
    then each ``run()`` runs the plan on every rank.

    On CUDA the first ``run()`` compiles the query, the counterpart of the
    reference's ``jax.jit(shard_map(per_shard))``: each rank runs the body
    eagerly on its own stream (the warm-up: it fills the rank's
    ``ConstantStore`` and records the rank's schedule of collectives,
    which every rank must agree on step for step), then captures the same
    body as CUDA graph segments cut at its collectives
    (parallel/mesh.py ``RankProgram``) and replays them. Every later run
    replays: no ``SpmdExecutor`` is built and no plan node visited, and the
    one host read is the all-reduced error flags. A capacity overflow drops
    every rank's graphs and pool, doubles the hint and compiles again (a
    warm-up whose flags fired is not captured). The staged shards are the
    graphs' inputs at fixed addresses, held for the query's lifetime.

    On the CPU, which only the tests ask for, nothing is captured: every
    run executes the body eagerly and records each rank's schedule. On
    CUDA a failed capture or a schedule mismatch raises; it never falls
    back to eager execution."""

    mesh: object
    session: object
    root: P.OutputNode
    staged: Dict[int, List[List[torch.Tensor]]]
    specs: Dict[int, PageSpec]
    capacity_hints: Dict[str, int] = dataclasses.field(default_factory=dict)
    # two-phase profile (see CompiledQuery): host time of phase 1 and of
    # the dynamic domains' row pruning at staging
    phase1_s: float = 0.0
    df_apply_s: float = 0.0
    # capacity overflows that grew a hint and ran again
    recompiles: int = 0
    # one record per capture per rank on CUDA: warm-up and capture seconds,
    # segments, steps, the graph pool's and the fixed receive buffers'
    # bytes, replays, and the latest replay's host seconds launching the
    # segments and in the collectives
    captures: List[dict] = dataclasses.field(default_factory=list)
    # each rank's schedule of its latest eager run (the warm-up on CUDA),
    # and the agreed schedule of every run that compiled (one more a
    # regrowth)
    schedules: Dict[int, List[Step]] = dataclasses.field(default_factory=dict)
    recorded: List[List[Step]] = dataclasses.field(default_factory=list)
    # the first local rank's page of the latest warm-up (CUDA)
    warmup_page: Optional[Page] = None
    # kernel ledger (obs/devprofiler.py): one "SpmdBody" row over this
    # query's runs
    kernel_stats: Dict[tuple, dict] = dataclasses.field(default_factory=dict)
    # the compile ledger's identity, computed once on the first run
    _fingerprint: str = ""

    MAX_RECOMPILES = 16

    @classmethod
    def build(cls, session, root: P.OutputNode, mesh,
              capacity_hints: Optional[Dict[str, int]] = None) -> "DistributedQuery":
        """Phase 1 host-resolves the dynamic-filter domains, the scans
        stage narrowed and sharded, and the capacities estimate from the
        staged rows (global totals bound every shard); an overflow at run
        time doubles the hint and runs again."""
        from trino_tpu_torch.adaptive.reseed import (apply_reseed, reseed_enabled,
                                                     staged_pages_from_arrays)
        from trino_tpu_torch.exec import host_eval
        from trino_tpu_torch.sql.planner import stats

        n_devices = mesh.size
        # a root ORDER BY over nested (array/map/row) outputs cannot sort in
        # the tier (its nested sort is a host step): peel it off the plan
        # and apply it after the gather (the sort is the last step)
        post_sort = None
        if (isinstance(root.source, P.SortNode)
                and any(t.is_nested for t in root.source.output_types)):
            post_sort = list(root.source.sort_channels)
            root = P.OutputNode(root.source.source, root.column_names)
        t0 = _time.perf_counter()
        dyn = host_eval.resolve_dynamic_filters(session, root)
        phase1_s = _time.perf_counter() - t0
        prof: Dict[str, float] = {}
        staged, specs = stage_sharded_scans(session, root, mesh, dyn, profile=prof)
        if capacity_hints is None:
            capacity_hints = stats.estimate_capacity_hints(session, root)
            capacity_hints.update(stats.estimate_exchange_hints(session, root, n_devices))
        if reseed_enabled(session):
            # per-(shard, partition) key histograms of the staged rows price
            # the expansion joins and the exchange send blocks exactly
            apply_reseed(session, root, staged_pages_from_arrays(staged, specs), n_devices,
                         capacity_hints)
        dq = cls(mesh, session, root, staged, specs, dict(capacity_hints))
        dq.phase1_s = phase1_s
        dq.df_apply_s = prof.get("df_apply_s", 0.0)
        dq._post_sort = post_sort
        dq._programs = {}
        dq._fresh = True
        return dq

    # ------------------------------------------------------------ body
    def _body(self, comm, count_tiers: bool):
        """One rank's execution of the plan: (its output page's flat
        arrays, gathered where sharded, the page spec, the error codes,
        each flag fired on any rank as a device tensor or None). No host
        read."""
        pages = {nid: unflatten_page(self.specs[nid], shards[comm.rank])
                 for nid, shards in self.staged.items()}
        ex = SpmdExecutor(self.session, pages, dict(self.capacity_hints), comm)
        # the tiers a query selects count once, as the reference's trace
        ex.count_tiers = count_tiers and comm.rank == 0
        out = ex.execute(self.root)
        if not out.replicated:
            # a scan/filter/project-only plan meets no exchange: gather,
            # or the caller would see rank 0's shard alone
            out = gather_page(out, comm)
        arrays, spec = flatten_page(out)
        codes = [c for c, _ in ex.errors]
        fired = None
        if ex.errors:
            fired = comm.any(torch.stack([f.reshape(-1).any() for _, f in ex.errors]))
        return arrays, spec, codes, fired

    def _eager(self, comm, count_tiers: bool, check: bool, store=None):
        """The body run eagerly with the rank's schedule recorded (and
        agreed by every rank when ``check``), its constants uploaded
        through ``store`` when given: (arrays, spec, codes, host flags, the
        rank's program)."""
        prog = RankProgram(comm.rank, comm.device)
        comm.attach(prog)
        try:
            with constant_store(store) if store is not None else contextlib.nullcontext():
                arrays, spec, codes, fired = self._body(comm, count_tiers)
        finally:
            comm.attach(None)
        fired = fired.tolist() if fired is not None else []
        self.schedules[comm.rank] = prog.schedule
        if check:
            comm.agree(prog.schedule)
            if comm.rank == self.mesh.local[0]:
                self.recorded.append(prog.schedule)
        return arrays, spec, codes, fired, prog

    def _rank_run(self, comm, fresh: bool):
        """One rank's run: (output arrays, spec, error codes, host flags).
        On the CPU the body runs eagerly. On CUDA a rank without a program
        warms up, agrees on its schedule and captures, then replays."""
        if comm.device.type != "cuda":
            return self._eager(comm, fresh, check=fresh)[:4]
        prog = self._programs.get(comm.rank)
        if prog is None:
            # the warm-up: the rank's constants land in its store, which
            # the capture then reads (a capture cannot copy from the host)
            store = ConstantStore()
            t0 = _time.perf_counter()
            arrays, spec, codes, fired, prog = self._eager(comm, True, check=True,
                                                           store=store)
            torch.cuda.current_stream(comm.device).synchronize()
            warmup_s = _time.perf_counter() - t0
            if comm.rank == self.mesh.local[0]:
                self.warmup_page = unflatten_page(spec, arrays)
            if any(fired):
                # a regrowth or an error: the graphs would be thrown away
                return arrays, spec, codes, fired
            store.frozen = True
            t1 = _time.perf_counter()
            comm.attach(prog)
            try:
                with constant_store(store):
                    prog.capture(lambda: self._body(comm, False))
            finally:
                comm.attach(None)
            prog.store = store  # the graphs read its tensors
            prog.stats = {
                "rank": comm.rank, "capture": self.recompiles, "warmup_s": warmup_s,
                "capture_s": _time.perf_counter() - t1, "segments": len(prog.segments),
                "steps": len(prog.schedule), "pool_bytes": prog.pool_bytes(),
                "buffer_bytes": prog.buffer_bytes(), "constants": len(store),
                "replays": 0}
            self.captures.append(prog.stats)
            self._programs[comm.rank] = prog
        launch_s, collective_s = prog.replay(comm)
        arrays, spec, codes, fired = prog.outputs
        fired = fired.tolist() if fired is not None else []  # the one read
        prog.stats["replays"] += 1
        prog.stats["replay_host_us"] = launch_s * 1e6
        prog.stats["collective_s"] = collective_s
        return arrays, spec, codes, fired

    def _reset(self) -> None:
        """Drop every rank's program: the next run compiles anew."""
        if self._programs:
            for rank in self._programs:
                self.mesh.stream(rank).synchronize()
            for prog in self._programs.values():
                prog.reset()
        self._programs = {}
        self._fresh = True

    def close(self) -> None:
        """Release every rank's graphs, pool and fixed buffers."""
        self._reset()
        self.warmup_page = None

    def _shape_signature(self) -> str:
        """The compile ledger's shapes: every staged array with the mesh
        axis in front, as the reference's stacked inputs."""
        from trino_tpu_torch.obs.devprofiler import shape_signature

        first = self.mesh.local[0]
        return shape_signature([
            types.SimpleNamespace(shape=(self.mesh.size,) + tuple(a.shape), dtype=a.dtype)
            for shards in self.staged.values() for a in shards[first]])

    def _profile_run(self, fresh: bool, wall_s: float, body_device_s: float,
                     estimated: bool) -> None:
        """Feed the device profiler: one compile-ledger event a run (a miss
        on a run that compiled, a hit on a replay; on the CPU a miss on the
        first run and after a regrowth) and the ``SpmdBody`` kernel row."""
        from trino_tpu_torch.cache.plan_key import plan_fingerprint
        from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER

        if not self._fingerprint:
            self._fingerprint = plan_fingerprint(self.root)
        DEVICE_PROFILER.record_compile(
            "spmd", self._fingerprint, self._shape_signature(),
            wall_s if fresh else 0.0, "miss" if fresh else "hit", started=fresh)
        wall = body_device_s if fresh else wall_s + (0.0 if estimated else body_device_s)
        key = (str(self.root.id), "SpmdBody", "spmd")
        ks = self.kernel_stats.get(key)
        if ks is None:
            ks = self.kernel_stats[key] = {
                "planNodeId": key[0], "operator": key[1], "tier": "spmd", "launches": 0,
                "wallS": 0.0, "deviceS": 0.0, "inputBytes": 0, "outputBytes": 0,
                "estimated": estimated}
        ks["launches"] += 1
        ks["wallS"] += wall
        ks["deviceS"] += body_device_s
        ks["estimated"] = bool(ks["estimated"] or estimated)
        DEVICE_PROFILER.count_launch(wall, 0.0 if estimated else body_device_s)

    def run(self) -> Page:
        """Run the plan on every rank; on a capacity overflow, double the
        offending hint and run again. Returns the first local rank's page
        (rank 0's on a thread mesh)."""
        from trino_tpu_torch.exec.executor import raise_fired
        from trino_tpu_torch.obs.devprofiler import DEVICE_PROFILER
        from trino_tpu_torch.sql.planner import stats

        profiling = bool(self.session.properties.get("device_profiling", False))
        for _ in range(self.MAX_RECOMPILES):
            fresh = self._fresh
            if fresh:
                DEVICE_PROFILER.compile_started()
            t0 = _time.perf_counter()
            arrays, spec, codes, fired = self.mesh.run(
                lambda comm, fresh=fresh: self._rank_run(comm, fresh))[0]
            wall_s = _time.perf_counter() - t0
            cuda = self.mesh.devices[self.mesh.local[0]].type == "cuda"
            # a replay's outputs are rewritten by the next one
            page = unflatten_page(spec, [a.clone() for a in arrays] if cuda else arrays)
            # the ranks read their flags: the run's device work is done, and
            # its wall is the body's device time when profiling
            if profiling:
                body_device_s, estimated = wall_s, False
            else:
                body_device_s, estimated = (0.0 if fresh else wall_s), True
            self._profile_run(fresh, wall_s, body_device_s, estimated)
            # a CUDA run is fresh until every rank holds a captured program
            self._fresh = cuda and len(self._programs) < len(self.mesh.local)
            # capacity first: another flag of the same run may be an
            # artifact of the truncated output
            grown = stats.grow_overflowed_hints(self.capacity_hints, codes, fired)
            if grown is not None:
                self.capacity_hints = grown
                self.recompiles += 1
                self._reset()
                continue
            raise_fired(codes, fired)
            if self._post_sort is not None:
                page = Executor(self.session).sorted_page(page, self._post_sort)
            return page
        raise QueryError("capacity still exceeded after recompiles (join or exchange bucket)")
