"""Device-memory accounting and the spill decision: the port of
trino_tpu/exec/memory.py.

Page shapes are known, so a reservation is exact arithmetic on tensor
bytes. The spill tier is host RAM: an over-budget join or aggregation
hash-partitions its inputs on the host into P passes and runs each pass on
the device (the reference engine's partitioned spill collapsed into a loop).
Not ported: the memory-ledger events of the reference's ``owner``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from trino_tpu_torch.obs import trace as tracing


def _tensor_bytes(t) -> int:
    return int(t.numel()) * t.element_size()


def _column_bytes(c) -> int:
    total = _tensor_bytes(c.values)
    if c.nulls is not None:
        total += _tensor_bytes(c.nulls)
    if c.hi is not None:
        total += _tensor_bytes(c.hi)
    for k in c.children or ():
        total += _column_bytes(k)
    return total


def page_bytes(page) -> int:
    """Exact device bytes of a Page: every column's values, nulls, high
    limb and nested children, and the selection mask. (The reference counts
    neither children nor high limbs.)"""
    total = sum(_column_bytes(c) for c in page.columns)
    if page.sel is not None:
        total += _tensor_bytes(page.sel)
    return total


@dataclasses.dataclass
class SpillEvent:
    node_id: int
    kind: str  # 'join' | 'aggregation'
    partitions: int
    projected_bytes: int


class MemoryContext:
    """Per-query device-memory budget, peak tracking and spill log.
    ``peak_projected`` is the largest working set handed to the spill
    decision; ``shed_bytes`` and ``yields`` count the device-cache bytes
    reclaimed on this query's behalf."""

    MAX_SPILL_PARTITIONS = 64

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget = int(budget_bytes) if budget_bytes else None
        self.peak = 0
        self.peak_projected = 0
        self.spills: List[SpillEvent] = []
        self.shed_bytes = 0
        self.yields = 0

    def observe(self, nbytes: int) -> None:
        if nbytes > self.peak:
            self.peak = nbytes

    def spill_partitions(self, projected_bytes: int) -> int:
        """1 = fits in the budget; else the number of hash partitions (a
        power of two) whose per-pass working set fits."""
        self.observe(projected_bytes)
        self.peak_projected = max(self.peak_projected, int(projected_bytes))
        if self.budget is None or projected_bytes <= self.budget:
            with tracing.span("memory/reserve") as sp:
                sp.set("bytes", int(projected_bytes))
            return 1
        parts = 1
        while parts < self.MAX_SPILL_PARTITIONS and projected_bytes // parts > self.budget:
            parts *= 2
        # the device table cache yields first, sized to the per-pass
        # working set (what will be resident once the passes run), never
        # to the whole projection
        from trino_tpu_torch.devcache import DEVICE_CACHE

        with tracing.span("memory/shed") as sp:
            freed = DEVICE_CACHE.yield_bytes(projected_bytes // parts)
            sp.set("requested", int(projected_bytes // parts))
            sp.set("freed", int(freed))
            sp.set("partitions", parts)
        self.shed_bytes += freed
        self.yields += 1
        return parts

    def record_spill(self, node_id: int, kind: str, partitions: int, projected: int) -> None:
        self.spills.append(SpillEvent(node_id, kind, partitions, projected))


# ------------------------------------------------- host-side partitioning

_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_NULL_HASH = 0x9E3779B97F4A7C15


def _mix64_np(x):
    """splitmix64's finalizer on uint64 (wrapping multiplication)."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(_M1)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_M2)
        return x ^ (x >> np.uint64(31))


def partition_page_host(page, key_channels, parts: int, pid=None):
    """Split a page into ``parts`` hash partitions by its key columns, on
    the host (the spill write path; a distributed producer passes its own
    partition ids, ``pid``): equal keys co-locate, dead rows are dropped.
    Returns ``parts`` compacted Pages on the page's device (a 1-row
    all-dead page where a partition is empty)."""
    from trino_tpu_torch.data.page import Page, host_take, to_numpy

    n = page.num_rows
    live = np.ones(n, bool) if page.sel is None else to_numpy(page.sel)
    if pid is None:
        h = np.zeros(n, np.uint64)
        for ch in key_channels:
            col = page.columns[ch]
            # the low limb only: equal values always share it, while a
            # column's high limb is present on one join side and not the
            # other depending on the data
            k = _mix64_np(to_numpy(col.values).astype(np.int64))
            if col.nulls is not None:
                k = np.where(to_numpy(col.nulls), np.uint64(_NULL_HASH), k)
            h = _mix64_np(h ^ k)
        pid = (h % np.uint64(parts)).astype(np.int64)
    else:
        pid = np.asarray(pid)
    out = []
    for p in range(parts):
        idx = np.nonzero(live & (pid == p))[0]
        if len(idx) == 0:
            out.append(_pad_like(page))
            continue
        out.append(Page([host_take(c, idx) for c in page.columns], None))
    return out


def _pad_like(page):
    """1-row all-dead page with the same column dtypes and dictionaries (a
    nested column's children empty, a row's fields one row)."""
    import torch

    from trino_tpu_torch.data.page import Column, Page

    device = page.columns[0].values.device

    def pad(c, nrows):
        kids = ([pad(k, nrows if c.type.is_row else 0) for k in c.children]
                if c.children is not None else None)
        return Column(c.type, torch.zeros((nrows,), dtype=c.values.dtype, device=device),
                      None, c.dictionary, c.vrange, children=kids)

    return Page([pad(c, 1) for c in page.columns],
                torch.zeros((1,), dtype=torch.bool, device=device))
