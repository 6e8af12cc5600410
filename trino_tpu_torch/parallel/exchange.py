"""Hash- and range-partitioned exchange over a mesh: the port of
trino_tpu/parallel/exchange.py.

Reference: the FIXED_HASH_DISTRIBUTION repartition shuffle (producer
``PagePartitioner``: compute every row's partition, then gather each
partition's rows column by column; consumer ``ExchangeOperator``). The
reference runs it inside ``shard_map`` as ``jax.lax.all_to_all``; here each
rank runs it eagerly and the swap is the mesh's ``all_to_all``
(parallel/mesh.py):

1. partition id a row = the splitmix64 combine of the key columns mod
   ``n_devices``, bit for bit the reference's (NULL keys hash to one
   constant, so equal keys, and all NULLs, co-locate);
2. rows sort by partition id (dead rows last);
3. each partition's rows gather into a ``[n_devices, capacity]`` send
   buffer (the capacity from stats; an overflow raises the deferred
   ``CAPACITY_EXCEEDED:xchg*`` flag and the run loop doubles the hint and
   runs again);
4. the mesh swaps the blocks;
5. the received blocks flatten into a new sharded page (pad slots dead).

Also here: ``spread_partition_ids``, the host half of the adaptive skew
salting (adaptive/replanner.py), which the cluster's producers call.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from trino_tpu_torch.data.page import Column, Page
from trino_tpu_torch.ops import ranks
from trino_tpu_torch.ops.hll import _mix64, _signed

Lowered = Tuple[torch.Tensor, Optional[torch.Tensor]]

_NULL_HASH = _signed(0x9E3779B97F4A7C15)


def _umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """The unsigned remainder of int64 bit patterns by a small ``n``: the
    top bit's 2^63 adds ``2^63 mod n``."""
    low = (h & ((1 << 63) - 1)) % n
    top = (h < 0).to(torch.int64) * ((1 << 63) % n)
    return (low + top) % n


def partition_ids(keys: List[Lowered], n_devices: int) -> torch.Tensor:
    """int32[n] partition id a row: the combined key hash mod
    ``n_devices``. Deterministic and device-independent (a replayed
    exchange routes every row alike)."""
    n = keys[0][0].shape[0]
    h = torch.zeros((n,), dtype=torch.int64, device=keys[0][0].device)
    for vals, valid in keys:
        k = _mix64(vals.to(torch.int64))
        if valid is not None:
            k = torch.where(valid, k, torch.full_like(k, _NULL_HASH))
        h = _mix64(h ^ k)
    return _umod(h, n_devices).to(torch.int32)


def spread_partition_ids(pid: np.ndarray, hot_partitions, n_parts: int,
                         start: int = 0) -> Tuple[np.ndarray, int]:
    """Salted spread of HOT partitions (host half of the adaptive skew
    mitigation, adaptive/replanner.py): rows whose key hash
    landed in a hot partition are re-dealt round-robin across ALL
    partitions, deterministically by row position (a replay of the
    producer places them alike). ``start`` is the producer's rotating cursor —
    streaming producers call this once per output page, and restarting at
    partition 0 each page would pile every page's few hot rows onto the
    low-numbered partitions, re-creating the skew; the caller threads the
    returned cursor into the next call. Exactness contract: the spread
    side's rows lose key co-location, so the OTHER join side must
    replicate the same hot partitions into every partition — a spread
    probe row then finds its (hot-key) build matches wherever it lands,
    while rows of non-hot partitions cannot spuriously match replicated
    hot-key rows (their key hashes differ by construction). One hot key
    stops serializing on one task; the price is |hot build| x n_parts
    replicated bytes.

    Returns ``(new_pid, next_start)``."""
    pid = np.asarray(pid).copy()
    hot = np.asarray(sorted(hot_partitions), dtype=pid.dtype)
    idx = np.flatnonzero(np.isin(pid, hot))
    pid[idx] = ((start + np.arange(len(idx))) % n_parts).astype(pid.dtype)
    return pid, (start + len(idx)) % n_parts


def page_partition_ids(page: Page, key_channels: List[int],
                       n_devices: int) -> torch.Tensor:
    """Partition ids for a page's key columns, hashed once for callers
    that route the same page more than once (the overlapped exchange)."""
    keys = [
        (page.columns[c].values,
         None if page.columns[c].nulls is None else ~page.columns[c].nulls)
        for c in key_channels
    ]
    return partition_ids(keys, n_devices)


def _refuse_wide(page: Page) -> None:
    for c in page.columns:
        if c.hi is not None or c.type.is_nested:
            raise NotImplementedError(
                "device hash exchange over long-decimal/nested columns")


def repartition_page(page: Page, key_channels: List[int], n_devices: int,
                     capacity: int, comm) -> Tuple[Page, torch.Tensor]:
    """Hash-repartition a sharded page over the mesh: (the received page of
    ``n_devices * capacity`` rows, the overflow flag). Dead rows are not
    sent; received pad slots are dead."""
    _refuse_wide(page)
    pid = page_partition_ids(page, key_channels, n_devices)
    return repartition_by_pid(page, pid, n_devices, capacity, comm)


def _send_plan(page: Page, pid: torch.Tensor, n_devices: int):
    """(order, starts, counts): rows sorted by partition id (dead rows
    last) and each partition's [start, count) range in that order."""
    device = pid.device
    if page.sel is not None:
        pid = torch.where(page.sel, pid, torch.full_like(pid, n_devices))
    order = ranks.argsort32(pid)
    pid_sorted = pid[order.long()]
    starts, counts = ranks.sorted_ranks(
        [pid_sorted], [torch.arange(n_devices, dtype=torch.int32, device=device)])
    return order, starts, counts


def _xchg_arrays(page: Page, order, starts, counts, lo: int, cap: int):
    """The send blocks of slots [lo, lo + cap) of every partition: each
    column's rows gathered into ``[n_devices, cap]``, then the live mask."""
    n = page.num_rows
    j = lo + torch.arange(cap, dtype=torch.int32, device=order.device)
    slot_idx = torch.clamp(starts[:, None] + j[None, :], 0, n - 1)  # [ndev, cap]
    send_live = j[None, :] < counts[:, None]
    rows = order.long()[slot_idx.long()]
    arrays = []
    for c in page.columns:
        arrays.append(c.values[rows])
        if c.nulls is not None:
            arrays.append(c.nulls[rows])
    arrays.append(send_live)
    return arrays


def _xchg_start(page: Page, order, starts, counts, lo: int, cap: int, comm):
    """Issue the exchange of send slots [lo, lo + cap) of every partition:
    gather the block's rows and start swapping them over the mesh."""
    return comm.all_to_all_start(_xchg_arrays(page, order, starts, counts, lo, cap))


def _xchg_page(page: Page, received: List[torch.Tensor]) -> Page:
    """The received page of a block exchange (pad slots dead)."""
    recv = iter(received)
    out_cols = []
    for c in page.columns:
        vals = next(recv)
        nulls = next(recv) if c.nulls is not None else None
        out_cols.append(Column(c.type, vals, nulls, c.dictionary, c.vrange))
    return Page(out_cols, next(recv), replicated=False)


def _xchg_block(page: Page, order, starts, counts, lo: int, cap: int, comm) -> Page:
    """Exchange send slots [lo, lo + cap) of every partition in one
    blocking all-to-all: gather the block's rows, swap them over the mesh,
    assemble the received page."""
    return _xchg_page(page, comm.all_to_all(_xchg_arrays(page, order, starts, counts, lo, cap)))


def repartition_by_pid(page: Page, pid: torch.Tensor, n_devices: int,
                       capacity: int, comm) -> Tuple[Page, torch.Tensor]:
    """Repartition by a precomputed partition id a row (int32 in
    [0, n_devices)): the producer half shared by the hash exchange and the
    sorted tier's range exchange."""
    order, starts, counts = _send_plan(page, pid, n_devices)
    overflow = (counts > capacity).any()
    out = _xchg_block(page, order, starts, counts, 0, capacity, comm)
    return out, overflow


def repartition_page_overlapped(page: Page, key_channels: List[int], n_devices: int,
                                capacity: int, comm, n_blocks: int,
                                consume) -> Tuple[Page, torch.Tensor]:
    """Hash-repartition with the send buffer split into ``n_blocks``
    blocks, each consumed as it lands: block k+1's all-to-all is issued
    (``async``) before ``consume`` runs on block k, so the swap overlaps
    the compute.

    ``consume(received_block_page) -> Page`` must be row-local (each
    output row a function of its input row and of state every rank
    holds: the probe side of a join against an exchanged build). Then the
    result is bit-identical to ``consume(repartition_page(...))``: the
    per-block outputs restack from block-major to the one-shot exchange's
    rank-major row order.

    The effective capacity rounds up to a whole number of blocks; returns
    (assembled page, overflow flag)."""
    _refuse_wide(page)
    n_blocks = max(int(n_blocks), 1)
    bcap = -(-capacity // n_blocks)
    pid = page_partition_ids(page, key_channels, n_devices)
    order, starts, counts = _send_plan(page, pid, n_devices)
    overflow = (counts > bcap * n_blocks).any()
    out_pages: List[Page] = []
    prev = _xchg_block(page, order, starts, counts, 0, bcap, comm)
    for b in range(1, n_blocks):
        # block b travels while block b-1 is consumed
        nxt = _xchg_start(page, order, starts, counts, b * bcap, bcap, comm)
        out_pages.append(consume(prev))
        prev = _xchg_page(page, nxt.wait())
    out_pages.append(consume(prev))
    return _restack_blocks(out_pages, n_devices, bcap), overflow


def _restack_blocks(pages: List[Page], n_devices: int, bcap: int) -> Page:
    """Per-block consume outputs (block-major) in the one-shot exchange's
    row order (rank-major): rows [b][dev][slot] move to [dev][b][slot]."""
    n_blocks = len(pages)
    if n_blocks == 1:
        return pages[0]

    def restack(arrays: List[torch.Tensor]) -> torch.Tensor:
        stacked = torch.stack([
            a.reshape((n_devices, bcap) + tuple(a.shape[1:])) for a in arrays
        ])  # [blocks, ndev, bcap, ...]
        moved = stacked.movedim(0, 1)  # [ndev, blocks, bcap, ...]
        return moved.reshape((n_devices * n_blocks * bcap,) + tuple(moved.shape[3:]))

    first = pages[0]
    out_cols = []
    for ci, c in enumerate(first.columns):
        vals = restack([p.columns[ci].values for p in pages])
        nulls = (restack([p.columns[ci].nulls for p in pages])
                 if c.nulls is not None else None)
        hi = (restack([p.columns[ci].hi for p in pages])
              if c.hi is not None else None)
        out_cols.append(Column(c.type, vals, nulls, c.dictionary, c.vrange, hi=hi))
    sel = restack([p.sel for p in pages]) if first.sel is not None else None
    return Page(out_cols, sel, replicated=first.replicated)
