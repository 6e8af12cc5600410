"""Split staging: the port of trino_tpu/exec/staging.py.

Every table scan stages through here (behind the device cache,
exec/executor.py):

- **adaptive split sizing**: ``target_split_count`` derives the
  ``get_splits`` target from the estimated table bytes over the
  ``staging_split_bytes`` session property, so small tables stay one split
  and large ones fan out;
- **parallel split reads**: ``stage_splits`` runs ``connector.scan`` and
  the host-applied dynamic-domain pruning of each split on a shared
  process-wide thread pool. The pool threads only generate and prune numpy
  arrays; results assemble in split order, so the staged arrays are
  bit-identical to the serial path;
- **the host-RAM tier**: each split consults ``HOST_CACHE`` first (hits
  skip the connector), and misses fill it single-flighted;
- **no host concatenation**: the splits' columns are never joined on the
  host. ``split_columns`` merges each column's dictionaries once per scan
  (``spi.column_parts``: only the splits whose vocabulary differs are
  recoded) and ``device_dtype`` fixes the physical dtype from the
  table-wide vrange; each split's arrays are then copied straight into
  their slice of the device column;
- **double-buffered host->device copies**: ``blocked_transfer`` allocates
  each column's device tensor once and fills it from two reused pinned
  host buffers on a side CUDA stream (the int32 narrowing happens in the
  copy into the pinned buffer), each buffer's reuse gated on the event of
  its last copy, and makes the consuming stream wait for the copy stream
  before the page is used. The device holds one copy of the column (no
  device-side concatenation). Columns of at most two blocks take one plain
  copy per split; a CPU session takes the plain host path.

The staging wall decomposes into ``staging/scan``, ``staging/decode``,
``staging/transfer`` and ``staging/host-cache`` spans and the
``STAGING_PHASE_SECONDS{phase}`` counter; ``STAGED_ROWS`` and
``STAGED_H2D_BYTES`` count what each fresh staging moved.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.obs.memledger import MEMORY_LEDGER, POOL_DEVICE

# default target bytes per split when the session does not set
# staging_split_bytes
DEFAULT_SPLIT_BYTES = 64 << 20
# fan-out ceiling: beyond this, per-split constant costs (generator cache
# entries, dictionary merges) outweigh the overlap
MAX_TARGET_SPLITS = 64
# bytes per double-buffered host->device block (each pinned buffer's size)
TRANSFER_BLOCK_BYTES = 32 << 20
# shared scan pool capacity (all sessions of this process; per-staging
# concurrency is bounded by staging_parallelism)
POOL_WORKERS = 16

_pool_cell: List = []
_pool_lock = threading.Lock()


def staging_pool():
    """The process-wide staging thread pool, created on first use."""
    if _pool_cell:
        return _pool_cell[0]
    from concurrent.futures import ThreadPoolExecutor

    with _pool_lock:
        if not _pool_cell:
            _pool_cell.append(ThreadPoolExecutor(
                max_workers=POOL_WORKERS, thread_name_prefix="staging-io"))
    return _pool_cell[0]


def staging_parallelism(session) -> int:
    """Per-staging fan-out width: the ``staging_parallelism`` session
    property, or (0 = auto) min(8, cpu count). 1 = the serial path."""
    props = getattr(session, "properties", None) or {}
    v = int(props.get("staging_parallelism") or 0)
    if v > 0:
        return v
    return min(8, os.cpu_count() or 1)


def split_bytes_target(session) -> int:
    props = getattr(session, "properties", None) or {}
    return int(props.get("staging_split_bytes") or DEFAULT_SPLIT_BYTES)


# connector -> {(schema, table): (estimate, monotonic stamp)}: split sizing
# only needs the order of magnitude, so estimates are memoized briefly
_estimate_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_estimate_lock = threading.Lock()
_ESTIMATE_TTL_S = 10.0


def estimated_table_bytes(conn, schema: str, table: str) -> Optional[int]:
    """Row count x full-table width (8 bytes a column). The width comes
    from the table metadata, not the scan's projection: split boundaries
    must not depend on the projection, so two scans of one table (Q18
    reads lineitem twice) ask for the same ranges and the generator cache
    accumulates their columns in one entry."""
    now = time.monotonic()
    try:
        with _estimate_lock:
            per = _estimate_cache.get(conn)
            hit = per.get((schema, table)) if per else None
    except TypeError:  # a connector that cannot be weakly referenced
        per, hit = None, None
    if hit is not None and now - hit[1] <= _ESTIMATE_TTL_S:
        return hit[0]
    try:
        rows = conn.table_row_count(schema, table)
    except Exception:  # noqa: BLE001 — stats are best-effort
        rows = None
    if not rows:
        est = None
    else:
        try:
            meta = conn.get_table(schema, table)
            width = len(meta.columns) if meta is not None else None
        except Exception:  # noqa: BLE001
            width = None
        est = int(rows) * 8 * max(int(width or 4), 1)
    try:
        with _estimate_lock:
            _estimate_cache.setdefault(conn, {})[(schema, table)] = (est, now)
    except TypeError:
        pass
    return est


def target_split_count(session, conn, schema: str, table: str,
                       floor: int = 1, handle=None) -> int:
    """Adaptive ``get_splits`` target: ceil(estimated bytes /
    staging_split_bytes), clamped to [floor, MAX_TARGET_SPLITS]. Unknown
    row counts keep the caller's floor. A pushdown ``handle`` keeps the
    floor too: a pushed aggregation, TopN or limit is a global statement
    that would become per-split."""
    if handle is not None:
        return max(1, floor)
    est = estimated_table_bytes(conn, schema, table)
    if est is None:
        return max(1, floor)
    per = max(1, split_bytes_target(session))
    target = (est + per - 1) // per
    return max(max(1, floor), min(MAX_TARGET_SPLITS, int(target)))


# ------------------------------------------------------------- fan-out
# scan_one marker: this split is in flight in another staging; the calling
# thread joins that flight after the fan-out drains
_INFLIGHT = object()


@dataclasses.dataclass
class StageProfile:
    """Per-staging timing record. ``scan_s``/``prune_s`` are cumulative
    thread seconds; the ``*_wall_s`` fields are calling-thread wall."""

    splits: int = 0
    parallelism: int = 1
    host_hits: int = 0
    scan_s: float = 0.0
    prune_s: float = 0.0
    hostcache_wall_s: float = 0.0
    fanout_wall_s: float = 0.0
    decode_wall_s: float = 0.0
    transfer_wall_s: float = 0.0
    transfer_blocks: int = 0
    h2d_bytes: int = 0

    def overlap(self) -> float:
        if self.fanout_wall_s <= 0:
            return 0.0
        return (self.scan_s + self.prune_s) / self.fanout_wall_s


def _map_ordered(fn: Callable[[int], object], n: int, width: int) -> List:
    """``fn(0..n-1)`` with at most ``width`` in flight on the shared pool,
    results in index order. width <= 1 is the plain serial loop."""
    if width <= 1 or n <= 1:
        return [fn(i) for i in range(n)]
    from concurrent.futures import FIRST_COMPLETED, wait

    pool = staging_pool()
    results: List = [None] * n
    pending = {}
    nxt = 0
    try:
        while nxt < n and len(pending) < width:
            pending[pool.submit(fn, nxt)] = nxt
            nxt += 1
        while pending:
            done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
            for fut in done:
                i = pending.pop(fut)
                results[i] = fut.result()  # re-raises the worker's error
                if nxt < n:
                    pending[pool.submit(fn, nxt)] = nxt
                    nxt += 1
    finally:
        for fut in pending:
            fut.cancel()
    return results


def stage_splits(session, node, conn, splits, constraint,
                 prune: Optional[Callable] = None,
                 applied_domains: Optional[Dict] = None,
                 ) -> Tuple[List[Dict], StageProfile]:
    """Scan and decode every split: host-tier probe first (hits skip the
    connector), then the missing splits fan out over the shared pool, each
    running ``conn.scan`` and ``prune`` and filling the host tier
    single-flighted. Returns the per-split column dicts in split order and
    the profile."""
    from trino_tpu_torch import devcache

    prof = StageProfile(splits=len(splits),
                        parallelism=staging_parallelism(session))
    if not splits:
        return [], prof
    datas: List = [None] * len(splits)
    keys = devcache.host_split_keys(session, node, constraint,
                                    applied_domains or {}, splits)
    if any(k is not None for k in keys):
        t0 = time.perf_counter()
        with tracing.span("staging/host-cache", table=node.table) as sp:
            for i, k in enumerate(keys):
                if k is None:
                    continue
                ent = devcache.HOST_CACHE.peek(k)
                if ent is not None:
                    datas[i] = ent.value
                    prof.host_hits += 1
            sp.set("hits", prof.host_hits)
            sp.set("splits", len(splits))
        prof.hostcache_wall_s = time.perf_counter() - t0
        M.STAGING_PHASE_SECONDS.inc(prof.hostcache_wall_s, "host-cache")
    missing = [i for i in range(len(splits)) if datas[i] is None]
    if not missing:
        return datas, prof
    acc_lock = threading.Lock()
    columns = list(node.column_names)

    def make_loader(i: int):
        def loader():
            t0 = time.perf_counter()
            data = conn.scan(splits[i], columns, constraint=constraint)
            t1 = time.perf_counter()
            if prune is not None:
                (data,) = prune([data])
            t2 = time.perf_counter()
            with acc_lock:
                prof.scan_s += t1 - t0
                prof.prune_s += t2 - t1
            rows = len(next(iter(data.values())).values) if data else 0
            return data, rows, devcache.split_data_bytes(data), 1

        return loader

    def scan_one(i: int):
        loader = make_loader(i)
        if keys[i] is not None:
            # wait=False: a split another staging is loading must not park
            # this shared pool thread behind that flight; in-flight splits
            # resolve on the calling thread below
            ent, _disposition = devcache.HOST_CACHE.lookup_or_stage(
                keys[i], loader, wait=False,
                admit_bytes=devcache.host_admit_budget(session))
            return ent.value if ent is not None else _INFLIGHT
        return loader()[0]

    t0 = time.perf_counter()
    with tracing.span("staging/scan", table=node.table) as sp:
        for j, data in zip(missing,
                           _map_ordered(lambda k: scan_one(missing[k]),
                                        len(missing), prof.parallelism)):
            datas[j] = data
        for j in missing:
            if datas[j] is _INFLIGHT:
                # the follower waits here, on the staging's own thread
                ent, _disposition = devcache.HOST_CACHE.lookup_or_stage(
                    keys[j], make_loader(j),
                    admit_bytes=devcache.host_admit_budget(session))
                datas[j] = ent.value
        prof.fanout_wall_s = time.perf_counter() - t0
        sp.set("splits", len(missing))
        sp.set("parallelism", prof.parallelism)
        sp.set("scan_s", round(prof.scan_s, 6))
        sp.set("prune_s", round(prof.prune_s, 6))
        sp.set("overlap", round(prof.overlap(), 3))
    M.STAGING_PHASE_SECONDS.inc(prof.fanout_wall_s, "scan")
    return datas, prof


# ----------------------------------------------------------- assembly
def split_columns(column_names, column_types, datas):
    """Each scanned column as its per-split parts on one merged dictionary
    (``spi.column_parts``: only splits with another vocabulary are
    recoded), never joined on the host; None when no row is left. A nested
    column takes the single-shot path, as in the reference: its parts are
    joined on the host into one ``ColumnData`` (children recurse)."""
    from trino_tpu_torch.connector.spi import column_parts, concat_column_data

    if not datas:
        return None
    cols = []
    for name, typ in zip(column_names, column_types):
        parts = [d[name] for d in datas]
        cols.append(concat_column_data(parts) if typ.is_nested else column_parts(parts))
    if column_names and sum(len(d[column_names[0]].values) for d in datas) == 0:
        return None
    return cols


def device_dtype(parts) -> np.dtype:
    """The physical dtype of a column's parts on the device: their common
    dtype, int64 with a high limb, and the reference's int32 narrowing of
    int64 where the table-wide vrange fits."""
    from trino_tpu_torch.data.page import fits_int32

    if parts.hi is not None:
        return np.dtype(np.int64)
    dtype = np.result_type(*[v.dtype for v in parts.values])
    if dtype == np.int64 and fits_int32(parts.vrange):
        return np.dtype(np.int32)
    return dtype


class _PinnedPair:
    """Two reused pinned host buffers of ``nbytes`` each, the side stream
    that copies out of them and, per buffer, the event of its last copy.
    One per CUDA device and process; ``lock`` serializes the transfers
    that use it."""

    def __init__(self, device, nbytes: int):
        import torch

        self.lock = threading.Lock()
        self.nbytes = nbytes
        self.bufs = [torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
                     for _ in range(2)]
        self.views = [b.numpy() for b in self.bufs]
        self.events = [None, None]
        self.stream = torch.cuda.Stream(device=device)


_pinned: Dict[Tuple[int, int], _PinnedPair] = {}
_pinned_lock = threading.Lock()


def _pinned_pair(device, nbytes: int) -> _PinnedPair:
    key = (device.index if device.index is not None else 0, nbytes)
    with _pinned_lock:
        pair = _pinned.get(key)
        if pair is None:
            pair = _pinned[key] = _PinnedPair(device, nbytes)
        return pair


def _blocked_copy(parts, dtype: np.dtype, n: int, device, block_rows: int,
                  pair: _PinnedPair):
    """Copy the ``parts`` end to end, cast to ``dtype``, into one new
    device tensor of ``n`` rows: each pinned buffer is filled with up to
    ``block_rows`` rows (the cast happens in that host copy) and copied
    into its slice of the tensor on the side stream while the other buffer
    fills. Returns the tensor and the number of blocks."""
    import torch

    from trino_tpu_torch.data.page import torch_dtype

    consumer = torch.cuda.current_stream(device)
    out = torch.empty((n,), dtype=torch_dtype(dtype), device=device)
    blocks = 0
    dst = 0  # first output row of the buffer being filled
    fill = 0  # rows in the buffer being filled
    host = None
    with pair.lock:
        # the output was allocated on the consumer stream
        pair.stream.wait_stream(consumer)
        with torch.cuda.stream(pair.stream):

            def flush():
                nonlocal blocks, dst, fill, host
                slot = blocks % 2
                src = pair.bufs[slot][:fill * dtype.itemsize].view(out.dtype)
                out[dst:dst + fill].copy_(src, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(pair.stream)
                pair.events[slot] = ev
                blocks += 1
                dst += fill
                fill = 0
                host = None

            for part in parts:
                pos = 0
                while pos < len(part):
                    if host is None:
                        slot = blocks % 2
                        if pair.events[slot] is not None:
                            # this buffer's previous copy must have finished
                            pair.events[slot].synchronize()
                        host = pair.views[slot][:block_rows * dtype.itemsize].view(dtype)
                    take = min(block_rows - fill, len(part) - pos)
                    np.copyto(host[fill:fill + take], part[pos:pos + take], casting="unsafe")
                    fill += take
                    pos += take
                    if fill == block_rows:
                        flush()
            if fill:
                flush()
        # the page is used on the consumer stream, and freed there: the
        # consumer waits for the copies, and the allocator must not hand
        # the block out again before the side stream is done with it
        consumer.wait_stream(pair.stream)
        out.record_stream(pair.stream)
    return out, blocks


def _host_copy(parts, dtype, device):
    """The plain host path of a transfer: one concatenation, one copy."""
    from trino_tpu_torch.data.page import to_device

    host = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return to_device(host.astype(dtype, copy=False), device)


def blocked_transfer(device, profile: Optional[StageProfile] = None,
                     block_bytes: int = TRANSFER_BLOCK_BYTES):
    """A ``transfer(parts, dtype=None) -> tensor on device``: the 1-D host
    arrays ``parts`` (or one bare array) end to end, cast to ``dtype``
    (default: their common dtype), in one device tensor allocated once. On
    CUDA, more than two blocks of ~``block_bytes`` go through two reused
    pinned buffers (``_blocked_copy``); less takes one plain copy a part,
    straight into the part's slice. A CPU device takes the plain host
    path. Either way the result is bitwise the concatenation. A transfer
    of more than two blocks holds its output as in-flight scratch until
    the copy ends: the memory ledger's ``staging`` owner on the ``device``
    pool reserves its bytes for that time."""
    import torch

    from trino_tpu_torch.data.page import torch_dtype

    device = torch.device(device)

    def transfer(parts, dtype=None):
        if isinstance(parts, np.ndarray):
            parts = [parts]
        parts = [np.asarray(p) for p in parts]
        dtype = np.dtype(dtype) if dtype is not None else \
            np.result_type(*[p.dtype for p in parts])
        n = sum(int(p.shape[0]) for p in parts)
        nbytes = n * dtype.itemsize
        if profile is not None:
            profile.h2d_bytes += nbytes
        M.STAGED_H2D_BYTES.inc(nbytes)
        block_rows = max(1, block_bytes // dtype.itemsize)
        if n > 2 * block_rows:
            MEMORY_LEDGER.record_event("reserve", POOL_DEVICE, "staging", nbytes)
            try:
                if device.type != "cuda":
                    return _host_copy(parts, dtype, device)
                out, blocks = _blocked_copy(parts, dtype, n, device, block_rows,
                                            _pinned_pair(device, block_bytes))
                if profile is not None:
                    profile.transfer_blocks += blocks
                return out
            finally:
                MEMORY_LEDGER.record_event("release", POOL_DEVICE, "staging", nbytes)
        if device.type != "cuda":
            return _host_copy(parts, dtype, device)
        # at most two blocks: one plain copy a part, into its slice
        out = torch.empty((n,), dtype=torch_dtype(dtype), device=device)
        off = 0
        for p in parts:
            if len(p):
                host = np.ascontiguousarray(p, dtype=dtype)
                if not host.flags.writeable:
                    host = host.copy()
                out[off:off + len(p)].copy_(torch.from_numpy(host))
            off += len(p)
        return out

    return transfer


def page_from_split_columns(column_types, cols, transfer, device):
    """``split_columns`` -> device Page, each array through ``transfer``."""
    from trino_tpu_torch.data.page import Column, Page

    if cols is None:
        return Page.all_dead(column_types, device)

    def nested(cd):
        return Column(cd.type, transfer(cd.values),
                      transfer(cd.nulls) if cd.nulls is not None else None,
                      cd.dictionary, cd.vrange,
                      hi=transfer(cd.hi) if cd.hi is not None else None,
                      children=[nested(k) for k in cd.children]
                      if cd.children is not None else None)

    return Page([nested(c) if typ.is_nested else Column(
        typ,
        transfer(c.values, device_dtype(c)),
        transfer(c.nulls) if c.nulls is not None else None,
        c.dictionary,
        c.vrange,
        ascending=c.sorted,
        hi=transfer(c.hi) if c.hi is not None else None,
    ) for typ, c in zip(column_types, cols)])


def staged_scan_page(session, node, conn, splits, constraint,
                     prune: Optional[Callable] = None,
                     applied_domains: Optional[Dict] = None,
                     ) -> Tuple[object, int, StageProfile]:
    """The whole pipeline for one scan: parallel split reads (host tier
    consulted per split) -> per-column dictionary merge -> each split's
    arrays copied into its slice of the session's device columns. Returns ``(Page, scanned_rows, StageProfile)``; the
    loader behind every device-cache miss."""
    datas, prof = stage_splits(session, node, conn, splits, constraint,
                               prune=prune, applied_domains=applied_domains)
    scanned = sum(
        len(next(iter(d.values())).values) if d else 0 for d in datas)
    t0 = time.perf_counter()
    with tracing.span("staging/decode", table=node.table) as sp:
        cols = split_columns(node.column_names, node.column_types, datas)
        prof.decode_wall_s = time.perf_counter() - t0
        sp.set("rows", scanned)
    M.STAGING_PHASE_SECONDS.inc(prof.decode_wall_s, "decode")
    t0 = time.perf_counter()
    with tracing.span("staging/transfer", table=node.table) as sp:
        page = page_from_split_columns(
            node.column_types, cols,
            blocked_transfer(session.device, prof), session.device)
        prof.transfer_wall_s = time.perf_counter() - t0
        sp.set("blocks", prof.transfer_blocks)
    M.STAGING_PHASE_SECONDS.inc(prof.transfer_wall_s, "transfer")
    M.STAGED_ROWS.inc(scanned)
    return page, scanned, prof
