"""Worker task engine: task lifecycle + fragment execution.

The port of trino_tpu/server/task.py (reference:
``execution/SqlTaskManager.java:109``, ``SqlTaskExecution.java:85``, the
``TaskState`` machine). One task runs one plan fragment through the port's
executor on the worker's device: a bulk body, or the streaming shapes (a
scan fragment a split at a time; a row-local or partial-aggregation chain
a micro-batch at a time; a hash-distributed final aggregation folding its
arriving partial states through the intermediate merge).

A task's output leaves the device once: the result page is compacted on
the card and each column copied to the host (``serde.host_page``), then
partitioned (salted where the adaptive re-planner marked the producer: hot
partitions spread over every partition, or replicated into each), cut
into size-bounded chunks and serialized on the host into the output buffer.

Each retired executor folds its per-operator stats and kernel-ledger rows
into the task; ``stats_snapshot`` ships them with the task's counts, peak
bytes, the device-cache bytes shed on its behalf and per-partition output
rows and bytes (the reference's wire shape), read from host numbers only:
a status poll runs on the worker's HTTP thread while the task's thread
launches work. Each rise of the task's peak is a memory-ledger
``reserve`` event of its query (``query:<id>``), released when the task
ends; ``TaskManager.query_memory`` is the worker's per-query reservation
that its announce carries to the coordinator's cluster memory manager.

Not ported: the fault-tolerant tier (spooled task output, retries), the
spooled result segments and the flow ledger; the coordinator refuses the
session properties that ask for them.
"""
from __future__ import annotations

import dataclasses
import pickle
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from trino_tpu_torch.data.page import Page, to_numpy
from trino_tpu_torch.data.serde import compact_on_device, host_page, serialize_page
from trino_tpu_torch.exec.executor import Executor
from trino_tpu_torch.exec.memory import page_bytes
from trino_tpu_torch.exec.operator_stats import OperatorStats
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs.devprofiler import merge_kernel_rows
from trino_tpu_torch.obs.memledger import MEMORY_LEDGER, POOL_DEVICE
from trino_tpu_torch.server.buffer import (DEFAULT_MAX_BUFFER_BYTES, OutputBuffer,
                                           PartitionedOutputBuffer)
from trino_tpu_torch.server.statemachine import StateMachine, task_state_machine
from trino_tpu_torch.sql.planner import plan as P
from trino_tpu_torch.sql.planner.fragmenter import RemoteSourceNode


@dataclasses.dataclass
class TaskRequest:
    """Everything a worker needs to run one task (pickled; reference:
    TaskUpdateRequest posted to POST /v1/task/{taskId}). The fragment is a
    plan tree of host objects: no plan node carries a tensor."""

    task_id: str
    query_id: str
    fragment_root: P.PlanNode
    splits: Dict[int, List]  # scan plan-node id -> [Split]
    upstream: Dict[int, List]  # fragment id -> [(base_url, task_id, buffer_id)]
    session_properties: Dict[str, object]
    # downstream consumers that will pull this task's output
    consumer_count: int = 1
    # set: the output is hash-partitioned by these channels into
    # consumer_count distinct streams, consumer i pulling partition i
    output_partition_channels: Optional[List[int]] = None
    # adaptive skew mitigation (adaptive/replanner.py): hot partitions whose
    # rows this producer spreads over every partition (the probe side of a
    # salted repartition join) or replicates into every partition (the
    # build side); parallel/exchange.spread_partition_ids has the argument
    skew_spread_partitions: Optional[List[int]] = None
    skew_replicate_partitions: Optional[List[int]] = None
    # the per-operator stats EXPLAIN ANALYZE reads (Executor collect_stats):
    # one batched device read of live row counts an executor
    collect_stats: bool = False

    def to_bytes(self) -> bytes:
        return pickle.dumps(self)

    @staticmethod
    def from_bytes(data: bytes) -> "TaskRequest":
        return pickle.loads(data)


class FragmentExecutor(Executor):
    """Executes one plan fragment: scans read only the task's assigned
    splits; RemoteSourceNodes read the pages pulled from upstream tasks."""

    def __init__(self, session, splits: Dict[int, List], remote_pages: Dict[int, List[Page]],
                 collect_stats: Optional[bool] = None):
        super().__init__(session, collect_stats=collect_stats)
        self._splits = splits
        self._remote_pages = remote_pages

    def _exec_TableScanNode(self, node: P.TableScanNode) -> Page:
        from trino_tpu_torch import devcache
        from trino_tpu_torch.exec import memory as _mem
        from trino_tpu_torch.exec import staging
        from trino_tpu_torch.exec.executor import scan_constraint_with

        conn = self.session.catalogs[node.catalog]
        splits = self._splits.get(node.id, [])
        # the coordinator applied the static constraint when it chose the
        # splits; domains collected in this fragment still narrow the scan
        constraint = scan_constraint_with(node, self.dyn_domains)

        def load():
            t0 = time.perf_counter()
            page, rows, _prof = staging.staged_scan_page(
                self.session, node, conn, splits, constraint)
            M.STAGING_SECONDS.inc(time.perf_counter() - t0)
            return page, rows, _mem.page_bytes(page), len(splits)

        # the task's split set is the cache entry's shard: the next query
        # over the same splits finds it warm
        ent, disposition = devcache.cached_stage(
            self.session, node, constraint, {}, devcache.splits_shard(splits), load)
        self.scan_stats[node.id] = ent.rows
        self.scan_cache[node.id] = disposition
        if self.collect_stats:
            self._pending_scan[node.id] = (len(splits), ent.rows)
        return ent.value

    def _exec_RemoteSourceNode(self, node: RemoteSourceNode) -> Page:
        pages = [p for p in self._remote_pages.get(node.fragment_id, []) if p.num_rows > 0]
        if not pages:
            return Page.all_dead(node.types, self.device)
        page = pages[0]
        for p in pages[1:]:
            page = Page.concat_pages(page, p)
        return page


def _concat(pages: List[Page]) -> Page:
    page = pages[0]
    for p in pages[1:]:
        page = Page.concat_pages(page, p)
    return page


class SqlTask:
    """One task: state machine + executor thread + output buffer.
    PLANNED -> RUNNING -> FLUSHING (body done, buffer draining) ->
    FINISHED (TaskState.java:21)."""

    def __init__(self, request: TaskRequest, session_factory):
        self.request = request
        self.state: StateMachine[str] = task_state_machine()
        sink_max = int(request.session_properties.get("sink_max_buffer_bytes")
                       or DEFAULT_MAX_BUFFER_BYTES)
        if request.output_partition_channels is not None:
            self.output = PartitionedOutputBuffer(request.consumer_count,
                                                  max_buffer_bytes=sink_max)
        else:
            self.output = OutputBuffer(request.consumer_count, max_buffer_bytes=sink_max)
        self.failure: Optional[str] = None
        # the largest peak of this task's executors (they run one after
        # another), and the one running now
        self.peak_memory_bytes = 0
        self._live_executor = None
        # task-level stats (reference: TaskStats and the OperatorStats it
        # aggregates): retired executors fold their node stats and kernel
        # rows in under _stats_lock, and status reads snapshot the same way
        self.operator_stats: Dict[int, OperatorStats] = {}
        self.kernel_stats: Dict[tuple, dict] = {}
        self._stats_lock = threading.Lock()
        self.total_splits = sum(len(v) for v in request.splits.values())
        self.splits_completed = 0
        self.device_seconds = 0.0
        self.input_rows = 0
        self.output_rows = 0
        self.output_bytes = 0
        # live output rows a partition (hash-partitioned producers): the
        # skew signal, counted before serialization (compression flattens a
        # constant hot key to almost no bytes) and before replication
        self.partition_rows: Optional[List[int]] = None
        self.spill_count = 0
        # device-cache bytes shed on this task's behalf, and the yields
        self.shed_bytes = 0
        self.yield_events = 0
        # the bytes a FLUSHING task still holds: its last output page
        self.flushing_bytes = 0
        self.device_cache_hits = 0
        self.device_cache_misses = 0
        self._exchange_clients: List = []
        self._vocab_hash_cache: dict = {}
        # the salted spread's round-robin cursor, carried across pages
        self._spread_cursor = 0
        self.started_at = time.monotonic()
        self.ended_at: Optional[float] = None
        self._session_factory = session_factory
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"task:{request.task_id}")

    def _executor(self, session, splits, remote_pages) -> "FragmentExecutor":
        """A fragment executor of this task, tracked for its peak bytes."""
        ex = FragmentExecutor(session, splits, remote_pages,
                              collect_stats=self.request.collect_stats or None)
        self._live_executor = ex
        return ex

    def _retire_executor(self, ex, splits: int = 0, input_rows: int = 0,
                         device_s: float = 0.0) -> None:
        """Fold a finished executor's per-operator stats, kernel rows and
        counts into the task's (one executor a bulk body, a split or a
        streaming batch: the sums stay additive over all three)."""
        if ex.collect_stats:
            ex.resolve_stats()  # stats recorded outside execute_checked
        M.DEVICE_SECONDS.inc(device_s)
        with self._stats_lock:
            # the task's peak is the max over its executors (they run one
            # after another), so the ledger gets the rise only
            delta = max(0, ex.memory.peak - self.peak_memory_bytes)
            self.peak_memory_bytes += delta
            self.shed_bytes += ex.memory.shed_bytes
            self.yield_events += ex.memory.yields
            for nid, st in ex.node_stats.items():
                have = self.operator_stats.get(nid)
                if have is None:
                    self.operator_stats[nid] = dataclasses.replace(st)
                else:
                    have.add(st)
            merge_kernel_rows(self.kernel_stats, list(ex.kernel_stats.values()))
            # the fragment body is the device execution: its wall is the
            # fragment root's device seconds
            root_st = self.operator_stats.get(self.request.fragment_root.id)
            if root_st is not None:
                root_st.device_s += device_s
            self.device_seconds += device_s
            self.splits_completed += splits
            self.input_rows += input_rows
            self.spill_count += len(ex.memory.spills)
            self.device_cache_hits += sum(1 for d in ex.scan_cache.values() if d == "hit")
            self.device_cache_misses += sum(1 for d in ex.scan_cache.values() if d == "miss")
        if delta:
            MEMORY_LEDGER.record_event("reserve", POOL_DEVICE,
                                       f"query:{self.request.query_id}", delta)

    @property
    def memory_bytes(self) -> int:
        """The task's reservation for cluster memory management: its
        executors' peak while the body runs; once the body is done
        (FLUSHING), what the drain still holds (the last output page and
        the buffered frames); 0 once terminal."""
        state = self.state.get()
        if state in ("FINISHED", "FAILED", "CANCELED"):
            return 0
        if state not in ("PLANNED", "RUNNING"):
            return int(self.flushing_bytes + self.output.buffered_bytes)
        live = self._live_executor
        return max(self.peak_memory_bytes, live.memory.peak if live is not None else 0)

    def stats_snapshot(self) -> dict:
        """Point-in-time task stats (``GET /v1/task/{id}/status``): the wire
        shape the coordinator's stage and query rollups read. Host numbers
        only."""
        live = self._live_executor
        peak = max(self.peak_memory_bytes, live.memory.peak if live is not None else 0)
        # per-partition output bytes of a hash-partitioned producer
        part_bytes = (self.output.partition_enqueued_bytes
                      if isinstance(self.output, PartitionedOutputBuffer) else None)
        transfer_s = sum(c.pulled_seconds for c in self._exchange_clients)
        # backpressure: the producer's full-waits and the pullers' empty polls
        stall_s = self.output.stalled_seconds + sum(
            c.stalled_seconds for c in self._exchange_clients)
        with self._stats_lock:
            elapsed = (self.ended_at or time.monotonic()) - self.started_at
            snap = {
                "elapsedS": round(elapsed, 6),
                "deviceS": round(self.device_seconds, 6),
                "transferS": round(transfer_s, 6),
                "stallS": round(stall_s, 6),
                "completedSplits": self.splits_completed,
                "totalSplits": self.total_splits,
                "inputRows": self.input_rows,
                "outputRows": self.output_rows,
                "outputBytes": self.output_bytes,
                "peakBytes": peak,
                "spills": self.spill_count,
                "shedBytes": self.shed_bytes,
                "yieldEvents": self.yield_events,
                "deviceCacheHits": self.device_cache_hits,
                "deviceCacheMisses": self.device_cache_misses,
                "operatorStats": [self.operator_stats[k].to_dict()
                                  for k in sorted(self.operator_stats)],
                "kernelStats": [dict(self.kernel_stats[k]) for k in sorted(self.kernel_stats)],
            }
            if part_bytes is not None:
                snap["partitionBytes"] = part_bytes
            if self.partition_rows is not None:
                snap["partitionRows"] = list(self.partition_rows)
            return snap

    def start(self) -> None:
        if self.state.compare_and_set("PLANNED", "RUNNING"):
            self._thread.start()

    def _run(self) -> None:
        try:
            self._run_body()
        except Exception as e:  # noqa: BLE001 — reported through task status
            self.failure = f"{e}\n{traceback.format_exc()}"
            self.output.abort(str(e))
            self.state.set("FAILED")
        finally:
            self.ended_at = time.monotonic()
            if self.peak_memory_bytes:
                MEMORY_LEDGER.record_event("release", POOL_DEVICE,
                                           f"query:{self.request.query_id}",
                                           self.peak_memory_bytes, reason="done")

    def _exchange_client(self, locations, device):
        from trino_tpu_torch.server.exchange_client import ExchangeClient, TaskLocation

        client = ExchangeClient([TaskLocation(u, t, b) for u, t, b in locations],
                                device=device)
        with self._stats_lock:
            self._exchange_clients.append(client)
        client.start()
        return client

    def _run_body(self) -> None:
        req = self.request
        session = self._session_factory(req.session_properties)
        if self._try_streaming(req, session):
            return
        # bulk body: pull every upstream fragment first (joins, final
        # aggregations and sorts need their whole input)
        remote_pages: Dict[int, List[Page]] = {
            fid: self._exchange_client(locations, session.device).pages()
            for fid, locations in req.upstream.items()}
        ex = self._executor(session, req.splits, remote_pages)
        t0 = time.perf_counter()
        page = ex.execute_checked(req.fragment_root)
        device_s = time.perf_counter() - t0
        remote_rows = sum(p.num_rows for pages in remote_pages.values() for p in pages)
        self._retire_executor(ex, splits=self.total_splits,
                              input_rows=sum(ex.scan_stats.values()) + remote_rows,
                              device_s=device_s)
        prepared = self._prepare_out(page)
        self.state.set("FLUSHING")
        self._emit(prepared)
        self.output.set_complete()
        self.state.set("FINISHED")

    # ------------------------------------------------------- streaming loop
    @staticmethod
    def _streamable_leaf(root: P.PlanNode, leaf_type):
        """The single ``leaf_type`` leaf of a fragment whose every operator
        is row-local or a partial aggregation (running it per batch and
        concatenating the outputs equals one bulk run), else None."""
        node = root
        while True:
            if isinstance(node, leaf_type):
                return node
            if isinstance(node, (P.FilterNode, P.ProjectNode, P.CompactNode)):
                node = node.source
                continue
            if isinstance(node, P.AggregationNode) and node.step == "partial":
                node = node.source
                continue
            return None

    @staticmethod
    def _streaming_final_agg(root: P.PlanNode):
        """(final aggregation, its RemoteSourceNode) when the fragment is a
        final aggregation whose states the intermediate fold merges."""
        if not (isinstance(root, P.AggregationNode) and root.step == "final"
                and isinstance(root.source, RemoteSourceNode)):
            return None
        for call in root.aggregates:
            if call.distinct or call.function not in Executor.MERGEABLE_STATE_FNS:
                return None
        return root, root.source

    # pages accumulate to at least this many rows before the fragment body
    # runs over the batch
    STREAM_BATCH_ROWS = 65536

    def _partition_pages(self, page: Page) -> List[Page]:
        """Hash-partition a compacted host page into consumer_count pages
        (one hash pass; the per-vocabulary hashes are cached across the
        task's pages), salted where the re-planner marked this producer:
        hot partitions' rows spread over every partition (the cursor
        carried across pages), or hot partitions replicated into every
        other. The skew accounting counts the pid array after the spread
        and before the replication, so copies do not inflate the signal."""
        from trino_tpu_torch.exec.memory import partition_page_host

        req = self.request
        t0 = time.perf_counter()
        pids = _canonical_partition_ids(page, req.output_partition_channels,
                                        req.consumer_count, vocab_cache=self._vocab_hash_cache)
        if req.skew_spread_partitions:
            from trino_tpu_torch.parallel.exchange import spread_partition_ids

            pids, self._spread_cursor = spread_partition_ids(
                pids, req.skew_spread_partitions, req.consumer_count, start=self._spread_cursor)
        parts = partition_page_host(page, req.output_partition_channels,
                                    req.consumer_count, pid=pids)
        counts = np.bincount(pids, minlength=req.consumer_count)
        if req.skew_replicate_partitions:
            hot = [parts[h] for h in req.skew_replicate_partitions
                   if 0 <= h < len(parts) and counts[h] > 0]
            parts = [_concat([part] + [hp for hp in hot if hp is not part]) for part in parts]
        with self._stats_lock:
            if self.partition_rows is None:
                self.partition_rows = [0] * req.consumer_count
            for pid in range(req.consumer_count):
                self.partition_rows[pid] += int(counts[pid])
        M.PARTITION_SECONDS.inc(time.perf_counter() - t0)
        return parts

    def _prepare_out(self, out: Page):
        """An output page to the host once, counted (output rows and bytes,
        rows a partition) and partitioned where the output is: (host page,
        its partitions or None), or None when it holds no row. A body's
        last page is prepared before FLUSHING, so a FLUSHING task's output
        numbers are final (the adaptive rules read them then)."""
        out = host_page(out)
        if out.num_rows == 0:
            return None
        nbytes = page_bytes(out)
        with self._stats_lock:
            self.flushing_bytes = nbytes
            self.output_rows += out.num_rows
            self.output_bytes += nbytes
        if self.request.output_partition_channels is None:
            return out, None
        return out, self._partition_pages(out)

    def _emit(self, prepared) -> None:
        """Cut a prepared page into chunks, serialize them and enqueue them
        (enqueue blocks at the buffer's watermark)."""
        if prepared is None:
            return
        out, parts = prepared
        chunk_rows = self._chunk_rows(out)
        if parts is not None:
            for pid, part in enumerate(parts):
                for c in _chunk_pages(host_page(part), chunk_rows):
                    self.output.enqueue_partition(pid, serialize_page(c))
        else:
            for c in _chunk_pages(out, chunk_rows):
                self.output.enqueue(serialize_page(c))

    def _enqueue_out(self, out: Page) -> None:
        """One output page into the buffer: prepared, then emitted."""
        self._emit(self._prepare_out(out))

    def _finish(self) -> None:
        self.state.set("FLUSHING")
        self.output.set_complete()
        self.state.set("FINISHED")

    def _try_split_streaming(self, req: TaskRequest, session) -> bool:
        """Run a scan-rooted streamable fragment one split at a time,
        enqueueing each split's output as it completes."""
        scan = self._streamable_leaf(req.fragment_root, P.TableScanNode)
        if scan is None or scan.id not in req.splits:
            return False
        splits = req.splits[scan.id]
        if len(splits) <= 1:
            return False
        for split in splits:
            ex = self._executor(session, {scan.id: [split]}, {})
            t0 = time.perf_counter()
            out = ex.execute_checked(req.fragment_root)
            split_s = time.perf_counter() - t0
            self._retire_executor(ex, splits=1, input_rows=sum(ex.scan_stats.values()),
                                  device_s=split_s)
            self._enqueue_out(out)
        self._finish()
        return True

    def _try_streaming(self, req: TaskRequest, session) -> bool:
        """Micro-batch driver for streamable consumer fragments: pull from
        the one upstream, run the fragment a batch at a time and enqueue
        each batch's output at once (a final aggregation folds its states
        instead). False where the fragment needs the bulk path."""
        if not req.upstream and len(req.splits) == 1:
            return self._try_split_streaming(req, session)
        final_agg = self._streaming_final_agg(req.fragment_root)
        src = (final_agg[1] if final_agg is not None
               else self._streamable_leaf(req.fragment_root, RemoteSourceNode))
        if src is None or len(req.upstream) != 1 or req.splits:
            return False
        locations = req.upstream.get(src.fragment_id)
        if locations is None:
            return False
        client = self._exchange_client(locations, session.device)

        def batches():
            batch: List[Page] = []
            rows = 0
            for page in client.iter_pages():
                if page.num_rows == 0:
                    continue
                batch.append(page)
                rows += page.num_rows
                if rows >= self.STREAM_BATCH_ROWS:
                    yield batch, rows
                    batch, rows = [], 0
            if batch:
                yield batch, rows

        def timed(ex, fn, *args, input_rows=0):
            t0 = time.perf_counter()
            out = fn(*args)
            ex.raise_errors()
            self._retire_executor(ex, input_rows=input_rows,
                                  device_s=time.perf_counter() - t0)
            return out

        if final_agg is not None:
            node = final_agg[0]

            def folded(ex, fn, page, in_rows, is_final=False):
                """aggregate_intermediate/final outside ``execute``: the
                aggregation's stats by hand, its output rows (the live rows
                of the finalization only) read with the executor's batch."""
                t0 = time.perf_counter()
                out = compact_on_device(fn(node, page))
                ex.raise_errors()
                wall_s = time.perf_counter() - t0
                if ex.collect_stats:
                    st = ex.node_stats.setdefault(node.id, OperatorStats(node.id, "Aggregation"))
                    st.wall_s += wall_s
                    st.input_rows += in_rows
                    st.invocations += 1
                    if is_final:
                        ex._row_terms.append((st, "output_rows", out.num_rows))
                        st.output_bytes += page_bytes(out)
                self._retire_executor(ex, input_rows=0 if is_final else in_rows,
                                      device_s=wall_s)
                return out

            running: Optional[Page] = None
            for batch, rows in batches():
                page = _concat(batch if running is None else [running] + batch)
                ex = self._executor(session, {}, {})
                running = folded(ex, ex.aggregate_intermediate, page, rows)
            if running is None:
                running = Page.all_dead(src.types, session.device)
            ex = self._executor(session, {}, {})
            out = folded(ex, ex.aggregate_final, running, running.num_rows, is_final=True)
            prepared = self._prepare_out(out)
            self.state.set("FLUSHING")
            self._emit(prepared)
            self._finish()
            return True
        for batch, rows in batches():
            ex = self._executor(session, {}, {src.fragment_id: [_concat(batch)]})
            self._enqueue_out(timed(ex, ex.execute_checked, req.fragment_root, input_rows=rows))
        self._finish()
        return True

    # target serialized bytes of an output chunk
    DEFAULT_CHUNK_BYTES = 4 << 20

    def _chunk_rows(self, page: Page) -> int:
        target = int(self.request.session_properties.get("task_output_chunk_bytes")
                     or self.DEFAULT_CHUNK_BYTES)
        return max(1, target // page.row_byte_estimate()) if page.num_rows else 1

    def info(self) -> dict:
        return {
            "taskId": self.request.task_id,
            "state": self.state.get(),
            "failure": self.failure,
            "bufferedBytes": self.output.buffered_bytes,
            "memoryBytes": self.memory_bytes,
            "stats": self.stats_snapshot(),
        }


def _chunk_pages(page: Page, chunk_rows: int):
    """Size-bounded row slices of a compacted page (nothing for an empty
    one: downstream reads absence as zero rows)."""
    n = page.num_rows
    if n == 0:
        return
    for lo in range(0, n, chunk_rows):
        yield page.slice_rows(lo, min(n, lo + chunk_rows))


_VOCAB_CACHE_MAX = 8  # distinct vocabularies a producer realistically shares


def _canonical_partition_ids(page: Page, channels, parts: int, vocab_cache=None) -> np.ndarray:
    """Per-row partition ids that agree across producer processes: a
    varchar key hashes its string (blake2b-8 a vocabulary entry, the codes
    mapped through that table), other keys their low word (splitmix64),
    as the reference does. ``vocab_cache`` keeps the tables of a few
    vocabularies across a producer's pages."""
    import hashlib

    from trino_tpu_torch.exec.memory import _NULL_HASH, _mix64_np

    def _vocab_hashes(d):
        if vocab_cache is not None:
            hit = vocab_cache.get(id(d))
            if hit is not None and hit[0] is d:
                return hit[1]
        table = np.array(
            [int.from_bytes(hashlib.blake2b(v.encode(), digest_size=8).digest(), "little")
             for v in d.values] or [0],
            dtype=np.uint64)
        if vocab_cache is not None:
            while len(vocab_cache) >= _VOCAB_CACHE_MAX:
                vocab_cache.pop(next(iter(vocab_cache)))
            vocab_cache[id(d)] = (d, table)
        return table

    n = page.num_rows
    h = np.zeros(n, np.uint64)
    for ch in channels:
        col = page.columns[ch]
        if col.type.is_varchar and col.dictionary is not None:
            vocab_hash = _vocab_hashes(col.dictionary)
            codes = to_numpy(col.values)
            k = vocab_hash[np.clip(codes, 0, len(vocab_hash) - 1)]
            k = np.where(codes < 0, np.uint64(_NULL_HASH), k)
        else:
            k = _mix64_np(to_numpy(col.values).astype(np.int64))
        if col.nulls is not None:
            k = np.where(to_numpy(col.nulls), np.uint64(_NULL_HASH), k)
        h = _mix64_np(h ^ k)
    return (h % np.uint64(parts)).astype(np.int64)


class TaskManager:
    """All tasks on this worker (reference: SqlTaskManager.java:109)."""

    MAX_TASK_HISTORY = 200  # terminal tasks kept for status queries

    def __init__(self, session_factory, recorder=None):
        self._tasks: Dict[str, SqlTask] = {}
        self._lock = threading.Lock()
        self._session_factory = session_factory
        # the worker's flight recorder (obs/flightrecorder.py)
        self._recorder = recorder

    def create_task(self, request: TaskRequest) -> SqlTask:
        with self._lock:
            terminal = [tid for tid, t in self._tasks.items() if t.state.is_terminal()]
            for tid in terminal[: max(0, len(terminal) - self.MAX_TASK_HISTORY)]:
                del self._tasks[tid]
            task = self._tasks.get(request.task_id)
            created = task is None
            if created:
                task = SqlTask(request, self._session_factory)
                self._tasks[request.task_id] = task
        if created:
            M.TASKS_TOTAL.inc()
            if self._recorder is not None:
                self._recorder.record("event", "task-created", taskId=request.task_id,
                                      queryId=request.query_id)
        task.start()
        return task

    def get(self, task_id: str) -> Optional[SqlTask]:
        with self._lock:
            return self._tasks.get(task_id)

    def cancel(self, task_id: str) -> None:
        with self._lock:
            task = self._tasks.pop(task_id, None)
        if task is not None:
            task.output.abort("canceled")
            task.state.set("CANCELED")
            if self._recorder is not None:
                self._recorder.record("event", "task-canceled", taskId=task_id,
                                      queryId=task.request.query_id)

    def list_info(self) -> List[dict]:
        with self._lock:
            tasks = list(self._tasks.values())
        return [t.info() for t in tasks]

    def query_memory(self) -> Dict[str, int]:
        """Reserved bytes a query on this worker (``SqlTask.memory_bytes``
        summed over its live tasks): the node's half of the cluster memory
        pool."""
        with self._lock:
            tasks = list(self._tasks.values())
        out: Dict[str, int] = {}
        for t in tasks:
            if t.state.is_terminal():
                continue
            qid = t.request.query_id
            out[qid] = out.get(qid, 0) + t.memory_bytes
        return out
