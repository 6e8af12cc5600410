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

A task's spans (``task``, then ``device/staging`` a scan and
``device/execute`` a body, its pulls' ``exchange/pull``) join the query's
trace under the coordinator's schedule span, named in the traceparent
header of the task's creation; ``GET /v1/task/{id}/spans`` serves them and,
with an OTLP exporter, the finished task ships them to the collector. Its
pulls and its output buffer's full-waits are flow-ledger records labelled
with its stage. At its end, its operators' walls and rows feed the
per-operator series.

With ``TRINO_TPU_SPOOL_DIR`` set (the fault-tolerant tier's durable
exchange), a task runs its bulk body only and spools its whole output
before any of it is visible: ``{task}.pages``, or ``{task}.p{pid}.pages`` a
partition, each written to a ``.tmp`` file and published by ``os.replace``
(the frames of the exchange wire, so either package reads the other's
files). A canceled attempt publishes nothing: the check and the rename run
under the lock its cancel takes. A task that produces the query's result
under the spooled result protocol (``TaskRequest.spool_results``) writes
size-bounded segments into the worker's segment store
(server/segments.py) instead of its output buffer; ``info()`` carries their
manifest entries.
"""
from __future__ import annotations

import dataclasses
import os
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
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.obs.devprofiler import merge_kernel_rows
from trino_tpu_torch.obs.memledger import MEMORY_LEDGER, POOL_DEVICE
from trino_tpu_torch.server import wire
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
    # the spooled result protocol: this task produces the query's result,
    # and its output rolls into size-bounded segments in the worker's
    # segment store instead of the output buffer (the coordinator collects
    # their manifest entries from task status and never pulls the data).
    # Set only on the root fragment's gather producers
    spool_results: bool = False

    def to_bytes(self) -> bytes:
        return pickle.dumps(self)

    @staticmethod
    def from_bytes(data: bytes) -> "TaskRequest":
        return pickle.loads(data)


class FragmentExecutor(Executor):
    """Executes one plan fragment: scans read only the task's assigned
    splits; RemoteSourceNodes read the pages pulled from upstream tasks."""

    def __init__(self, session, splits: Dict[int, List], remote_pages: Dict[int, List[Page]]):
        super().__init__(session)
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

        with tracing.span("device/staging", table=node.table, splits=len(splits)) as sp:
            # the task's split set is the cache entry's shard: the next
            # query over the same splits finds it warm
            ent, disposition = devcache.cached_stage(
                self.session, node, constraint, {}, devcache.splits_shard(splits), load)
            # a warm scan staged nothing
            sp.set("staged_rows", 0 if disposition == "hit" else ent.rows)
            sp.set("cache", disposition)
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

    def __init__(self, request: TaskRequest, session_factory,
                 traceparent: Optional[str] = None, recorder=None, otlp=None,
                 segment_store=None):
        self.request = request
        self.state: StateMachine[str] = task_state_machine()
        # the worker's half of the query's trace: its trace id, the spans
        # rooted under the coordinator's propagated (schedule) span; no
        # header starts a detached trace (a task posted directly)
        ctx = tracing.parse_traceparent(traceparent)
        self.tracer = tracing.Tracer(trace_id=ctx[0] if ctx else None,
                                     root_parent_id=ctx[1] if ctx else None)
        # closed spans mirror into the worker's flight recorder; the
        # finished task's spans go to the OTLP exporter when there is one
        self.tracer.recorder = recorder
        self._otlp = otlp
        sink_max = int(request.session_properties.get("sink_max_buffer_bytes")
                       or DEFAULT_MAX_BUFFER_BYTES)
        # the flow ledger's stall samples carry this task's stage
        self.stage_id = _task_stage_id(request.task_id)
        if request.output_partition_channels is not None:
            self.output = PartitionedOutputBuffer(request.consumer_count,
                                                  max_buffer_bytes=sink_max,
                                                  stall_stage=self.stage_id)
        else:
            self.output = OutputBuffer(request.consumer_count, max_buffer_bytes=sink_max,
                                       stall_key=(self.stage_id, None))
        # the spooled result protocol: a result-producing task's chunks roll
        # into segments of the worker's store, and result_segments holds
        # their manifest entries once the writer is sealed
        self._result_writer = None
        self.result_segments: List[dict] = []
        if (request.spool_results and segment_store is not None
                and request.output_partition_channels is None):
            from trino_tpu_torch.server.segments import DEFAULT_SEGMENT_BYTES

            props = request.session_properties
            self._result_writer = segment_store.writer(
                request.query_id,
                target_bytes=int(props.get("spooled_results_segment_bytes")
                                 or DEFAULT_SEGMENT_BYTES),
                ttl_s=int(props.get("result_segment_ttl_ms") or 300_000) / 1e3)
        # held by cancel() and by each spool file's publish, so a canceled
        # attempt never publishes a file after its cancel returned
        self._publish_lock = threading.Lock()
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
        ex = FragmentExecutor(session, splits, remote_pages)
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
        task_span = self.tracer.start_span("task", task_id=self.request.task_id,
                                           query_id=self.request.query_id)
        try:
            with tracing.activate(self.tracer, task_span.span_id):
                self._run_body()
        except Exception as e:  # noqa: BLE001 — reported through task status
            self.failure = f"{e}\n{traceback.format_exc()}"
            task_span.set("error", str(e).split("\n")[0][:300])
            if self._result_writer is not None:
                # no manifest will point at a failed attempt's segments
                self._result_writer.abandon()
            self.output.abort(str(e))
            self.state.set("FAILED")
        finally:
            self.ended_at = time.monotonic()
            # its stats are folded: the worker's task history keeps no
            # executor, and so none of its inputs' device tensors
            self._live_executor = None
            self._observe_operator_metrics()
            if self.peak_memory_bytes:
                MEMORY_LEDGER.record_event("release", POOL_DEVICE,
                                           f"query:{self.request.query_id}",
                                           self.peak_memory_bytes, reason="done")
            task_span.set("state", self.state.get())
            self.tracer.end_span(task_span)
            if self._otlp is not None:
                self._otlp.export_spans(
                    self.tracer.to_dicts(), self.tracer.trace_id,
                    {"query_id": self.request.query_id, "task_id": self.request.task_id,
                     "task.state": self.state.get()})

    def _observe_operator_metrics(self) -> None:
        """The per-operator-kind series from the task's accumulated stats,
        once, at its end."""
        with self._stats_lock:
            snapshot = [(st.operator, st.wall_s, st.output_rows)
                        for st in self.operator_stats.values()]
        for operator, wall_s, rows in snapshot:
            M.OPERATOR_WALL_SECONDS.observe(wall_s, operator)
            if rows:
                M.OPERATOR_ROWS.inc(rows, operator)

    def _exchange_client(self, locations, device):
        from trino_tpu_torch.server.exchange_client import ExchangeClient, TaskLocation

        client = ExchangeClient([TaskLocation(u, t, b) for u, t, b in locations],
                                device=device, owner=f"task:{self.request.task_id}",
                                stall_key=(self.stage_id, None))
        with self._stats_lock:
            self._exchange_clients.append(client)
        client.start()
        return client

    def _run_body(self) -> None:
        req = self.request
        # fault injection, keyed by a substring of the task id (the
        # reference's FailureInjector): ``failure_injection`` fails the
        # task, ``slow_injection`` ("substr:seconds") delays it
        inject = str(req.session_properties.get("failure_injection") or "")
        if inject and inject in req.task_id:
            raise RuntimeError(f"injected failure for {req.task_id}")
        slow = str(req.session_properties.get("slow_injection") or "")
        if slow:
            sub, _, secs = slow.partition(":")
            if sub and sub in req.task_id:
                # a cancel ends the wait: a speculative attempt's canceled
                # twin never runs its body afterwards
                if self.state.wait_for_terminal(float(secs or "5")) == "CANCELED":
                    return
        session = self._session_factory(req.session_properties)
        if self._try_streaming(req, session):
            return
        # bulk body: pull every upstream fragment first (joins, final
        # aggregations and sorts need their whole input)
        remote_pages: Dict[int, List[Page]] = {
            fid: self._exchange_client(locations, session.device).pages()
            for fid, locations in req.upstream.items()}
        ex = self._executor(session, req.splits, remote_pages)
        with tracing.span("device/execute") as sp:
            t0 = time.perf_counter()
            page = ex.execute_checked(req.fragment_root)
            device_s = time.perf_counter() - t0
            sp.set("device_seconds", round(device_s, 6))
            sp.set("staged_rows", sum(ex.scan_stats.values()))
            sp.set("output_rows", int(page.num_rows))
        remote_rows = sum(p.num_rows for pages in remote_pages.values() for p in pages)
        self._retire_executor(ex, splits=self.total_splits,
                              input_rows=sum(ex.scan_stats.values()) + remote_rows,
                              device_s=device_s)
        if self.state.is_terminal():
            return  # canceled while it ran: its output has no consumer
        prepared = self._prepare_out(page)
        self.state.set("FLUSHING")
        self._emit(prepared)
        self._complete_output()
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
        """Cut a prepared page into chunks and serialize them: into result
        segments when this task produces a spooled result, else into the
        output buffer (enqueue blocks at its watermark). With a spool
        directory the whole output spools first, and only then enqueues:
        a retried consumer must find the complete durable copy. Under the
        fault-tolerant tier the spool file is the whole output: consumers
        are scheduled once this task FINISHED and read the file, so frames
        in the buffer would wait at its watermark for a pull that never
        comes (the reference's task blocks there once its output passes
        ``sink_max_buffer_bytes``, and fails after 300 s)."""
        spool = spool_directory() is not None
        visible = not (spool and str(self.request.session_properties.get(
            "retry_policy", "NONE")).upper() == "TASK")
        if prepared is None:
            if spool and self._result_writer is None:
                # an empty output spools empty files, so a consumer reads
                # zero rows off the spool as it would off the buffer
                if self.request.output_partition_channels is not None:
                    self._spool_partitioned([[] for _ in range(self.request.consumer_count)])
                else:
                    self._spool([])
            return
        out, parts = prepared
        chunk_rows = self._chunk_rows(out)
        if parts is not None:
            if spool:
                part_frames = [[serialize_page(c) for c in _chunk_pages(host_page(part), chunk_rows)]
                               for part in parts]
                self._spool_partitioned(part_frames)
                for pid, frames in enumerate(part_frames if visible else ()):
                    for pb in frames:
                        self.output.enqueue_partition(pid, pb)
                return
            for pid, part in enumerate(parts):
                for c in _chunk_pages(host_page(part), chunk_rows):
                    self.output.enqueue_partition(pid, serialize_page(c))
            return
        if self._result_writer is not None:
            # segments are disk-bounded: nothing waits on a consumer that,
            # by design, is not coming
            with tracing.span("segment/write") as sp:
                for c in _chunk_pages(out, chunk_rows):
                    self._result_writer.add(serialize_page(c), c.num_rows)
                sp.set("rows", out.num_rows)
            return
        if spool:
            frames = [serialize_page(c) for c in _chunk_pages(out, chunk_rows)]
            self._spool(frames)
            for pb in frames if visible else ():
                self.output.enqueue(pb)
            return
        for c in _chunk_pages(out, chunk_rows):
            self.output.enqueue(serialize_page(c))

    def _enqueue_out(self, out: Page) -> None:
        """One output page into the buffer: prepared, then emitted."""
        self._emit(self._prepare_out(out))

    def _finish_result_spool(self) -> None:
        """Seal the result-segment writer: roll the last partial segment and
        publish the manifest entries that task status carries."""
        if self._result_writer is None:
            return
        with tracing.span("segment/write") as sp:
            metas = self._result_writer.finish()
            sp.set("segments", len(metas))
        self.result_segments = [m.manifest_entry() for m in metas]

    def _complete_output(self) -> None:
        """Seal the result spool (a result-producing task), then mark the
        buffer complete."""
        self._finish_result_spool()
        self.output.set_complete()

    def _finish(self) -> None:
        self.state.set("FLUSHING")
        self._complete_output()
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
        # the span covers the stage, the enqueues' backpressure included;
        # its device_seconds only the executions
        with tracing.span("device/execute", mode="split-streaming") as sp:
            device_s = 0.0
            staged_rows = 0
            for split in splits:
                ex = self._executor(session, {scan.id: [split]}, {})
                t0 = time.perf_counter()
                out = ex.execute_checked(req.fragment_root)
                split_s = time.perf_counter() - t0
                device_s += split_s
                staged_rows += sum(ex.scan_stats.values())
                self._retire_executor(ex, splits=1, input_rows=sum(ex.scan_stats.values()),
                                      device_s=split_s)
                self._enqueue_out(out)
            sp.set("device_seconds", round(device_s, 6))
            sp.set("staged_rows", staged_rows)
            sp.set("splits", len(splits))
        self._finish()
        return True

    def _try_streaming(self, req: TaskRequest, session) -> bool:
        """Micro-batch driver for streamable consumer fragments: pull from
        the one upstream, run the fragment a batch at a time and enqueue
        each batch's output at once (a final aggregation folds its states
        instead). False where the fragment needs the bulk path, and always
        with a spool directory: the whole output must be durable before any
        of it is visible."""
        if spool_directory():
            return False
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
            with tracing.span("device/execute", mode="streaming-fold") as sp:
                in_rows = 0
                for batch, rows in batches():
                    page = _concat(batch if running is None else [running] + batch)
                    ex = self._executor(session, {}, {})
                    running = folded(ex, ex.aggregate_intermediate, page, rows)
                    in_rows += rows
                if running is None:
                    running = Page.all_dead(src.types, session.device)
                ex = self._executor(session, {}, {})
                out = folded(ex, ex.aggregate_final, running, running.num_rows, is_final=True)
                sp.set("input_rows", in_rows)
            prepared = self._prepare_out(out)
            self.state.set("FLUSHING")
            self._emit(prepared)
            self._finish()
            return True
        with tracing.span("device/execute", mode="streaming") as sp:
            in_rows = 0
            for batch, rows in batches():
                ex = self._executor(session, {}, {src.fragment_id: [_concat(batch)]})
                self._enqueue_out(timed(ex, ex.execute_checked, req.fragment_root,
                                        input_rows=rows))
                in_rows += rows
            sp.set("input_rows", in_rows)
        self._finish()
        return True

    # target serialized bytes of an output chunk
    DEFAULT_CHUNK_BYTES = 4 << 20

    def _chunk_rows(self, page: Page) -> int:
        target = int(self.request.session_properties.get("task_output_chunk_bytes")
                     or self.DEFAULT_CHUNK_BYTES)
        return max(1, target // page.row_byte_estimate()) if page.num_rows else 1

    def _spool_partitioned(self, part_frames) -> None:
        """Spool each partition's stream to its own durable file,
        ``{task}.p{pid}.pages`` (the FTE contract of a hash-partitioned
        stage: a retried consumer re-reads its partition's files)."""
        spool_dir = spool_directory()
        if not spool_dir:
            return
        for pid, frames in enumerate(part_frames):
            self._publish(os.path.join(spool_dir, f"{self.request.task_id}.p{pid}.pages"),
                          frames)

    def _spool(self, page_frames) -> None:
        """Persist the task's output to the spool directory as
        ``{task}.pages`` (the fault-tolerant tier's durable exchange): a
        finished task's pages outlive the producing worker, and retried
        consumers re-read them instead of recomputing the stage."""
        spool_dir = spool_directory()
        if spool_dir:
            self._publish(os.path.join(spool_dir, f"{self.request.task_id}.pages"), page_frames)

    def _publish(self, path: str, frames) -> None:
        """Write one spool file to ``path + '.tmp'`` and rename it into
        place (readers never see a partial file), unless the task was
        canceled: the check, the write and the rename hold the lock that
        ``cancel`` takes, so no file of a canceled attempt appears after its
        cancel returned (the coordinator's cleanup may already have passed)."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with self._publish_lock:
            if self.state.get() == "CANCELED":
                return
            with open(tmp, "wb") as f:
                f.write(wire.frame_pages(frames))
            os.replace(tmp, path)

    def cancel(self) -> None:
        """CANCELED, its buffer aborted; waits out a spool publish in
        progress, after which the attempt publishes nothing."""
        with self._publish_lock:
            self.state.set("CANCELED")
        self.output.abort("canceled")

    def info(self) -> dict:
        return {
            "taskId": self.request.task_id,
            "state": self.state.get(),
            "failure": self.failure,
            "bufferedBytes": self.output.buffered_bytes,
            "memoryBytes": self.memory_bytes,
            # the spooled result protocol: the segments this task wrote
            # (the coordinator assembles the statement's manifest from them)
            "resultSegments": list(self.result_segments),
            "stats": self.stats_snapshot(),
        }


def _task_stage_id(task_id: str):
    """The fragment (stage) id in a coordinator task id
    (``<query>.<fragment>.<worker>.a<attempt>``); None for another id."""
    parts = task_id.split(".")
    if len(parts) >= 4 and parts[-1].startswith("a"):
        try:
            return int(parts[-3])
        except ValueError:
            return None
    return None


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


def spool_directory() -> Optional[str]:
    """The cluster-shared spool directory (``TRINO_TPU_SPOOL_DIR``, the
    fault-tolerant tier's "object storage"); None: no spooling."""
    return os.environ.get("TRINO_TPU_SPOOL_DIR") or None


class TaskManager:
    """All tasks on this worker (reference: SqlTaskManager.java:109)."""

    MAX_TASK_HISTORY = 200  # terminal tasks kept for status queries

    def __init__(self, session_factory, recorder=None, otlp=None, segment_store=None):
        self._tasks: Dict[str, SqlTask] = {}
        self._lock = threading.Lock()
        self._session_factory = session_factory
        # the worker's flight recorder (obs/flightrecorder.py) and OTLP
        # exporter (obs/otlp.py), or None
        self._recorder = recorder
        self._otlp = otlp
        # the store result-producing tasks (TaskRequest.spool_results)
        # write their segments into (server/segments.py), or None
        self._segment_store = segment_store

    def create_task(self, request: TaskRequest, traceparent: Optional[str] = None) -> SqlTask:
        with self._lock:
            terminal = [tid for tid, t in self._tasks.items() if t.state.is_terminal()]
            for tid in terminal[: max(0, len(terminal) - self.MAX_TASK_HISTORY)]:
                del self._tasks[tid]
            task = self._tasks.get(request.task_id)
            created = task is None
            if created:
                task = SqlTask(request, self._session_factory, traceparent=traceparent,
                               recorder=self._recorder, otlp=self._otlp,
                               segment_store=self._segment_store)
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
            task.cancel()
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
