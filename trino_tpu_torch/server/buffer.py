"""Task output buffers: token-addressed page streams with at-least-once pull
(a copy of trino_tpu/server/buffer.py).

Reference: the producer side of the pipelined shuffle —
``execution/buffer/PartitionedOutputBuffer.java`` /
``BroadcastOutputBuffer.java`` + the token protocol of
``server/TaskResource.java:333-336`` (SURVEY.md §A.4): a consumer GETs
``/results/{buffer}/{token}``, the response carries pages starting at that
sequence id, and requesting token T+k implicitly acknowledges [T, T+k).
At-least-once delivery with client-side de-dup by sequence id makes retries
safe (the FTE determinism contract).

Like the reference's OutputBuffers, the consumer set is declared up front
(``consumer_count``): broadcast exchanges give every downstream task its own
buffer id, and a page is garbage-collected only once EVERY consumer has
acknowledged past it.

Pages are stored serialized (data/serde.py) — the buffer is a wire-format
queue, not a device-array holder; workers compact+serialize once, every
consumer pull is a byte copy.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from trino_tpu_torch.obs.flowledger import FLOW_LEDGER


# default producer-blocking watermark (reference: sink.max-buffer-size /
# OutputBufferMemoryManager's 32MB default)
DEFAULT_MAX_BUFFER_BYTES = 32 * 1024 * 1024


class OutputBuffer:
    """An ordered page stream read by ``consumer_count`` independent
    consumers, each addressing its own buffer id ∈ [0, consumer_count).

    BOUNDED: ``enqueue`` blocks the producing driver once un-GC'd bytes
    exceed ``max_buffer_bytes`` until consumers acknowledge pages away —
    the reference's OutputBufferMemoryManager backpressure invariant
    ("return a blocked future"; here the producer thread parks, which is
    the same flow control on a thread-per-fragment worker)."""

    def __init__(self, consumer_count: int = 1,
                 max_buffer_bytes: int = DEFAULT_MAX_BUFFER_BYTES,
                 stall_key=None):
        assert consumer_count >= 1
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pages: List[bytes] = []
        self._base = 0  # sequence id of _pages[0]
        self._acked = [0] * consumer_count  # per-consumer ack watermark
        self._complete = False
        self._aborted: Optional[str] = None
        self._max_bytes = max_buffer_bytes
        self._bytes = 0  # un-GC'd page bytes
        self.peak_buffered_bytes = 0
        # flow-ledger label for full-wait stall samples: (stage, partition)
        self._stall_key = stall_key if stall_key is not None else (None, None)
        self.stalled_seconds = 0.0  # cumulative producer full-wait

    def enqueue(self, page_bytes: bytes, timeout: float = 300.0) -> None:
        waited_s = 0.0
        depth = 0
        timed_out = False
        with self._cond:
            if self._aborted is not None:
                return  # writes to a destroyed buffer are discarded
            assert not self._complete, "enqueue after set_complete"
            # about to block? sample this full-wait into the backpressure
            # timeline (the ledger append happens OUTSIDE the lock below)
            t0 = (time.perf_counter()
                  if self._bytes >= self._max_bytes else None)
            if t0 is not None:
                depth = self._bytes
            # block while over the watermark (unless aborted — a dead
            # consumer must not wedge the producer forever)
            # lint: allow(blocking-under-lock) Condition.wait_for RELEASES the lock while blocked; this IS the backpressure
            ok = self._cond.wait_for(
                lambda: self._aborted is not None
                or self._bytes < self._max_bytes,
                timeout,
            )
            if t0 is not None:
                waited_s = time.perf_counter() - t0
            if not ok:
                timed_out = True
            elif self._aborted is None:
                self._pages.append(page_bytes)
                self._bytes += len(page_bytes)
                self.peak_buffered_bytes = max(self.peak_buffered_bytes, self._bytes)
                self._cond.notify_all()
        if waited_s > 0.0:
            self.stalled_seconds += waited_s
            stage, partition = self._stall_key
            FLOW_LEDGER.record_stall(
                "buffer-enqueue", stage, partition, waited_s,
                depth_bytes=depth, limit_bytes=self._max_bytes)
        if timed_out:
            raise TimeoutError(
                f"output buffer full for {timeout}s "
                f"({depth} buffered bytes, no consumer progress)")

    def set_complete(self) -> None:
        with self._cond:
            self._complete = True
            self._cond.notify_all()

    def abort(self, reason: str) -> None:
        with self._cond:
            self._aborted = reason
            self._complete = True
            self._cond.notify_all()

    def _gc_locked(self) -> None:
        """Drop the prefix acknowledged by EVERY consumer (and wake any
        producer blocked on the byte watermark)."""
        drop = min(min(self._acked) - self._base, len(self._pages))
        if drop > 0:
            self._bytes -= sum(len(p) for p in self._pages[:drop])
            del self._pages[:drop]
            self._base += drop
            self._cond.notify_all()

    def poll(
        self, token: int, buffer_id: int = 0, max_pages: int = 16, timeout: float = 1.0
    ) -> Tuple[List[bytes], int, bool, Optional[str]]:
        """Return (pages, next_token, complete, failure) for one consumer
        from sequence id ``token``; long-polls up to ``timeout`` when no data
        is ready. Requesting token T acknowledges this consumer's [0, T)."""
        with self._cond:
            if not 0 <= buffer_id < len(self._acked):
                raise ValueError(f"buffer id {buffer_id} out of range")
            self._acked[buffer_id] = max(self._acked[buffer_id], token)
            self._gc_locked()
            # lint: allow(blocking-under-lock) Condition.wait_for RELEASES the lock; long-poll until a page lands
            self._cond.wait_for(
                lambda: self._aborted or self._complete or self._base + len(self._pages) > token,
                timeout,
            )
            if self._aborted:
                return [], token, True, self._aborted
            start = token - self._base
            if start < 0:
                raise ValueError(f"token {token} already garbage-collected (base {self._base})")
            pages = self._pages[start : start + max_pages]
            next_token = token + len(pages)
            complete = self._complete and next_token == self._base + len(self._pages)
            return list(pages), next_token, complete, None

    def destroy_consumer(self, buffer_id: int) -> None:
        """Final ack: this consumer is done with the whole stream."""
        with self._cond:
            if 0 <= buffer_id < len(self._acked):
                self._acked[buffer_id] = self._base + len(self._pages)
                self._gc_locked()
                self._cond.notify_all()

    @property
    def buffered_bytes(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._pages)


class PartitionedOutputBuffer:
    """Per-partition DISTINCT page streams: buffer id p serves partition p
    (reference: PartitionedOutputBuffer.java — one client per partition),
    unlike OutputBuffer where every consumer reads the same stream. Each
    partition is its own bounded OutputBuffer, so backpressure applies per
    consumer."""

    def __init__(self, partitions: int,
                 max_buffer_bytes: int = DEFAULT_MAX_BUFFER_BYTES,
                 stall_stage=None):
        assert partitions >= 1
        self._parts = [
            OutputBuffer(1, max_buffer_bytes=max(max_buffer_bytes // partitions, 1 << 16),
                         stall_key=(stall_stage, pid))
            for pid in range(partitions)
        ]
        # cumulative serialized bytes enqueued per partition (never
        # decremented by GC), reported in task stats. NOT the skew
        # detection signal — serde compression inverts bytes under a
        # constant hot key, so detection runs on partitionRows; the
        # re-planner uses this series only to cap replication cost
        self._enqueued_bytes = [0] * partitions

    def enqueue_partition(self, pid: int, page_bytes: bytes, timeout: float = 300.0) -> None:
        self._parts[pid].enqueue(page_bytes, timeout=timeout)
        self._enqueued_bytes[pid] += len(page_bytes)

    @property
    def partition_enqueued_bytes(self) -> List[int]:
        return list(self._enqueued_bytes)

    def set_complete(self) -> None:
        for p in self._parts:
            p.set_complete()

    def abort(self, reason: str) -> None:
        for p in self._parts:
            p.abort(reason)

    def poll(self, token: int, buffer_id: int = 0, max_pages: int = 16,
             timeout: float = 1.0):
        if not 0 <= buffer_id < len(self._parts):
            raise ValueError(f"buffer id {buffer_id} out of range")
        return self._parts[buffer_id].poll(token, 0, max_pages, timeout)

    def destroy_consumer(self, buffer_id: int) -> None:
        if 0 <= buffer_id < len(self._parts):
            self._parts[buffer_id].destroy_consumer(0)

    @property
    def buffered_bytes(self) -> int:
        return sum(p.buffered_bytes for p in self._parts)

    @property
    def stalled_seconds(self) -> float:
        return sum(p.stalled_seconds for p in self._parts)
