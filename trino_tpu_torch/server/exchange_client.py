"""Streaming shuffle consumer: pull pages from upstream task buffers.

The port of trino_tpu/server/exchange_client.py (reference:
``operator/DirectExchangeClient.java:56`` + ``HttpPageBufferClient.java:98``):
one puller thread per upstream location, token-acknowledged
at-least-once pulls, a bounded client queue for backpressure. Pulled
pages are decoded onto the consumer's device (one host->device copy an
array). Each pull stream is one ``exchange/pull`` span under the span that
made the client, and one ``exchange-pull`` flow-ledger record of the bytes
it pulled (the bytes ``EXCHANGE_BYTES`` counts); an empty poll is an
``exchange-poll`` stall sample. With a spool directory (the fault-tolerant
tier), a location whose producer spooled its output is read from the
spool file instead, producer alive or not: a ``spool/read`` span, the
``SPOOL_READS`` and ``SPOOL_BYTES`` counters (not ``EXCHANGE_BYTES``, a
network signal) and an ``exchange-pull`` record with status ``spool``.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import List, Optional

from trino_tpu_torch.data.page import Page
from trino_tpu_torch.data.serde import deserialize_page
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs import trace as tracing
from trino_tpu_torch.obs.flowledger import FLOW_LEDGER
from trino_tpu_torch.server import wire
from trino_tpu_torch.server.task import spool_directory


class TaskLocation:
    """Address of one upstream task's output buffer."""

    def __init__(self, base_url: str, task_id: str, buffer_id: int = 0):
        self.base_url = base_url.rstrip("/")
        self.task_id = task_id
        self.buffer_id = buffer_id

    def results_url(self, token: int) -> str:
        return f"{self.base_url}/v1/task/{self.task_id}/results/{self.buffer_id}/{token}"

    def __repr__(self):
        return f"TaskLocation({self.base_url}, {self.task_id})"


class ExchangeClient:
    """Pulls every upstream location to completion into a bounded queue.

    ``max_buffered_pages`` is the backpressure bound: pullers block once the
    local queue is full, which stalls their token advance, which leaves
    pages queued in the upstream OutputBuffer. ``device``: where decoded
    pages land. ``owner`` names the pulled bytes in the flow ledger
    (``task:<id>``), ``stall_key`` labels the empty-poll samples
    (stage, partition); the spans go to ``tracer`` (default: the ambient
    one of the constructing thread).
    """

    def __init__(self, locations: List[TaskLocation], max_buffered_pages: int = 64,
                 device="cpu", tracer: Optional["tracing.Tracer"] = None,
                 owner: Optional[str] = None, stall_key=None):
        self._locations = list(locations)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_buffered_pages)
        self._lock = threading.Lock()
        self._failure: Optional[str] = None
        self._device = device
        # the pullers' request walls, summed, and those of empty polls (the
        # producer had nothing ready: consumer-side backpressure)
        self.pulled_seconds = 0.0
        self.stalled_seconds = 0.0
        self._owner = owner or "exchange"
        self._stall_key = stall_key if stall_key is not None else (None, None)
        # the span context is taken here, on the consumer's thread: the
        # pullers' spans parent under the span that made the client
        if tracer is None:
            ambient = tracing.current()
            if ambient is not None:
                tracer = ambient[0]
        self._tracer = tracer
        self._parent_span_id = tracer.current_span_id() if tracer is not None else None
        # named by the upstream task, whose id starts with its query's
        self._threads = [threading.Thread(target=self._pull, args=(loc,), daemon=True,
                                          name=f"exchange:{loc.task_id}")
                         for loc in self._locations]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    MAX_ATTEMPTS = 4

    def _request_with_retry(self, loc: TaskLocation, token: int):
        """Retry transient failures with the SAME token (re-reading an
        un-acked token is safe; only the token advance is an ack). Returns
        (body, headers, attempts, last status); a terminal failure names
        every attempt."""
        delay = 0.2
        history: List[str] = []
        trace_headers = ({tracing.TRACEPARENT_HEADER: self._tracer.traceparent(
            self._parent_span_id)} if self._tracer is not None else None)
        for attempt in range(self.MAX_ATTEMPTS):
            M.EXCHANGE_REQUESTS.inc()
            if attempt:
                M.EXCHANGE_RETRIES.inc()
            t0 = time.perf_counter()
            try:
                status, body, headers = wire.http_request(
                    "GET", loc.results_url(token), timeout=120.0, headers=trace_headers)
            except Exception as e:  # noqa: BLE001 — socket-level failure
                history.append(f"#{attempt + 1} {type(e).__name__} after "
                               f"{time.perf_counter() - t0:.3f}s: {str(e)[:120]}")
                if attempt == self.MAX_ATTEMPTS - 1:
                    raise RuntimeError(
                        f"exchange pull {loc}: retries exhausted after "
                        f"{len(history)} attempts [{'; '.join(history)}]") from e
                time.sleep(delay)
                delay *= 2
                continue
            history.append(f"#{attempt + 1} HTTP {status} after "
                           f"{time.perf_counter() - t0:.3f}s")
            if status >= 500 and attempt < self.MAX_ATTEMPTS - 1:
                time.sleep(delay)
                delay *= 2
                continue
            if status >= 400:
                raise RuntimeError(
                    f"exchange pull {loc} -> {status}: {body[:300].decode(errors='replace')}")
            return body, headers, attempt + 1, str(status)
        raise RuntimeError(f"exchange pull {loc}: retries exhausted after "
                           f"{len(history)} attempts [{'; '.join(history)}]")

    def _read_spool(self, loc: TaskLocation) -> bool:
        """Serve a location from its producer's spool file, when there is
        one (the fault-tolerant tier's consumers read spooled files, not
        live buffers; reference: FileSystemExchange.java:70). True when
        served from the spool."""
        spool_dir = spool_directory()
        if not spool_dir:
            return False
        # a partitioned producer spools one file a partition (= buffer id)
        path = os.path.join(spool_dir, f"{loc.task_id}.p{loc.buffer_id}.pages")
        if not os.path.exists(path):
            path = os.path.join(spool_dir, f"{loc.task_id}.pages")
            if not os.path.exists(path):
                return False
        sp = (self._tracer.start_span("spool/read", parent_id=self._parent_span_id,
                                      task=loc.task_id, path=path)
              if self._tracer is not None else tracing.NOOP_SPAN)
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                body = f.read()
            M.SPOOL_READS.inc()
            # disk bytes: EXCHANGE_BYTES stays a network-throughput signal
            M.SPOOL_BYTES.inc(len(body))
            frames = wire.unframe_pages(body)
            sp.set("bytes", len(body))
            sp.set("pages", len(frames))
        except Exception as e:  # a truncated file must not leave the span open
            sp.set("error", str(e)[:300])
            raise
        finally:
            if self._tracer is not None:
                self._tracer.end_span(sp)
        spool_s = time.perf_counter() - t0
        with self._lock:
            self.pulled_seconds += spool_s
        FLOW_LEDGER.record_transfer(
            "exchange-pull", self._owner, len(body), spool_s, pages=len(frames),
            src=f"spool:{loc.task_id}", dst=FLOW_LEDGER.node_id or None, status="spool")
        for pb in frames:
            self._queue.put(deserialize_page(pb, self._device))
        # the final ack to the live buffer, where the producer still runs,
        # so it drops its copy (the spool is the durable one)
        try:
            wire.http_request("DELETE", loc.results_url(len(frames)), timeout=5.0)
        except Exception:  # noqa: BLE001 — the producer may be gone
            pass
        return True

    def _pull(self, loc: TaskLocation) -> None:
        token = 0
        # one span a location, over its whole pull stream
        sp = (self._tracer.start_span("exchange/pull", parent_id=self._parent_span_id,
                                      task=loc.task_id, buffer=loc.buffer_id)
              if self._tracer is not None else tracing.NOOP_SPAN)
        pulled_bytes = pulled_pages = retries = 0
        pull_seconds = 0.0
        last_status: Optional[str] = None
        streamed = False
        try:
            if self._read_spool(loc):
                sp.set("spooled", True)
                return
            streamed = True
            while True:
                t0 = time.perf_counter()
                body, headers, attempts, last_status = self._request_with_retry(loc, token)
                waited = time.perf_counter() - t0
                pull_seconds += waited
                retries += attempts - 1
                with self._lock:
                    self.pulled_seconds += waited
                failed = headers.get(wire.H_TASK_FAILED)
                if failed:
                    raise RuntimeError(f"upstream task {loc.task_id} failed: {failed}")
                M.EXCHANGE_BYTES.inc(len(body))
                pulled_bytes += len(body)
                frames = wire.unframe_pages(body)
                if not frames:
                    # the producer had nothing ready: a consumer-starved sample
                    stage, partition = self._stall_key
                    FLOW_LEDGER.record_stall("exchange-poll", stage, partition, waited)
                    with self._lock:
                        self.stalled_seconds += waited
                pulled_pages += len(frames)
                for pb in frames:
                    self._queue.put(deserialize_page(pb, self._device))
                token = int(headers.get(wire.H_NEXT_TOKEN, token))
                if headers.get(wire.H_BUFFER_COMPLETE) == "true":
                    # final ack so the upstream buffer can be destroyed
                    wire.http_request("DELETE", loc.results_url(token), timeout=10.0)
                    break
        except Exception as e:  # noqa: BLE001 — surfaced to the consumer
            sp.set("error", str(e)[:300])
            with self._lock:
                if self._failure is None:
                    self._failure = str(e)
        finally:
            sp.set("bytes", pulled_bytes)
            sp.set("pages", pulled_pages)
            if self._tracer is not None:
                self._tracer.end_span(sp)
            if streamed:
                # one flow record a pull stream: the whole conversation
                # with this upstream location
                FLOW_LEDGER.record_transfer(
                    "exchange-pull", self._owner, pulled_bytes, pull_seconds,
                    pages=pulled_pages, src=loc.base_url, dst=FLOW_LEDGER.node_id or None,
                    retries=retries, status=last_status)
            self._queue.put(None)  # wake the consumer

    def iter_pages(self):
        """Yield pages in arrival order while the upstreams still produce
        (the consumer holds at most ``max_buffered_pages`` plus the page it
        works on)."""
        done = 0
        total = len(self._locations)
        while done < total:
            item = self._queue.get()
            if item is None:
                done += 1
                with self._lock:
                    if self._failure is not None:
                        raise RuntimeError(self._failure)
                continue
            yield item

    def pages(self) -> List[Page]:
        """Block until every upstream completes; all pages in arrival order
        (the bulk path: joins, final aggregations, sorts need their whole
        input)."""
        return list(self.iter_pages())
