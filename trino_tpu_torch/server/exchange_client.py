"""Streaming shuffle consumer: pull pages from upstream task buffers.

The port of trino_tpu/server/exchange_client.py (reference:
``operator/DirectExchangeClient.java:56`` + ``HttpPageBufferClient.java:98``):
one puller thread per upstream location, token-acknowledged
at-least-once pulls, a bounded client queue for backpressure. Pulled
pages are decoded onto the consumer's device (one host->device copy an
array). The reference's fault-tolerant tier (reading a failed producer's
spooled output) and its flow-ledger records are not ported.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

from trino_tpu_torch.data.page import Page
from trino_tpu_torch.data.serde import deserialize_page
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.server import wire


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
    pages land.
    """

    def __init__(self, locations: List[TaskLocation], max_buffered_pages: int = 64,
                 device="cpu"):
        self._locations = list(locations)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_buffered_pages)
        self._lock = threading.Lock()
        self._failure: Optional[str] = None
        self._device = device
        # the pullers' request walls, summed, and those of empty polls (the
        # producer had nothing ready: consumer-side backpressure)
        self.pulled_seconds = 0.0
        self.stalled_seconds = 0.0
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
        (body, headers); a terminal failure names every attempt."""
        delay = 0.2
        history: List[str] = []
        for attempt in range(self.MAX_ATTEMPTS):
            t0 = time.perf_counter()
            try:
                status, body, headers = wire.http_request(
                    "GET", loc.results_url(token), timeout=120.0)
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
            return body, headers
        raise RuntimeError(f"exchange pull {loc}: retries exhausted after "
                           f"{len(history)} attempts [{'; '.join(history)}]")

    def _pull(self, loc: TaskLocation) -> None:
        token = 0
        try:
            while True:
                t0 = time.perf_counter()
                body, headers = self._request_with_retry(loc, token)
                waited = time.perf_counter() - t0
                with self._lock:
                    self.pulled_seconds += waited
                failed = headers.get(wire.H_TASK_FAILED)
                if failed:
                    raise RuntimeError(f"upstream task {loc.task_id} failed: {failed}")
                M.EXCHANGE_BYTES.inc(len(body))
                frames = wire.unframe_pages(body)
                if not frames:
                    with self._lock:
                        self.stalled_seconds += waited
                for pb in frames:
                    self._queue.put(deserialize_page(pb, self._device))
                token = int(headers.get(wire.H_NEXT_TOKEN, token))
                if headers.get(wire.H_BUFFER_COMPLETE) == "true":
                    # final ack so the upstream buffer can be destroyed
                    wire.http_request("DELETE", loc.results_url(token), timeout=10.0)
                    break
        except Exception as e:  # noqa: BLE001 — surfaced to the consumer
            with self._lock:
                if self._failure is None:
                    self._failure = str(e)
        finally:
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
