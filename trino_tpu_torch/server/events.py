"""Event listener SPI + metrics collection (a copy of
trino_tpu/server/events.py).

Reference: ``core/trino-spi/.../spi/eventlistener/`` — ``EventListener``
(queryCreated / queryCompleted), ``QueryCompletedEvent`` (metadata, stats,
failure info), registered via EventListenerFactory plugins and dispatched by
``eventlistener/EventListenerManager`` with per-listener exception isolation.
Here the same shape: listeners attach to a Session or a CoordinatorServer,
events are plain dataclasses, and a failing listener never fails the query.

The metrics side (``render_metrics``) exposes the coordinator's counters in
the Prometheus text format — the role of the reference's JMX-to-/metrics
bridge (``trino-jmx`` + airlift's MetricsResource). It is a thin bridge: server-derived gauges refresh from the server's
PUBLIC accessors into the typed registry (``obs/metrics.py``)
and the registry renders the page — seed metric names unchanged, engine
counters and histograms ride along.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import List, Mapping, Optional, Tuple

logger = logging.getLogger("trino_tpu_torch.events")


@dataclasses.dataclass(frozen=True)
class QueryCreatedEvent:
    """Reference: spi/eventlistener/QueryCreatedEvent.java."""

    query_id: str
    user: str
    sql: str
    create_time: float  # epoch seconds


@dataclasses.dataclass(frozen=True)
class QueryCompletedEvent:
    """Reference: spi/eventlistener/QueryCompletedEvent.java (metadata +
    statistics + failureInfo, flattened to the fields the engine tracks)."""

    query_id: str
    user: str
    sql: str
    state: str  # FINISHED | FAILED | CANCELED
    create_time: float
    end_time: float
    wall_seconds: float
    output_rows: int
    error: Optional[str] = None
    # the query's trace, exported span records (obs/trace.py Span.to_dict)
    # — the reference attaches QueryStats/operator summaries; here the span
    # tree carries the same where-did-time-go data (SlowQueryLogListener
    # is the first consumer)
    spans: Tuple[dict, ...] = ()
    # the session-property view the query ran with (reference:
    # QueryContext.sessionProperties on the completed event)
    session_properties: Mapping[str, object] = dataclasses.field(
        default_factory=dict)
    # completion-time phase ledger (obs/timeline.py QueryTimeline.to_dict)
    # — wall attribution per phase + unattributed residual; None when the
    # ledger could not be computed
    timeline: Optional[Mapping[str, object]] = None
    # flight-recorder postmortem (obs/flightrecorder.py): merged
    # coordinator + worker rings, captured for FAILED queries only
    postmortem: Optional[Mapping[str, object]] = None


class EventListener:
    """Subclass and override either hook (reference: EventListener's
    default methods are no-ops, so listeners implement only what they use)."""

    def query_created(self, event: QueryCreatedEvent) -> None:  # noqa: B027
        pass

    def query_completed(self, event: QueryCompletedEvent) -> None:  # noqa: B027
        pass


class EventListenerManager:
    """Dispatch with per-listener exception isolation (reference:
    eventlistener/EventListenerManager catches and logs per listener)."""

    def __init__(self):
        self._listeners: List[EventListener] = []
        self._lock = threading.Lock()

    def add(self, listener: EventListener) -> None:
        with self._lock:
            self._listeners.append(listener)

    def _snapshot(self) -> List[EventListener]:
        with self._lock:
            return list(self._listeners)

    def fire_created(self, event: QueryCreatedEvent) -> None:
        for lsn in self._snapshot():
            try:
                lsn.query_created(event)
            except Exception:  # noqa: BLE001 — listener faults never fail
                # queries, but a silently-broken listener is undiagnosable:
                # log it (reference: EventListenerManager catches AND logs)
                logger.exception(
                    "event listener %s failed in query_created for %s",
                    type(lsn).__name__, event.query_id)

    def fire_completed(self, event: QueryCompletedEvent) -> None:
        for lsn in self._snapshot():
            try:
                lsn.query_completed(event)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "event listener %s failed in query_completed for %s",
                    type(lsn).__name__, event.query_id)


@contextlib.contextmanager
def refreshed_server_gauges(server):
    """Refresh the server-derived gauges from the server's PUBLIC
    accessors (``query_state_counts`` — no reaching into ``_qlock``/
    ``queries`` privates) for the duration of the block, then clear them.
    RENDER_LOCK (shared with render_registry, reentrant) makes refresh-
    read-clear one atomic unit: concurrent scrapes — of this server,
    another coordinator, or a same-process worker — never observe a
    half-refreshed gauge. Used by the Prometheus page
    (``render_metrics``)."""
    from trino_tpu_torch.obs import metrics as M

    gauges = (M.QUERIES, M.RESULT_ROWS, M.QUERIES_TOTAL, M.WORKERS,
              M.UPTIME_SECONDS, M.QUERY_HISTORY_SIZE)
    with M.RENDER_LOCK:
        by_state, rows = server.query_state_counts()
        M.QUERIES.clear()
        for st, n in by_state.items():
            M.QUERIES.set(n, st)
        M.RESULT_ROWS.set(rows)
        M.QUERIES_TOTAL.clear()
        M.QUERIES_TOTAL.inc(getattr(server, "queries_submitted", 0))
        alive = server.registry.alive() if hasattr(server, "registry") else []
        M.WORKERS.set(len(alive))
        M.UPTIME_SECONDS.set(round(
            time.time() - getattr(server, "start_time", time.time()), 1))
        history = getattr(server, "history", None)
        if history is not None:
            M.QUERY_HISTORY_SIZE.set(len(history))
        dispatcher = getattr(server, "dispatcher", None)
        if dispatcher is not None:
            dispatcher.refresh_gauges()
        try:
            yield
        finally:
            for metric in gauges:
                # clear afterwards: the process-global registry must not
                # keep a stopped server's numbers, and a same-process
                # worker's render must not re-export this coordinator's
                # gauge values as its own
                metric.clear()


def render_metrics(server) -> str:
    """Coordinator metrics page: server-derived gauges refreshed, then the
    typed registry renders, which also carries the process-global engine
    counters and histograms."""
    from trino_tpu_torch.obs import metrics as M

    with refreshed_server_gauges(server):
        return M.render_registry()
