"""In-tree event-listener consumers of the observability SPI
(a copy of trino_tpu/obs/listeners.py).

Reference role: the slow-query variants of the reference's event-listener
plugins (``plugin/trino-http-event-listener`` et al.) — here a logging
listener is built directly on the span data attached to
``QueryCompletedEvent``, the first consumer of the tracing subsystem.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from trino_tpu_torch.server.events import EventListener, QueryCompletedEvent

logger = logging.getLogger("trino_tpu_torch.slow_query")

# server-level default threshold (overridable per listener instance and per
# query via the slow_query_log_threshold_ms session property)
_ENV_THRESHOLD_MS = "TRINO_TPU_SLOW_QUERY_MS"
DEFAULT_THRESHOLD_MS = 30_000


class QueryLogListener(EventListener):
    """Durable query log: one JSON line per ``QueryCompletedEvent``
    (reference role: the file/http event-listener plugins —
    ``plugin/trino-http-event-listener`` et al. — collapsed to append-only
    JSONL). Each line carries the query's identity, terminal state, stats
    summary, and failure info, so the file is greppable/jq-able query
    history that survives coordinator restarts (the in-memory history ring
    does not). Registered on the coordinator when ``TRINO_TPU_QUERY_LOG``
    names a path; a write failure is confined to this listener by
    EventListenerManager's per-listener isolation — it can never fail the
    query."""

    def __init__(self, path: str):
        self.path = path

    def query_completed(self, event: QueryCompletedEvent) -> None:
        import json

        from trino_tpu_torch.obs.flightrecorder import trim_postmortem

        record = {
            "queryId": event.query_id,
            "user": event.user,
            "state": event.state,
            "query": event.sql.strip()[:2000],
            "createTime": event.create_time,
            "endTime": event.end_time,
            "wallMs": round(event.wall_seconds * 1000.0, 3),
            "outputRows": event.output_rows,
            "error": ((event.error or "").split("\n")[0][:500] or None),
            "spanCount": len(event.spans),
            # the phase ledger: where this query's wall went, one dict
            "timeline": event.timeline,
        }
        if event.postmortem is not None:
            # FAILED queries carry the merged flight-recorder postmortem
            # (each node's ring trimmed to its tail — the live endpoints
            # keep the full rings; the durable log keeps what matters)
            record["postmortem"] = trim_postmortem(event.postmortem)
        line = json.dumps(record, ensure_ascii=False)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")


class SlowQueryLogListener(EventListener):
    """Logs queries whose wall time crosses a threshold, with the trace's
    slowest spans so the log line itself answers "where did the time go"
    (plan? schedule? the root-fragment execute? an exchange pull?). The
    event carries the COORDINATOR-side spans; per-worker device spans live
    in the full tree at ``GET /v1/query/{id}/trace``, which the log line's
    query id keys into.

    Threshold resolution, most specific wins: the query's
    ``slow_query_log_threshold_ms`` session property, then this listener's
    constructor value, then the ``TRINO_TPU_SLOW_QUERY_MS`` server
    environment property, then the default."""

    TOP_SPANS = 5

    def __init__(self, threshold_ms: Optional[int] = None):
        if threshold_ms is None:
            try:
                threshold_ms = int(os.environ.get(_ENV_THRESHOLD_MS, ""))
            except ValueError:
                # malformed env value falls back like a malformed session
                # property does — registering the listener must not crash
                # server startup
                threshold_ms = DEFAULT_THRESHOLD_MS
        self.threshold_ms = threshold_ms

    def _effective_threshold_ms(self, event: QueryCompletedEvent) -> int:
        override = event.session_properties.get("slow_query_log_threshold_ms")
        if override is not None:
            try:
                return int(override)
            except (TypeError, ValueError):
                pass
        return self.threshold_ms

    def query_completed(self, event: QueryCompletedEvent) -> None:
        threshold_ms = self._effective_threshold_ms(event)
        if event.wall_seconds * 1000.0 < threshold_ms:
            return
        slowest = sorted(
            (s for s in event.spans if s.get("durationS") is not None),
            key=lambda s: s["durationS"], reverse=True)[: self.TOP_SPANS]
        breakdown = ", ".join(
            f"{s['name']}={s['durationS'] * 1000.0:.0f}ms" for s in slowest)
        logger.warning(
            "slow query %s (%s, %.0fms >= %dms) user=%s: %s | slowest spans: %s",
            event.query_id, event.state, event.wall_seconds * 1000.0,
            threshold_ms, event.user, event.sql.strip()[:200].replace("\n", " "),
            breakdown or "none recorded")
