"""Query phase ledger: exclusive wall-time attribution from the span tree
(a copy of trino_tpu/obs/timeline.py).

Reference role: the latency breakdown the reference engine surfaces as
``QueryStats``'s queued/analysis/planning/execution durations (fed from
the otel spans ``io.opentelemetry.api.trace.Tracer`` records through
``QueuedStatementResource``/``DispatchManager``/``SqlTaskManager``) —
here computed ONCE at query completion from the merged coordinator +
worker span tree, so every millisecond of a query's wall is attributed
to exactly one phase, with the gaps surfaced as an explicit
``unattributed`` residual instead of silently vanishing.

The attribution is an interval sweep, not a span-duration sum: spans
overlap (worker tasks run in parallel with the coordinator's schedule
and root-fragment windows; exchange pullers overlap each other), so each
instant of the wall interval ``[created_at, ended_at]`` is assigned to
the highest-priority phase whose spans cover it. Priorities put the
specific over the general — a worker ``device/staging`` span wins over
the coordinator's enclosing ``schedule`` wait, an ``exchange/pull`` wins
over the root-fragment execute window it lives in — so the per-phase
sums are EXCLUSIVE and total at most the wall. ``client-drain`` (result
pages fetched after the query reached a terminal state) is reported
beside the ledger, never inside it: the wall the residual is measured
against ends at ``ended_at``.

Phases (the label set of ``trino_tpu_query_phase_seconds``)::

    queued                submit -> the query starts (admission wait
                          outside the dispatch queue: resource group +
                          cluster-memory gate)
    dispatch-queue        residency in the bounded dispatch queue
                          between the HTTP front and the executor lanes
                          (server/dispatch.py) — the queueing-time
                          attribution of the dispatcher/executor split
    dispatch              coordinator control-plane connective work:
                          session setup, statement probe, cache consult,
                          routing, state transitions (the root span's
                          exclusive remainder)
    parse-analyze         parse + analyze/plan spans
    plan-optimize         optimize + fragment + plan-cache + adaptation
    prepare-bind          EXECUTE parameter fold + plan substitution
    schedule              task creation + phased-execution build waits
    device-staging        host->device transfers (any process)
    device-execute        device compute + compile (any process)
    exchange-wait         exchange pulls / spool reads
    result-serialization  result page -> row materialization (inline) or
                          result segment encode/spool (spooled protocol)
    segment-fetch         post-terminal spooled-segment fetches + acks
                          (outside the wall, beside client-drain)
    client-drain          post-terminal result fetches (outside the wall)
    unattributed          wall not covered by any span (the visible gap)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# ledger phases in display order; segment-fetch, client-drain, and
# unattributed are synthesized, everything else is swept from spans
PHASES: Tuple[str, ...] = (
    "queued", "dispatch-queue", "dispatch", "parse-analyze",
    "plan-optimize", "prepare-bind", "schedule", "device-staging",
    "device-execute", "exchange-wait", "result-serialization",
    "segment-fetch", "client-drain", "unattributed")

# phases synthesized OUTSIDE the wall interval: reported beside the
# ledger, excluded from in-wall sums and the coverage denominator
OUT_OF_WALL_PHASES: Tuple[str, ...] = (
    "segment-fetch", "client-drain", "unattributed")

# span name -> (sweep priority, phase). Lower priority wins where spans
# overlap: leaf work (staging/execute/exchange) beats the coordinator's
# enclosing schedule/execute windows, whose EXCLUSIVE remainder is what
# the ledger should charge them.
_P_RESULT = 0
_P_STAGING = 1
_P_DEVICE = 2
_P_EXCHANGE = 3
_P_BIND = 4
_P_PARSE = 5
_P_PLAN = 6
_P_DISPATCH = 7
_P_SCHEDULE = 8
_P_EXECUTE = 9       # execute-window remainder -> device-execute
_P_ROOT = 10         # root query span remainder -> dispatch
_P_QUEUE = 11        # dispatch-queue residency (before the root opens)
_P_SYNTH = 12        # synthesized queued segment

SPAN_PHASE: Dict[str, Tuple[int, str]] = {
    "parse": (_P_PARSE, "parse-analyze"),
    "analyze/plan": (_P_PARSE, "parse-analyze"),
    "optimize": (_P_PLAN, "plan-optimize"),
    "fragment": (_P_PLAN, "plan-optimize"),
    "plan-cache/hit": (_P_PLAN, "plan-optimize"),
    "plan/adapt": (_P_PLAN, "plan-optimize"),
    "cache/lookup": (_P_DISPATCH, "dispatch"),
    "stats/sweep": (_P_DISPATCH, "dispatch"),
    # the dispatcher/executor split (server/dispatch.py): queue
    # residency is its own phase; the serve/forward control work joins
    # the dispatch remainder
    "dispatch/queue": (_P_QUEUE, "dispatch-queue"),
    "dispatch/serve": (_P_DISPATCH, "dispatch"),
    # the forward window ENCLOSES the executor process's merged spans:
    # like the root span, only its exclusive remainder is dispatch
    "dispatch/forward": (_P_ROOT, "dispatch"),
    "prepare/bind": (_P_BIND, "prepare-bind"),
    "schedule": (_P_SCHEDULE, "schedule"),
    "device/staging": (_P_STAGING, "device-staging"),
    "device-cache/lookup": (_P_STAGING, "device-staging"),
    "staging/dynamic-filters": (_P_STAGING, "device-staging"),
    # the pipelined staging engine's sub-phases (exec/staging.py): same
    # priority and bucket as their enclosing device/staging window, so
    # the ledger's device-staging attribution is unchanged while the
    # span tree now says WHICH stage of staging ate the wall
    "staging/scan": (_P_STAGING, "device-staging"),
    "staging/decode": (_P_STAGING, "device-staging"),
    "staging/transfer": (_P_STAGING, "device-staging"),
    "staging/host-cache": (_P_STAGING, "device-staging"),
    "device/compile": (_P_DEVICE, "device-execute"),
    "device/execute": (_P_DEVICE, "device-execute"),
    "exchange/overlap": (_P_DEVICE, "device-execute"),
    # the memory ledger's spans (exec/memory.py): the budget check and
    # the pre-spill revocable-tier yield both happen INSIDE the executing
    # operator, so their wall charges to device-execute like the device
    # windows they interrupt
    "memory/reserve": (_P_DEVICE, "device-execute"),
    "memory/shed": (_P_DEVICE, "device-execute"),
    "exchange/pull": (_P_EXCHANGE, "exchange-wait"),
    "spool/read": (_P_EXCHANGE, "exchange-wait"),
    "result/serialize": (_P_RESULT, "result-serialization"),
    # spooled result protocol (server/segments.py): segment encode+write
    # is the spooled analog of result serialization; the coordinator's
    # collect window encloses the workers' own execute/write spans, so
    # like the other execute windows only its remainder is device time
    "result/spool": (_P_RESULT, "result-serialization"),
    "segment/write": (_P_RESULT, "result-serialization"),
    "segments/collect": (_P_EXECUTE, "device-execute"),
    # the execution windows: their exclusive remainder is device compute
    # on this process (root-fragment body, fast-path executor run)
    "execute/root-fragment": (_P_EXECUTE, "device-execute"),
    "execute/coordinator-local": (_P_EXECUTE, "device-execute"),
    "fastpath/execute": (_P_EXECUTE, "device-execute"),
}

_N_PRIORITIES = _P_SYNTH + 1


@dataclasses.dataclass
class QueryTimeline:
    """The computed ledger: per-phase exclusive seconds over one query's
    wall interval. ``coverage`` = attributed / wall (the >=95% acceptance
    signal); ``client_drain_s`` sits outside the wall."""

    wall_s: float
    phases: Dict[str, float]
    unattributed_s: float
    client_drain_s: float = 0.0
    # spooled result protocol: terminal -> last segment fetch/ack seen by
    # the coordinator (outside the wall, like client-drain)
    segment_fetch_s: float = 0.0

    @property
    def coverage(self) -> float:
        if self.wall_s <= 0:
            return 1.0
        return max(0.0, 1.0 - self.unattributed_s / self.wall_s)

    def to_dict(self) -> dict:
        phases = {p: round(self.phases.get(p, 0.0), 6)
                  for p in PHASES if p not in OUT_OF_WALL_PHASES}
        phases["segment-fetch"] = round(self.segment_fetch_s, 6)
        phases["client-drain"] = round(self.client_drain_s, 6)
        phases["unattributed"] = round(self.unattributed_s, 6)
        return {
            "wallS": round(self.wall_s, 6),
            "phases": phases,
            "unattributedS": round(self.unattributed_s, 6),
            "coverage": round(self.coverage, 4),
        }


def _segments(span_dicts: List[dict], t0: float, t1: float):
    """(start, end, priority, phase) segments clipped to the wall, plus
    the synthesized queued interval before the root ``query`` span (the
    coordinator's query thread) opens.

    The root span itself maps to ``dispatch`` at the LOWEST span
    priority: every instant inside it where no phase span is open, the
    coordinator thread was doing control-plane connective work on behalf
    of the query — session setup, the statement-kind probe, routing, state
    transitions, scheduler preemption between instrumented sections. Time
    OUTSIDE the span tree (pre-thread-start beyond the admission wait,
    post-lifecycle teardown, spans lost to the tracer cap) stays
    unattributed — the visible gap."""
    segs: List[Tuple[float, float, int, str]] = []
    root_start: Optional[float] = None
    for s in span_dicts:
        name = s.get("name")
        start = s.get("start")
        if start is None:
            continue
        mapped = ((_P_ROOT, "dispatch") if name == "query"
                  else SPAN_PHASE.get(name))
        if mapped is None:
            continue
        dur = s.get("durationS")
        end = t1 if dur is None else start + float(dur)
        if name == "query":
            root_start = start if root_start is None else min(root_start,
                                                              start)
        start, end = max(start, t0), min(end, t1)
        if end <= start:
            continue
        prio, phase = mapped
        segs.append((start, end, prio, phase))
    if root_start is not None and root_start > t0:
        # admission wait: submit -> the query thread's root span opens
        segs.append((t0, min(root_start, t1), _P_SYNTH, "queued"))
    if root_start is None and not segs:
        # no spans at all (failed before the query thread started): the
        # whole wall was queued
        segs.append((t0, t1, _P_SYNTH, "queued"))
    return segs


def compute_timeline(span_dicts: List[dict], created_at: float,
                     ended_at: float,
                     client_drain_s: float = 0.0) -> QueryTimeline:
    """Sweep the spans into the exclusive per-phase ledger.

    ``span_dicts`` is the merged export (coordinator tracer + worker task
    dumps — ``Span.to_dict`` records with wall-clock ``start`` and
    monotonic-measured ``durationS``); open spans are treated as running
    to ``ended_at``. The sweep walks the sorted boundary events keeping a
    live count per priority, so each elementary interval lands in exactly
    one phase and the per-phase sums can never exceed the wall."""
    t0, t1 = float(created_at), float(ended_at)
    phases: Dict[str, float] = {p: 0.0 for p in PHASES}
    wall = max(0.0, t1 - t0)
    if wall == 0.0:
        return QueryTimeline(0.0, phases, 0.0, client_drain_s)
    segs = _segments(span_dicts, t0, t1)
    # boundary events: (time, +1/-1, priority, phase)
    events: List[Tuple[float, int, int, str]] = []
    for start, end, prio, phase in segs:
        events.append((start, 1, prio, phase))
        events.append((end, -1, prio, phase))
    events.sort(key=lambda e: e[0])
    # live phase name per priority level: at each level the LAST-opened
    # phase wins (levels map 1:1 to phases except _P_SYNTH, where queued
    # and dispatch never overlap by construction)
    counts = [0] * _N_PRIORITIES
    live_phase: List[Optional[str]] = [None] * _N_PRIORITIES
    attributed = 0.0
    cursor = t0
    i = 0
    n = len(events)
    while i < n:
        t = events[i][0]
        if t > cursor:
            # charge [cursor, t) to the highest-priority live phase
            for prio in range(_N_PRIORITIES):
                if counts[prio] > 0:
                    span_len = t - cursor
                    phases[live_phase[prio]] += span_len
                    attributed += span_len
                    break
            cursor = t
        while i < n and events[i][0] == t:
            _, delta, prio, phase = events[i]
            counts[prio] += delta
            if delta > 0:
                live_phase[prio] = phase
            i += 1
    unattributed = max(0.0, wall - attributed)
    return QueryTimeline(wall, phases, unattributed, client_drain_s)


def observe_phases(timeline_dict: dict) -> None:
    """Feed one terminal query's ledger into the
    ``trino_tpu_query_phase_seconds{phase}`` histogram — EVERY phase
    observes (zeros included) so bucket counts align across phases and
    the queued series exists from the first completed query."""
    from trino_tpu_torch.obs import metrics as M

    for phase in PHASES:
        M.QUERY_PHASE_SECONDS.observe(
            float(timeline_dict["phases"].get(phase, 0.0)), phase)


def summarize(timeline_dict: dict, min_fraction: float = 0.02,
              max_phases: int = 5) -> str:
    """One compact human line for the CLI summary / EXPLAIN ANALYZE
    header: the heaviest phases (>= ``min_fraction`` of wall, largest
    first) plus the coverage — e.g.
    ``device-execute 38ms · queued 2ms (96% attributed)``."""
    wall = float(timeline_dict.get("wallS") or 0.0)
    if wall <= 0:
        return ""
    entries = [(p, float(timeline_dict["phases"].get(p, 0.0)))
               for p in PHASES if p not in OUT_OF_WALL_PHASES]
    entries = [(p, s) for p, s in entries if s >= wall * min_fraction]
    entries.sort(key=lambda e: e[1], reverse=True)
    parts = [f"{p} {s * 1e3:.1f}ms" for p, s in entries[:max_phases]]
    cov = timeline_dict.get("coverage", 0.0)
    return f"{' · '.join(parts)} ({cov * 100:.0f}% attributed)"
