"""Query-lifecycle span tracer.

Reference: the OpenTelemetry wiring threaded through the reference engine —
``io.opentelemetry.api.trace.Tracer`` injected into
``QueuedStatementResource`` / ``DispatchManager`` / ``SqlTaskManager``, with
W3C ``traceparent`` propagation on internal HTTP so worker task spans parent
into the query's trace. Here the tracer is a small in-process recorder: one
``Tracer`` per query (coordinator side) or per task (worker side), spans are
plain records, and the coordinator assembles the cross-process tree on read
(``GET /v1/query/{id}/trace``) by merging worker span dumps.

Two usage surfaces:

- explicit: ``with tracer.span("schedule") as sp: ...`` — used where the
  owning component holds the tracer (coordinator lifecycle, task body);
- ambient: ``with span("optimize"): ...`` — used by layers that must not
  grow a tracer parameter (planner, compiled execution). Ambient spans
  attach to whatever tracer ``activate()``-d on this thread and no-op
  (recording nothing, at ~dict-lookup cost) when none is active, so
  instrumentation is safe on every path including bare-``Session`` use;
- timed: ``with timed("parse", M.PLAN_SECONDS): ...`` — an ambient span
  that also adds its seconds to a registered counter, with or without a
  tracer, from the same two clock reads. Only the outermost open span of
  a counter's family on the thread feeds it, so nested work counts once.
  The port's own fine-grained spans (``detail=True``) go only into
  tracers that keep detail (``Tracer.detail``, off for the serving
  tiers' per-query and per-task tracers).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from typing import Dict, List, Optional

_CURRENT: "contextvars.ContextVar" = contextvars.ContextVar(
    "trino_tpu_trace", default=None)

# W3C-style trace context header stamped on internal HTTP (task create,
# exchange pulls): ``<version>-<trace_id>-<parent_span_id>-<flags>``.
TRACEPARENT_HEADER = "X-Trino-Tpu-Traceparent"


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class Span:
    """One recorded operation: identity, tree position, wall interval,
    attributes. ``end`` is None while the span is open. The start/end
    timestamps are wall-clock (for cross-process ordering in the tree);
    the DURATION is measured on the monotonic clock, so an NTP step
    mid-span cannot produce negative or inflated span times."""

    __slots__ = ("span_id", "parent_id", "name", "attributes", "start",
                 "end", "_t0", "duration")

    def __init__(self, name: str, parent_id: Optional[str],
                 attributes: Optional[dict] = None):
        self.span_id = _hex_id(8)
        self.parent_id = parent_id
        self.name = name
        self.attributes: Dict[str, object] = dict(attributes or {})
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.end: Optional[float] = None
        self.duration: Optional[float] = None

    def set(self, key: str, value) -> None:
        # copy-on-write: a live trace poll (to_dict on a handler thread)
        # snapshots `attributes` while owner/puller threads set keys — the
        # atomic rebind means readers always iterate a dict that is never
        # mutated, with no per-span lock
        self.attributes = {**self.attributes, key: value}

    def close(self, duration: Optional[float] = None) -> bool:
        """Close once; True only on the closing transition (end_span uses
        this to record each span into the flight recorder exactly once
        even though lifecycle code calls it again as a safety net).
        ``duration``: seconds the caller already measured from ``_t0``."""
        if self.end is None:
            self.end = time.time()
            self.duration = (time.perf_counter() - self._t0 if duration is None
                             else duration)
            return True
        return False

    @property
    def duration_s(self) -> Optional[float]:
        return self.duration

    def to_dict(self) -> dict:
        return {
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "start": self.start,
            "durationS": (round(self.duration_s, 6)
                          if self.end is not None else None),
            "attributes": dict(self.attributes),
        }


class _NoopSpan:
    """Ambient-span stand-in when no tracer is active: accepts attribute
    writes and records nothing."""

    span_id = None
    parent_id = None

    def set(self, key: str, value) -> None:
        pass


NOOP_SPAN = _NoopSpan()

# per-tracer span storage cap (satellite of the phase-ledger PR): a
# pathological query — a streaming producer emitting a span per batch,
# a retry storm — must not grow coordinator/worker memory without bound.
# At the cap new spans still TIME correctly (callers get a live Span) but
# are not stored; drops are counted so the truncation is visible.
DEFAULT_MAX_SPANS = int(os.environ.get("TRINO_TPU_TRACE_MAX_SPANS", "4096"))


class Tracer:
    """Thread-safe per-query (or per-task) span recorder.

    Nesting is tracked through the ambient context (one mechanism for both
    the explicit and ambient surfaces): a span parents to the innermost
    open span of THIS tracer on the current thread, falling back to
    ``root_parent_id`` — which is how worker task spans attach under the
    coordinator's propagated schedule span. Cross-thread children (exchange
    puller threads) pass ``parent_id`` explicitly.
    """

    def __init__(self, trace_id: Optional[str] = None,
                 root_parent_id: Optional[str] = None,
                 max_spans: Optional[int] = None, detail: bool = True):
        self.trace_id = trace_id or _hex_id(16)
        self.root_parent_id = root_parent_id
        self.max_spans = DEFAULT_MAX_SPANS if max_spans is None else max_spans
        # detail: also record the port's own fine-grained host spans (the
        # executor's run, its plan nodes and host passes, the result rows,
        # the compiled replay's parts). The serving tiers' per-query and
        # per-task tracers turn it off: their traces keep the reference's
        # vocabulary, and a task that runs its fragment once a split or a
        # batch stays under the span cap
        self.detail = detail
        # optional per-process FlightRecorder (obs/flightrecorder.py):
        # every closed span also lands in the owning server's bounded
        # ring, which is what the failure postmortem snapshots
        self.recorder = None
        self.dropped_spans = 0
        self._spans: List[Span] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------ recording
    def start_span(self, name: str, parent_id: Optional[str] = None,
                   **attributes) -> Span:
        """Open a span WITHOUT making it the current parent (for spans that
        close on a different thread, e.g. async pulls)."""
        if parent_id is None:
            parent_id = self.current_span_id() or self.root_parent_id
        sp = Span(name, parent_id, attributes)
        with self._lock:
            if len(self._spans) >= self.max_spans:
                # cap reached: the span still times and parents correctly
                # for its caller, it just isn't RETAINED — and the drop is
                # loud (counter + per-tracer tally), never silent
                self.dropped_spans += 1
                dropped = True
            else:
                self._spans.append(sp)
                dropped = False
        if dropped:
            from trino_tpu_torch.obs import metrics as M

            M.SPANS_DROPPED.inc()
        return sp

    def end_span(self, span: Span, duration: Optional[float] = None) -> None:
        if span.close(duration) and self.recorder is not None:
            self.recorder.record_span(span.to_dict(), self.trace_id)

    @contextlib.contextmanager
    def span(self, name: str, parent_id: Optional[str] = None, **attributes):
        sp = self.start_span(name, parent_id=parent_id, **attributes)
        token = _CURRENT.set((self, sp.span_id))
        try:
            yield sp
        finally:
            _CURRENT.reset(token)
            self.end_span(sp)

    def current_span_id(self) -> Optional[str]:
        cur = _CURRENT.get()
        if cur is not None and cur[0] is self:
            return cur[1]
        return None

    # ------------------------------------------------------------ exporting
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def to_dicts(self) -> List[dict]:
        return [s.to_dict() for s in self.spans()]

    def traceparent(self, span_id: Optional[str] = None) -> str:
        """Header value carrying this trace's context to another process."""
        sid = span_id or self.current_span_id() or self.root_parent_id or "0" * 16
        return f"00-{self.trace_id}-{sid}-01"


def parse_traceparent(value: Optional[str]):
    """``(trace_id, parent_span_id)`` from a propagated header, or None when
    absent/malformed (a missing header just starts a detached trace)."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4 or not parts[1] or not parts[2]:
        return None
    return parts[1], parts[2]


# ------------------------------------------------------- ambient trace API
def current(detail: bool = False):
    """``(tracer, span_id)`` of the innermost active ambient span, else
    None; with ``detail``, None also where the tracer keeps no detail
    (``Tracer.detail``)."""
    cur = _CURRENT.get()
    if detail and cur is not None and not cur[0].detail:
        return None
    return cur


@contextlib.contextmanager
def activate(tracer: Tracer, span_id: Optional[str] = None):
    """Make ``tracer`` the thread's ambient tracer so library-level
    ``span()`` calls record into it (set at thread entry points: the
    coordinator's query thread, the worker's task thread)."""
    token = _CURRENT.set((tracer, span_id or tracer.root_parent_id))
    try:
        yield tracer
    finally:
        _CURRENT.reset(token)


def span(name: str, **attributes) -> "timed":
    """Ambient span: records into the active tracer, no-ops without one
    (``timed`` with no counter)."""
    return timed(name, None, **attributes)


def open_span(cur, name: str, t0: float, **attributes):
    """Open an ambient span under ``cur`` (what ``current()`` returned,
    not None) that started at ``t0`` on ``time.perf_counter``, and make it
    the thread's innermost: ``(span, token)`` for ``close_span``."""
    tracer, parent_id = cur
    sp = tracer.start_span(name, parent_id=parent_id, **attributes)
    sp._t0 = t0
    return sp, _CURRENT.set((tracer, sp.span_id))


def close_span(cur, sp: Span, token, duration: float) -> None:
    """Close a span of ``open_span`` after ``duration`` seconds from its
    ``t0``, restoring the thread's innermost span."""
    _CURRENT.reset(token)
    cur[0].end_span(sp, duration)


_FAMILIES = threading.local()  # .open: the counters a span on this thread feeds


def _open_families() -> set:
    try:
        return _FAMILIES.open
    except AttributeError:
        _FAMILIES.open = set()
        return _FAMILIES.open


class timed:
    """``with timed(name, counter, detail=False, **attributes) as sp``: an
    ambient span whose seconds also go to ``counter`` (a registered
    ``Counter``, or None for a span alone); ``detail`` marks one of the
    port's own fine-grained spans (``Tracer.detail``).

    With a tracer active it records a ``Span``, and the counter gets that
    span's own ``duration``. Without one it reads
    ``time.perf_counter`` twice and makes one ``inc``; no ``Span`` is
    made, and ``sp`` is ``NOOP_SPAN``. A counter is fed only by the
    outermost open ``timed`` of its family (the spans that feed it) on
    the thread, so a plan that plans inside planning, or a host pass
    inside another, counts once."""

    __slots__ = ("name", "counter", "detail", "attributes", "_cur", "_feeds", "_t0", "_span",
                 "_token")

    def __init__(self, name: str, counter=None, detail: bool = False, **attributes):
        self.name = name
        self.counter = counter
        self.detail = detail
        self.attributes = attributes

    def __enter__(self):
        counter = self.counter
        feeds = False
        if counter is not None:
            families = _open_families()
            if counter not in families:
                families.add(counter)
                feeds = True
        self._feeds = feeds
        self._cur = cur = current(self.detail)
        if cur is None and not feeds:
            return NOOP_SPAN
        self._t0 = t0 = time.perf_counter()
        if cur is None:
            return NOOP_SPAN
        self._span, self._token = open_span(cur, self.name, t0, **self.attributes)
        return self._span

    def __exit__(self, *exc) -> bool:
        cur = self._cur
        if cur is None and not self._feeds:
            return False
        duration = time.perf_counter() - self._t0
        if cur is not None:
            close_span(cur, self._span, self._token, duration)
        if self._feeds:
            _FAMILIES.open.discard(self.counter)
            self.counter.inc(duration)
        return False


# -------------------------------------------------------- tree assembly
def build_tree(span_dicts: List[dict]) -> Optional[dict]:
    """Nest exported span records into one rooted tree.

    The root is the span without a parent in the set that started earliest
    (the coordinator's ``query`` span). Spans whose parent id is unknown —
    e.g. a worker dump that arrived without its coordinator parent — attach
    under the root rather than being dropped, so the tree is always single-
    rooted and lossless."""
    if not span_dicts:
        return None
    nodes = {}
    for s in span_dicts:
        node = dict(s)
        node["children"] = []
        nodes[node["spanId"]] = node
    roots = [n for n in nodes.values()
             if n.get("parentId") not in nodes]
    roots.sort(key=lambda n: n["start"])
    root = roots[0]
    for n in nodes.values():
        if n is root:
            continue
        parent = nodes.get(n.get("parentId"))
        if parent is None:
            parent = root
        parent["children"].append(n)
    for n in nodes.values():
        n["children"].sort(key=lambda c: c["start"])
    return root


def flatten_tree(tree: Optional[dict]):
    """Depth-first span records of a ``build_tree`` result (test helper)."""
    if tree is None:
        return
    stack = [tree]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(reversed(node["children"]))
