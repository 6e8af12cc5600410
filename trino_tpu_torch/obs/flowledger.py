"""Data-plane flow ledger: typed per-link transfer attribution
(a copy of trino_tpu/obs/flowledger.py).

Reference role: the observability half of Trino's data plane — the
exchange clients' ``DirectExchangeClientStatus`` / buffer utilization
histograms and the per-task ``outputBufferUtilization`` the Web UI reads
— collapsed into one typed per-process ledger, completing the quartet:
the phase ledger (obs/timeline.py) attributed every millisecond, the
memory ledger (obs/memledger.py) every byte *at rest*, the kernel ledger
(obs/devprofiler.py) every device dispatch; this module attributes every
byte *in motion*.

Design mirrors the memory ledger: one bounded ring per process, O(1)
append under a short lock, safe on the hot path. Three stores:

- a **transfer ring** of typed records — every cross-boundary transfer
  names its *link class* (:data:`LINK_CLASSES`), its *owner*
  (``query:<id>`` / ``task:<id>`` / ``segment-store`` / ``control``),
  src/dst node, bytes, pages, wall seconds and retries;
- a **per-(link, owner) rollup table** — bytes/pages/seconds/transfers/
  retries totals, from which effective MB/s derives
  (``system.runtime.transfers`` reads this, cluster-folded over the
  announce payload like the kernel ledger);
- a **stall ring + rollup** — backpressure samples from the producers'
  blocking sites (:data:`STALL_SITES`): output-buffer enqueue full-waits
  and exchange-client empty polls, each naming its (stage, partition)
  so "producer blocked on consumer" is readable per link.

On top of the same task statistics the coordinator already collects,
:func:`detect_stragglers` flags tasks whose elapsed exceeds a
configurable multiple of their stage's median and attributes each to its
dominant cause (:data:`STRAGGLER_CAUSES`) from the per-task ledger
seconds (``transferS`` / ``deviceS`` / ``stallS``).

Every link class, stall site and straggler cause must be documented in
README's flow-ledger section (``tools/check_flow_docs.py`` gates it),
and ``record_transfer`` / ``record_stall`` must never be called while
holding a lock (``tools/lint/lock_discipline.py``): the append itself
takes the ledger lock, and records fan out to the metrics registry and
the flight recorder.

This module is import-clean standalone (stdlib only at import time).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

DEFAULT_CAPACITY = 512
STALL_CAPACITY = 512

# every link class a transfer record may carry; tools/check_flow_docs.py
# requires each to be documented in README's flow-ledger section
LINK_CLASSES = (
    "exchange-pull",      # serialized pages pulled from an upstream
                          # task's output buffer (or its durable spool)
    "spool-write",        # result/exchange segments rolled to durable
                          # storage by this process's segment store
    "segment-fetch",      # segment bytes served to a client (full GET
                          # or a Range slice)
    "staging-transfer",   # host->device DMA blocks issued by the
                          # staging pipeline's blocked_transfer
    "client-drain",       # statement-protocol result bytes serialized
                          # to a draining client
    "control",            # cluster-internal JSON control calls
                          # (announce, task submit/status, cancel)
)

# blocking sites sampled into the backpressure stall series
STALL_SITES = (
    "buffer-enqueue",     # producer blocked: output buffer at capacity
    "exchange-poll",      # consumer starved: pull returned zero pages
)

STRAGGLER_CAUSES = (
    "transfer-bound",     # dominant ledger seconds: exchange/spool pulls
    "device-bound",       # dominant ledger seconds: device execution
    "queue-bound",        # dominant ledger seconds: backpressure stalls
)

# a task is a straggler when elapsed > multiple x stage median
DEFAULT_STRAGGLER_MULTIPLE = 3.0
# ...and elapsed clears an absolute floor, so millisecond-scale stages
# (metadata fragments, tiny-schema tests) never flag ratio noise
DEFAULT_STRAGGLER_MIN_ELAPSED_S = 0.25


class FlowLedger:
    """One process's flow ledger. Transfer records are plain dicts:
    ``{"ts", "link", "owner", "bytes", "pages", "seconds", "src", "dst",
    "direction", ["retries", "status", ...]}``."""

    def __init__(self, node_id: str = "", capacity: int = DEFAULT_CAPACITY,
                 stall_capacity: int = STALL_CAPACITY):
        self.node_id = node_id
        self._ring: "deque[dict]" = deque(maxlen=capacity)
        self._stall_ring: "deque[dict]" = deque(maxlen=stall_capacity)
        self._lock = threading.Lock()
        # (link, owner) -> cumulative rollup
        self._rollup: Dict[tuple, dict] = {}
        # (site, stage, partition) -> cumulative stall rollup
        self._stall_rollup: Dict[tuple, dict] = {}
        self._sent = 0
        self._received = 0
        self._recorder = None

    # ------------------------------------------------------------ wiring
    def attach_recorder(self, recorder) -> None:
        """Mirror retried transfers into the process flight recorder so a
        postmortem names flaky links without a second capture path."""
        self._recorder = recorder

    # ------------------------------------------------------------ append
    def record_transfer(self, link: str, owner: str, nbytes: int,
                        seconds: float, *, pages: int = 0,
                        src: Optional[str] = None, dst: Optional[str] = None,
                        direction: str = "recv", retries: int = 0,
                        status: Optional[str] = None,
                        ring: bool = True, **attrs) -> None:
        """Append one typed transfer, O(1) under a short lock.

        MUST be called with no locks held (lock-discipline rule
        ``ledger-append-under-lock``): records fan out to the metrics
        registry and the flight recorder beyond the ledger's own lock.
        ``ring=False`` updates the rollup/net totals only — the control
        link uses it so announce heartbeats (2/s/worker) never evict the
        data-plane records a postmortem wants.
        """
        if link not in LINK_CLASSES:
            raise ValueError(f"unknown flow-ledger link class: {link!r}")
        nbytes = int(nbytes)
        seconds = max(0.0, float(seconds))
        rec = {"ts": time.time(), "link": link, "owner": owner,
               "bytes": nbytes, "pages": int(pages),
               "seconds": round(seconds, 6), "direction": direction}
        if src is not None:
            rec["src"] = src
        if dst is not None:
            rec["dst"] = dst
        if retries:
            rec["retries"] = int(retries)
        if status is not None:
            rec["status"] = status
        rec.update(attrs)
        key = (link, owner)
        with self._lock:
            if ring:
                self._ring.append(rec)
            roll = self._rollup.get(key)
            if roll is None:
                roll = {"bytes": 0, "pages": 0, "seconds": 0.0,
                        "transfers": 0, "retries": 0, "lastStatus": None}
                self._rollup[key] = roll
            roll["bytes"] += nbytes
            roll["pages"] += int(pages)
            roll["seconds"] += seconds
            roll["transfers"] += 1
            roll["retries"] += int(retries)
            if status is not None:
                roll["lastStatus"] = status
            if direction == "send":
                self._sent += nbytes
            else:
                self._received += nbytes
        # fan-out OUTSIDE the ledger lock: metrics + recorder take their
        # own locks, and the lint rule bans appends under any held lock
        try:
            from trino_tpu_torch.obs import metrics as M

            M.TRANSFER_BYTES.inc(nbytes, link, direction)
            M.TRANSFER_SECONDS.inc(seconds, link)
        except Exception:  # noqa: BLE001 — accounting never fails work
            pass
        if retries and self._recorder is not None:
            self._recorder.record(
                "flow", "flow/retry", link=link, owner=owner, bytes=nbytes,
                retries=int(retries), status=status or "")

    def record_stall(self, site: str, stage, partition, waited_s: float, *,
                     depth_bytes: int = 0, limit_bytes: int = 0) -> None:
        """One backpressure sample: a producer blocked ``waited_s`` at
        ``site`` for (stage, partition), with the queue depth it saw.
        Same lock discipline as :meth:`record_transfer`."""
        if site not in STALL_SITES:
            raise ValueError(f"unknown flow-ledger stall site: {site!r}")
        waited_s = max(0.0, float(waited_s))
        rec = {"ts": time.time(), "site": site, "stage": stage,
               "partition": partition, "waitedS": round(waited_s, 6),
               "depthBytes": int(depth_bytes), "limitBytes": int(limit_bytes)}
        key = (site, stage, partition)
        with self._lock:
            self._stall_ring.append(rec)
            roll = self._stall_rollup.get(key)
            if roll is None:
                roll = {"waits": 0, "stallS": 0.0, "lastDepthBytes": 0}
                self._stall_rollup[key] = roll
            roll["waits"] += 1
            roll["stallS"] += waited_s
            roll["lastDepthBytes"] = int(depth_bytes)
        try:
            from trino_tpu_torch.obs import metrics as M

            M.BACKPRESSURE_STALL_SECONDS.inc(waited_s, str(stage))
        except Exception:  # noqa: BLE001 — accounting never fails work
            pass

    # ------------------------------------------------------------- reads
    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """Oldest-first copy of the transfer ring."""
        with self._lock:
            records = list(self._ring)
        if limit is not None and len(records) > limit:
            records = records[-limit:]
        return records

    def stall_samples(self, limit: Optional[int] = None) -> List[dict]:
        """Oldest-first copy of the stall ring (the backpressure
        timeline: queue depth + wait duration per sample)."""
        with self._lock:
            records = list(self._stall_ring)
        if limit is not None and len(records) > limit:
            records = records[-limit:]
        return records

    def transfer_rows(self) -> List[dict]:
        """Per-(link, owner) rollup rows with derived effective MB/s —
        the ``system.runtime.transfers`` source and the announce payload's
        ``flows`` block."""
        with self._lock:
            items = [(k, dict(v)) for k, v in self._rollup.items()]
        rows = []
        for (link, owner), roll in sorted(items):
            seconds = roll["seconds"]
            rows.append({
                "link": link, "owner": owner, "bytes": roll["bytes"],
                "pages": roll["pages"], "transfers": roll["transfers"],
                "seconds": round(seconds, 6),
                "mbPerS": round(roll["bytes"] / seconds / 1e6, 3)
                          if seconds > 0 else None,
                "retries": roll["retries"],
                "lastStatus": roll["lastStatus"],
            })
        return rows

    def stall_rows(self) -> List[dict]:
        """Per-(site, stage, partition) stall rollups (announce payload's
        ``flowStalls`` block + the EXPLAIN ANALYZE annotations)."""
        with self._lock:
            items = [(k, dict(v)) for k, v in self._stall_rollup.items()]
        return [{
            "site": site, "stage": stage, "partition": partition,
            "waits": roll["waits"], "stallS": round(roll["stallS"], 6),
            "lastDepthBytes": roll["lastDepthBytes"],
        } for (site, stage, partition), roll in sorted(
            items, key=lambda kv: (kv[0][0], str(kv[0][1]), str(kv[0][2])))]

    def net_totals(self) -> Dict[str, int]:
        """Lifetime bytes this process sent/received across every link —
        the ``system.runtime.nodes`` net columns."""
        with self._lock:
            return {"sent": self._sent, "received": self._received}

    def owner_bytes(self, owner_prefix: str,
                    links: Optional[Iterable[str]] = None) -> int:
        """Total bytes attributed to owners matching ``owner_prefix``
        (optionally restricted to ``links``) — the conservation check's
        read side."""
        links = tuple(links) if links is not None else None
        with self._lock:
            return sum(
                roll["bytes"] for (link, owner), roll in self._rollup.items()
                if owner.startswith(owner_prefix)
                and (links is None or link in links))

    def flow_snapshot(self, last: int = 16) -> dict:
        """The postmortem / recorder-endpoint block: per-link rollups,
        net totals, the newest ``last`` transfer records (what was moving
        when the process died) and the stall rollups."""
        by_link: Dict[str, dict] = {}
        for row in self.transfer_rows():
            agg = by_link.setdefault(row["link"], {
                "bytes": 0, "pages": 0, "seconds": 0.0, "transfers": 0,
                "retries": 0})
            agg["bytes"] += row["bytes"]
            agg["pages"] += row["pages"]
            agg["seconds"] = round(agg["seconds"] + row["seconds"], 6)
            agg["transfers"] += row["transfers"]
            agg["retries"] += row["retries"]
        for agg in by_link.values():
            agg["mbPerS"] = (round(agg["bytes"] / agg["seconds"] / 1e6, 3)
                             if agg["seconds"] > 0 else None)
        return {"nodeId": self.node_id, "links": by_link,
                "net": self.net_totals(), "recent": self.snapshot(last),
                "stalls": self.stall_rows()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# ----------------------------------------------------- straggler detector
def _median(values: List[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    return (ordered[mid] if n % 2
            else (ordered[mid - 1] + ordered[mid]) / 2.0)


def straggler_cause(stats: dict) -> str:
    """The dominant cause for one task from its ledger seconds: the
    largest of transfer (exchange/spool pull wall), device (device
    execution) and queue (backpressure stall) seconds. Ties — including
    the all-zero degenerate case — resolve to ``device-bound``, the
    'the task itself was slow' reading."""
    transfer_s = float(stats.get("transferS", 0.0))
    device_s = float(stats.get("deviceS", 0.0))
    stall_s = float(stats.get("stallS", 0.0))
    if transfer_s > device_s and transfer_s > stall_s:
        return "transfer-bound"
    if stall_s > device_s and stall_s > transfer_s:
        return "queue-bound"
    return "device-bound"


def detect_stragglers(
        tasks: Iterable[dict],
        multiple: float = DEFAULT_STRAGGLER_MULTIPLE,
        min_elapsed_s: float = DEFAULT_STRAGGLER_MIN_ELAPSED_S) -> List[dict]:
    """Flag straggler tasks from coordinator task records.

    ``tasks`` are ``{"taskId", "fragment" | "stageId", "workerUri",
    "stats": {...}}`` records (``QueryExecution.task_records()`` shape).
    Per stage, a task is a straggler when its ``elapsedS`` exceeds
    ``multiple`` x the stage median AND clears ``min_elapsed_s``
    (absolute floor: millisecond stages never flag ratio noise). A stage
    with fewer than two tasks has no distribution and never flags. Each
    flagged task carries its dominant cause (:func:`straggler_cause`)."""
    by_stage: Dict[object, List[dict]] = {}
    for rec in tasks:
        stage = rec.get("stageId", rec.get("fragment"))
        by_stage.setdefault(stage, []).append(rec)
    flagged: List[dict] = []
    for stage_id, recs in by_stage.items():
        if len(recs) < 2:
            continue
        elapsed = [float((r.get("stats") or {}).get("elapsedS", 0.0))
                   for r in recs]
        median = _median(elapsed)
        threshold = max(median * float(multiple), float(min_elapsed_s))
        for rec, el in zip(recs, elapsed):
            if median <= 0.0 or el <= threshold:
                continue
            stats = rec.get("stats") or {}
            flagged.append({
                "taskId": rec.get("taskId"),
                "stageId": stage_id,
                "workerUri": rec.get("workerUri"),
                "elapsedS": round(el, 6),
                "stageMedianS": round(median, 6),
                "ratio": round(el / median, 3),
                "multiple": float(multiple),
                "cause": straggler_cause(stats),
                "completedSplits": int(stats.get("completedSplits", 0)),
            })
    flagged.sort(key=lambda r: r["ratio"], reverse=True)
    return flagged


# the per-process ledger (coordinator AND every worker — same pattern as
# the per-process metrics registry); servers stamp node_id at startup
FLOW_LEDGER = FlowLedger()
