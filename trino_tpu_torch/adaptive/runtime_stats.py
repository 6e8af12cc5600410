"""Runtime stats provider: stage-boundary snapshots of the task -> stage
rollups. The port of trino_tpu/adaptive/runtime_stats.py.

Reference role: the ``RuntimeInfoProvider`` handed to Trino's
``AdaptivePlanner`` — a read-only view of what the workers actually did,
decoupled from how the coordinator collects it. The provider wraps the
coordinator's slot-keyed task-stats map (``QueryExecution.task_stats``) and
answers the questions the re-planning rules ask: is this stage's output
final, how many rows did it actually produce, and how were its output
bytes distributed across partitions.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional


class RuntimeStatsProvider:
    """Point-in-time view of worker-reported task stats, grouped by stage.

    ``task_entries_fn`` returns the coordinator's current slot records
    (``{"fragment": int, "state": str, "stats": {...}}`` — one per task
    slot, so retried or speculative attempts never double count); ``sweep_fn``
    (optional) forces one fresh status sweep before the snapshot so a
    stage-boundary decision never acts on stale numbers;
    ``expected_tasks_fn`` (optional) returns how many tasks the stage was
    scheduled with — REQUIRED knowledge for flush detection, because a
    task whose create-response seeding failed and whose polls keep timing
    out simply has no slot record, and summing the slots that happen to
    exist would pass a partial number off as truth.
    """

    # a stage's outputs are FINAL once every task is at least FLUSHING:
    # the task body has finished and its output rows/bytes are recorded
    # before the FLUSHING transition (server/task.py)
    FLUSHED_STATES = ("FLUSHING", "FINISHED")

    def __init__(self, task_entries_fn: Callable[[], List[dict]],
                 sweep_fn: Optional[Callable[[], object]] = None,
                 expected_tasks_fn: Optional[Callable[[int], int]] = None):
        self._task_entries_fn = task_entries_fn
        self._sweep_fn = sweep_fn
        self._expected_tasks_fn = expected_tasks_fn
        self._by_frag: Dict[int, List[dict]] = {}

    def snapshot(self) -> "RuntimeStatsProvider":
        """Refresh the view (one status sweep + regroup); returns self so
        call sites can chain ``provider.snapshot().output_rows(fid)``."""
        if self._sweep_fn is not None:
            self._sweep_fn()
        by_frag: Dict[int, List[dict]] = {}
        for e in self._task_entries_fn():
            by_frag.setdefault(e["fragment"], []).append(e)
        self._by_frag = by_frag
        return self

    def stage_flushed(self, fragment_id: int) -> bool:
        """True when every task of the stage reported FLUSHING or later —
        its output rows/bytes are final even while buffers still drain.
        A stage with fewer slot records than scheduled tasks is NOT
        flushed, whatever the present records say."""
        entries = self._by_frag.get(fragment_id)
        if not entries:
            return False
        if self._expected_tasks_fn is not None:
            expected = self._expected_tasks_fn(fragment_id)
            if expected <= 0 or len(entries) < expected:
                return False
        return all(e.get("state") in self.FLUSHED_STATES for e in entries)

    def output_rows(self, fragment_id: int) -> Optional[int]:
        """ACTUAL rows the stage produced, or None while any task still
        runs (a partial sum must never masquerade as truth)."""
        if not self.stage_flushed(fragment_id):
            return None
        return sum(
            int((e.get("stats") or {}).get("outputRows", 0))
            for e in self._by_frag.get(fragment_id, ()))

    def _partition_series(self, fragment_id: int,
                          key: str) -> Optional[List[int]]:
        if not self.stage_flushed(fragment_id):
            return None
        total: Optional[List[int]] = None
        for e in self._by_frag.get(fragment_id, ()):
            pb = (e.get("stats") or {}).get(key)
            if pb is None:
                continue
            if total is None:
                total = [0] * len(pb)
            for i, b in enumerate(pb[: len(total)]):
                total[i] += int(b)
        return total

    def partition_bytes(self, fragment_id: int) -> Optional[List[int]]:
        """Per-partition output bytes summed across the stage's tasks
        (hash-partitioned producers only), or None while running / when no
        task reported a partition breakdown."""
        return self._partition_series(fragment_id, "partitionBytes")

    def partition_rows(self, fragment_id: int) -> Optional[List[int]]:
        """Per-partition LIVE output rows — the skew-detection signal
        (bytes are serde-compressed, and a constant hot key compresses to
        almost nothing, inverting the byte signal)."""
        return self._partition_series(fragment_id, "partitionRows")
