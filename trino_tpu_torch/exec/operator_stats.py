"""Typed per-operator execution statistics and the task -> stage -> query
rollup: the port of trino_tpu/exec/operator_stats.py.

Reference: ``operator/OperatorStats.java`` (one record per operator
instance: input/output positions+bytes, wall/CPU nanos, peak memory)
aggregated by ``TaskStats`` -> ``StageStats`` -> ``QueryStats``, which feed
``EXPLAIN ANALYZE``'s plan annotations (PlanPrinter stats injection). One
``OperatorStats`` accumulates across *repeated* executions of the same plan
node (a node re-executed per probe batch or per split ADDS, never
overwrites), so every rollup is a plain sum/max:

- worker: the executor's ``node_stats`` and ``kernel_stats``, folded into
  the task's status payload (server/task.py);
- coordinator: task records merge per stage (``rollup_tasks_to_stage``) and
  stages per query (``rollup_stages_to_query``), server/coordinator.py;
- printers: ``format_plan`` / ``format_fragments`` annotate plan nodes from
  a ``Dict[int, OperatorStats]`` whichever process produced it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List


@dataclasses.dataclass
class OperatorStats:
    """Cumulative stats for one plan node (identified by plan-node id)."""

    node_id: int
    operator: str  # operator kind: "TableScan", "Join", "Aggregation", ...
    input_rows: int = 0
    output_rows: int = 0
    output_bytes: int = 0
    wall_s: float = 0.0
    device_s: float = 0.0  # device-execute seconds attributed to this node
    peak_bytes: int = 0  # largest single output reservation observed
    splits: int = 0  # splits completed (scans only)
    invocations: int = 0

    def add(self, other: "OperatorStats") -> None:
        """Fold another record for the SAME node into this one (additive
        fields sum, peaks max) — used across tasks and across workers."""
        self.input_rows += other.input_rows
        self.output_rows += other.output_rows
        self.output_bytes += other.output_bytes
        self.wall_s += other.wall_s
        self.device_s += other.device_s
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)
        self.splits += other.splits
        self.invocations += other.invocations

    def to_dict(self) -> dict:
        return {
            "nodeId": self.node_id,
            "operator": self.operator,
            "inputRows": self.input_rows,
            "outputRows": self.output_rows,
            "outputBytes": self.output_bytes,
            "wallS": round(self.wall_s, 6),
            "deviceS": round(self.device_s, 6),
            "peakBytes": self.peak_bytes,
            "splits": self.splits,
            "invocations": self.invocations,
        }

    @staticmethod
    def from_dict(d: dict) -> "OperatorStats":
        return OperatorStats(
            node_id=int(d["nodeId"]),
            operator=str(d.get("operator", "?")),
            input_rows=int(d.get("inputRows", 0)),
            output_rows=int(d.get("outputRows", 0)),
            output_bytes=int(d.get("outputBytes", 0)),
            wall_s=float(d.get("wallS", 0.0)),
            device_s=float(d.get("deviceS", 0.0)),
            peak_bytes=int(d.get("peakBytes", 0)),
            splits=int(d.get("splits", 0)),
            invocations=int(d.get("invocations", 0)),
        )


def merge_operator_dicts(
        dict_lists: Iterable[Iterable[dict]]) -> Dict[int, OperatorStats]:
    """Merge per-task ``operatorStats`` payload lists by plan-node id —
    tasks of one stage run the same fragment subtree, so equal node ids
    across tasks (and across workers) are the same operator."""
    merged: Dict[int, OperatorStats] = {}
    for ops in dict_lists:
        for d in ops or ():
            st = OperatorStats.from_dict(d)
            have = merged.get(st.node_id)
            if have is None:
                merged[st.node_id] = st
            else:
                have.add(st)
    return merged


def merge_kernel_lists(dict_lists: Iterable[Iterable[dict]]) -> List[dict]:
    """Merge per-task ``kernelStats`` payload lists (kernel-ledger rows,
    obs/devprofiler.py wire shape) — additive by construction, keyed by
    (plan node, operator, tier, node) so per-worker attribution survives
    the stage rollup."""
    from trino_tpu_torch.obs.devprofiler import merge_kernel_rows

    merged: Dict[tuple, dict] = {}
    for rows in dict_lists:
        merge_kernel_rows(merged, list(rows or ()))
    return [merged[k] for k in sorted(merged)]


def _stage_state(task_entries: List[dict]) -> str:
    """A stage is FINISHED only when every task finished; any failed or
    canceled task marks the whole stage (a FAILED stage must never read as
    successfully completed)."""
    states = [e.get("state") for e in task_entries]
    if any(s == "FAILED" for s in states):
        return "FAILED"
    if any(s == "CANCELED" for s in states):
        return "CANCELED"
    if states and all(s == "FINISHED" for s in states):
        return "FINISHED"
    return "RUNNING"


def rollup_tasks_to_stage(fragment_id: int, task_entries: List[dict],
                          include_operators: bool = True) -> dict:
    """One stage's rollup from its tasks' status records.

    ``task_entries`` are coordinator-side records: ``{"state": str,
    "stats": <task stats snapshot>}`` — one per task SLOT (retried or
    speculative attempts replace the slot's record, so nothing double
    counts). ``include_operators=False`` skips the per-node merge for
    callers that only need the scalar summary (protocol polls, UI)."""
    ops = merge_operator_dicts(
        e.get("stats", {}).get("operatorStats")
        for e in task_entries) if include_operators else {}
    stage = {
        "stageId": fragment_id,
        "tasks": len(task_entries),
        "completedTasks": sum(
            1 for e in task_entries if e.get("state") == "FINISHED"),
        "state": _stage_state(task_entries),
        "completedSplits": 0,
        "totalSplits": 0,
        "inputRows": 0,
        "outputRows": 0,
        "outputBytes": 0,
        "wallS": 0.0,
        "deviceS": 0.0,
        "peakBytes": 0,
        "spills": 0,
        "shedBytes": 0,
        "yieldEvents": 0,
        "deviceCacheHits": 0,
        "deviceCacheMisses": 0,
        "operatorStats": [ops[k].to_dict() for k in sorted(ops)],
        "kernelStats": merge_kernel_lists(
            e.get("stats", {}).get("kernelStats")
            for e in task_entries) if include_operators else [],
    }
    part_bytes = None
    part_rows = None
    for e in task_entries:
        s = e.get("stats") or {}
        stage["completedSplits"] += int(s.get("completedSplits", 0))
        stage["totalSplits"] += int(s.get("totalSplits", 0))
        stage["inputRows"] += int(s.get("inputRows", 0))
        stage["outputRows"] += int(s.get("outputRows", 0))
        stage["outputBytes"] += int(s.get("outputBytes", 0))
        stage["wallS"] += float(s.get("elapsedS", 0.0))
        stage["deviceS"] += float(s.get("deviceS", 0.0))
        stage["peakBytes"] = max(stage["peakBytes"],
                                 int(s.get("peakBytes", 0)))
        stage["spills"] += int(s.get("spills", 0))
        # memory-ledger ride-along: bytes shed from the revocable caches
        # on this task's behalf + yield events — SUMS (each task's sheds
        # are distinct reclamations, unlike the shared-pool peak)
        stage["shedBytes"] += int(s.get("shedBytes", 0))
        stage["yieldEvents"] += int(s.get("yieldEvents", 0))
        stage["deviceCacheHits"] += int(s.get("deviceCacheHits", 0))
        stage["deviceCacheMisses"] += int(s.get("deviceCacheMisses", 0))
        # per-partition output bytes sum ELEMENTWISE across tasks: every
        # producer task contributes rows to every partition, so the stage
        # view is the skew signal (adaptive re-planner / UI)
        pb = s.get("partitionBytes")
        if pb is not None:
            if part_bytes is None:
                part_bytes = [0] * len(pb)
            for i, b in enumerate(pb[: len(part_bytes)]):
                part_bytes[i] += int(b)
        pr = s.get("partitionRows")
        if pr is not None:
            if part_rows is None:
                part_rows = [0] * len(pr)
            for i, r in enumerate(pr[: len(part_rows)]):
                part_rows[i] += int(r)
    if part_bytes is not None:
        stage["partitionBytes"] = part_bytes
    if part_rows is not None:
        stage["partitionRows"] = part_rows
    stage["wallS"] = round(stage["wallS"], 6)
    stage["deviceS"] = round(stage["deviceS"], 6)
    return stage


def rollup_stages_to_query(stages: List[dict]) -> dict:
    """Query-level totals from stage rollups (reference: QueryStats).

    ``totalRows``/``totalBytes`` count work PROCESSED (stage input rows /
    stage output bytes), the progress numbers a client renders; peaks max
    across stages because stages share each worker's memory pool."""
    q = {
        "stages": len(stages),
        "completedStages": sum(
            1 for s in stages if s.get("state") == "FINISHED"),
        "completedSplits": sum(int(s.get("completedSplits", 0)) for s in stages),
        "totalSplits": sum(int(s.get("totalSplits", 0)) for s in stages),
        "totalRows": sum(int(s.get("inputRows", 0)) for s in stages),
        "totalBytes": sum(int(s.get("outputBytes", 0)) for s in stages),
        "wallS": round(sum(float(s.get("wallS", 0.0)) for s in stages), 6),
        "deviceS": round(sum(float(s.get("deviceS", 0.0)) for s in stages), 6),
        "peakBytes": max(
            [int(s.get("peakBytes", 0)) for s in stages], default=0),
        "spills": sum(int(s.get("spills", 0)) for s in stages),
        "shedBytes": sum(int(s.get("shedBytes", 0)) for s in stages),
        "yieldEvents": sum(int(s.get("yieldEvents", 0)) for s in stages),
        # warm-HBM serving signal: scans served from the device table
        # cache vs scans that paid a host->device transfer
        "deviceCacheHits": sum(
            int(s.get("deviceCacheHits", 0)) for s in stages),
        "deviceCacheMisses": sum(
            int(s.get("deviceCacheMisses", 0)) for s in stages),
    }
    return q


def wall_time_header(plan_s: float, exec_s: float) -> str:
    """The EXPLAIN ANALYZE header line, shared by the local and distributed
    paths: total wall includes planning so it agrees with the query-level
    span totals."""
    return (f"Query wall time: {(plan_s + exec_s) * 1e3:.1f}ms"
            f" (planning {plan_s * 1e3:.1f}ms,"
            f" execution {exec_s * 1e3:.1f}ms)")
