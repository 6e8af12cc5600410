"""Typed per-operator execution statistics: the port of
trino_tpu/exec/operator_stats.py's ``OperatorStats``,
``merge_operator_dicts`` and ``wall_time_header``.

Reference: ``operator/OperatorStats.java`` (one record per operator
instance: input/output positions+bytes, wall/CPU nanos, peak memory),
which feeds ``EXPLAIN ANALYZE``'s plan annotations (PlanPrinter stats
injection). One ``OperatorStats`` accumulates across *repeated*
executions of the same plan node (a node re-executed per probe batch or
per split ADDS, never overwrites), so a rollup is a plain sum/max.

Not ported: the task -> stage -> query rollups
(``rollup_tasks_to_stage``, ``rollup_stages_to_query``) and
``merge_kernel_lists``, which wait for the device profiler and the
stats rollups (ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable


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


def wall_time_header(plan_s: float, exec_s: float) -> str:
    """The EXPLAIN ANALYZE header line, shared by the local and distributed
    paths: total wall includes planning so it agrees with the query-level
    span totals."""
    return (f"Query wall time: {(plan_s + exec_s) * 1e3:.1f}ms"
            f" (planning {plan_s * 1e3:.1f}ms,"
            f" execution {exec_s * 1e3:.1f}ms)")
