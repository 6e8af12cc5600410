"""Process-wide counters for the port's local path.

A small stand-in for the reference's metrics registry
(trino_tpu/obs/metrics.py): plain labelled counters with the same
``inc(amount, *labels)`` / ``value(*labels)`` surface, and no exposition
format. The tests and ``chip_smoke.py`` read them to show which join tier a
query took.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple


class Counter:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1, *labelvalues) -> None:
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + amount

    def value(self, *labelvalues) -> float:
        with self._lock:
            return self._children.get(tuple(str(v) for v in labelvalues), 0)


PLAN_VALIDATION_FAILURES = Counter("plan_validation_failures_total")
GENCACHE_HITS = Counter("tpch_gencache_hits_total")
GENCACHE_MISSES = Counter("tpch_gencache_misses_total")
GENCACHE_EVICTIONS = Counter("tpch_gencache_evictions_total")
# join kernel selections by the executor's tier gate (tier = dense | fused
# | merge-sorted | merge-pallas | legacy)
FUSED_JOIN_SELECTIONS = Counter("fused_join_selections_total")
