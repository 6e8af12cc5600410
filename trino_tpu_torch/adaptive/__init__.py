"""Adaptive query execution of the port (the port of trino_tpu/adaptive/;
reference: ``sql/planner/AdaptivePlanner.java``): the coordinator acts on
the task -> stage stats at stage boundaries.

1. join-distribution switch: flip broadcast<->partitioned when a build
   side's actual rows contradict the estimate across
   ``join_max_broadcast_rows`` (``replanner.py``);
2. capacity-hint reseeding: exchange sources stamp actual upstream output
   rows, and the compiled tier sizes expansion capacities from the staged
   keys (``reseed.py``, one device);
3. skew mitigation: hot partitions found from per-partition output rows are
   salted, the probe producer spreading them over every partition and the
   build producer replicating them (``replanner.py`` +
   ``parallel/exchange.spread_partition_ids``).

Every adaptation is a versioned plan change on the query (``GET
/v1/query/{id}`` planVersions, EXPLAIN ANALYZE ``[adapted: ...]``, a
``plan/adapt`` span, ``ADAPTIVE_*`` metrics), gated by the ``adaptive_*``
session properties.
"""
from trino_tpu_torch.adaptive.replanner import AdaptivePlanner, PlanChange
from trino_tpu_torch.adaptive.runtime_stats import RuntimeStatsProvider

__all__ = ["AdaptivePlanner", "PlanChange", "RuntimeStatsProvider"]
