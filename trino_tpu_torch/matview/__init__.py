"""Materialized views: version-fresh precomputation served as table scans
(the port of trino_tpu/matview/).

Three pieces (reference: the connector-SPI materialized view flow —
``getMaterializedView`` / ``MaterializedViewFreshness``):

- ``registry.py`` — the coordinator-owned metadata store (definitions,
  storage location, canonical match keys, per-refresh base/storage data
  versions);
- ``substitute.py`` — the transparent planner pass: a query subtree whose
  canonical plan fingerprint equals a FRESH view's definition rewrites
  into a scan of the precomputed storage table (which the device cache
  then serves from the session's device);
- ``lifecycle.py`` — CREATE / REFRESH / DROP execution over the plain
  connector write SPI, with the atomic version swap that makes staleness
  a provable, never-wrong-rows property.
"""
from trino_tpu_torch.matview.registry import (
    MaterializedView, MaterializedViewRegistry, drop_payload, from_payload, to_payload)
from trino_tpu_torch.matview.substitute import (
    staleness_reason, substitute_plan, substitution_enabled, substitution_versions)

__all__ = [
    "MaterializedView", "MaterializedViewRegistry", "drop_payload",
    "from_payload", "to_payload", "staleness_reason", "substitute_plan",
    "substitution_enabled", "substitution_versions",
]
