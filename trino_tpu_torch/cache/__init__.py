"""Query caching subsystem (the port of trino_tpu/cache/).

Three layers, all keyed off the same canonical-plan machinery:

- ``plan_key``     — deterministic fingerprints of optimized plan trees
  (node kinds, channels, literals, table identities, connector data
  versions), with plan-node ids canonicalized so two plantings of the
  same SQL fingerprint identically;
- ``determinism``  — the analysis pass that marks a statement uncachable
  (non-deterministic functions, table functions, non-SELECT statements);
- ``result_cache`` — the coordinator's byte-budgeted LRU of final result
  pages with TTL + single-flight de-duplication, the logical-plan cache,
  and the ``QueryCache`` facade the coordinator wires in.

Invalidation is version-based, never notification-based: connectors
expose a cheap per-table ``data_version()`` token (connector/spi.py) that
is captured into the cache key at plan time, so any mutation changes the
key and stale entries miss naturally (then age out via TTL/LRU). All of it
is host code; none of it imports torch.
"""
from trino_tpu_torch.cache.determinism import uncachable_reason
from trino_tpu_torch.cache.plan_key import canonicalize_plan, plan_fingerprint
from trino_tpu_torch.cache.result_cache import PlanCache, QueryCache, ResultCache

__all__ = [
    "canonicalize_plan",
    "plan_fingerprint",
    "uncachable_reason",
    "PlanCache",
    "QueryCache",
    "ResultCache",
]
