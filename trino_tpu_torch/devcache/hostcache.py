"""Host-RAM columnar cache: the staging tier under the device cache (the
port of trino_tpu/devcache/hostcache.py).

The unit of caching is one split's decoded numpy column set, the output
of ``connector.scan`` and host-applied domain pruning, before dictionary
merge, narrowing and the copy to the device. It is keyed like the device
cache, with the split's own boundary digest as the shard and "host" as
the device, so an eviction from the device cache re-stages from host
memory (concat and copy only) without running the connector again.
Semantics are :class:`DeviceTableCache`'s; only the metric hooks, the
ledger pool and owner, and the budget differ.

``shed_revocable`` is the node's host-RAM pressure shed across both
revocable tiers, this one first.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from trino_tpu_torch.devcache.cache import DeviceTableCache
from trino_tpu_torch.obs import metrics as M

# process-wide budget
DEFAULT_HOST_CACHE_BYTES = 1 << 30


def column_data_bytes(cd) -> int:
    """Host bytes of one decoded ColumnData (arrays exact, dictionary
    vocabulary estimated): the host cache's accounting unit."""
    n = int(np.asarray(cd.values).nbytes)
    if cd.nulls is not None:
        n += int(np.asarray(cd.nulls).nbytes)
    if getattr(cd, "hi", None) is not None:
        n += int(np.asarray(cd.hi).nbytes)
    d = getattr(cd, "dictionary", None)
    if d is not None:
        n += sum(len(v) + 8 for v in d.values)
    for k in getattr(cd, "children", None) or ():
        n += column_data_bytes(k)
    return n


def split_data_bytes(data: dict) -> int:
    """Host bytes of one split's decoded column set."""
    return sum(column_data_bytes(cd) for cd in data.values())


class HostColumnCache(DeviceTableCache):
    """The host-RAM tier: same machinery, host metrics, host budget. Entry
    values are ``{column name: ColumnData}`` dicts of numpy arrays, which
    consumers treat as immutable (assembly concatenates and narrows into
    fresh arrays)."""

    M_HITS = M.HOST_CACHE_HITS
    M_MISSES = M.HOST_CACHE_MISSES
    M_EVICTIONS = M.HOST_CACHE_EVICTIONS
    M_BYTES = M.HOST_CACHE_BYTES

    # this tier's pages are host RAM: its ledger events land in the host pool
    LEDGER_POOL = "host"
    LEDGER_OWNER = "host-cache"

    def _default_max_bytes(self) -> int:
        return DEFAULT_HOST_CACHE_BYTES


# the process-wide host tier
HOST_CACHE = HostColumnCache()


def host_admit_budget(session) -> Optional[int]:
    """Per-entry admission cap from the ``host_cache_max_bytes`` session
    property (min-ed with the process budget at admission)."""
    props = getattr(session, "properties", None) or {}
    v = props.get("host_cache_max_bytes")
    return int(v) if v is not None else None


def shed_revocable(nbytes: int) -> int:
    """Host-RAM pressure shed across both revocable tiers, host tier first:
    a host page costs one copy to rebuild, a warm device page the whole
    scan, decode and copy once the host tier is gone too. The worker calls
    it when its RSS crosses ``TRINO_TPU_HOST_MEMORY_LIMIT_BYTES``. A caller
    that needs device bytes back (the pool overflow, the spill decision)
    calls ``DEVICE_CACHE.yield_bytes`` instead: freeing host RAM cannot
    satisfy a device reservation."""
    from trino_tpu_torch.devcache.cache import DEVICE_CACHE

    if nbytes <= 0:
        return 0
    freed = HOST_CACHE.yield_bytes(nbytes, reason="host-pressure")
    if freed < nbytes and _device_memory_host_backed():
        # the device tier relieves RSS only where its tensors live in host
        # RAM; on the card they hold device memory, and evicting them
        # under host pressure would thrash the warm tier for nothing. Each
        # tier's yield is its own shed event, so the ledger shows the order
        freed += DEVICE_CACHE.yield_bytes(nbytes - freed, reason="rss-escalation")
    return freed


def _device_memory_host_backed() -> bool:
    """True when this process has no CUDA device, so the device cache's
    tensors are host RAM (a ``device="cpu"`` cache); a CUDA cache is not
    host-backed."""
    from trino_tpu_torch.devcache.cache import device_memory_bytes

    return device_memory_bytes() is None
