"""Host-RAM columnar cache: the staging tier under the device cache (the
port of trino_tpu/devcache/hostcache.py).

The unit of caching is one split's decoded numpy column set, the output
of ``connector.scan`` and host-applied domain pruning, before dictionary
merge, narrowing and the copy to the device. It is keyed like the device
cache, with the split's own boundary digest as the shard and "host" as
the device, so an eviction from the device cache re-stages from host
memory (concat and copy only) without running the connector again.
Semantics are :class:`DeviceTableCache`'s; only the metric hooks and the
budget differ.
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
