"""Device-resident table cache and the host-RAM tier under it (the port of
trino_tpu/devcache/).

Public surface: the process-wide :data:`DEVICE_CACHE` pool, the
:data:`HOST_CACHE` tier of decoded split columns under it (same key,
flight and invalidation semantics), and the key constructors the scan
(exec/executor.py) and the staging plane (exec/staging.py) consult.
"""
from trino_tpu_torch.devcache.cache import (
    DEVICE_CACHE, CacheEntry, CacheKey, DeviceTableCache, device_memory_bytes,
    instance_token)
from trino_tpu_torch.devcache.hostcache import (
    HOST_CACHE, HostColumnCache, column_data_bytes, host_admit_budget,
    shed_revocable, split_data_bytes)
from trino_tpu_torch.devcache.keys import (
    admit_budget, cache_enabled, cached_build, cached_stage, host_split_keys,
    scan_cache_key, scan_signature, splits_shard)

__all__ = [
    "DEVICE_CACHE", "CacheEntry", "CacheKey", "DeviceTableCache",
    "HOST_CACHE", "HostColumnCache", "admit_budget", "cache_enabled",
    "cached_build", "cached_stage", "column_data_bytes", "device_memory_bytes",
    "host_admit_budget", "host_split_keys", "instance_token",
    "scan_cache_key", "scan_signature", "shed_revocable", "split_data_bytes",
    "splits_shard",
]
