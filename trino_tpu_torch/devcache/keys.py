"""Cache-key construction for the device table cache (the port of
trino_tpu/devcache/keys.py; keys also carry the session's torch device).

A staged artifact is reusable only when EVERYTHING that shaped it
matches: the projection (column subset), the pushdown handle (an
``apply_limit``/``apply_topn``/``apply_aggregation`` handle changes what
the connector returns), the effective scan constraint (static pushdown ∩
available dynamic-filter domains — connectors may prune splits/rows from
it, advisorily but deterministically), and the subset of dynamic domains
the engine physically applied host-side before the transfer (the
compiled tier applies only STRONG domains at staging and enforces weak
ones on device — two executors with the same constraint but different
host-applied sets stage different pages). All of that digests into
``CacheKey.signature``; ``data_version`` and the shard shape ride
alongside. Anything not provably stable — an unversioned connector, an
active transaction overlay, a handle whose repr is identity-based —
yields ``None``: bypass, never guess.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

from trino_tpu_torch.devcache.cache import CacheKey, instance_token

# discrete domains above this digest through their sorted numpy array
# (phase-1 dynamic filters reach millions of keys; repr would be O(n)
# python-object formatting)
_ARRAY_DIGEST_MIN = 64


def cache_enabled(session) -> bool:
    props = getattr(session, "properties", None) or {}
    return bool(props.get("device_cache_enabled", False))


def admit_budget(session) -> int:
    """The session's per-admission byte cap, min-ed with the server-wide
    budget at admit time (mirrors result_cache_max_bytes semantics):
    ``device_cache_max_bytes`` where the session sets it, else a quarter of
    the pool's budget."""
    props = getattr(session, "properties", None) or {}
    v = props.get("device_cache_max_bytes")
    if v is not None:
        return int(v)
    from trino_tpu_torch.devcache.cache import DEVICE_CACHE

    return DEVICE_CACHE.max_bytes // 4


def _update_domain(h, dom) -> None:
    if dom.values is not None:
        h.update(f"set:{len(dom.values)}:{int(dom.null_allowed)}:".encode())
        if len(dom.values) >= _ARRAY_DIGEST_MIN:
            try:
                from trino_tpu_torch.connector.predicate import sorted_values_array

                arr = sorted_values_array(dom)
                h.update(str(arr.dtype).encode())
                h.update(arr.tobytes())
                return
            except Exception:  # noqa: BLE001 — non-numeric set: repr path
                pass
        h.update(repr(sorted(dom.values, key=repr)).encode())
        return
    h.update(repr(("range", dom.low, dom.high, dom.low_inclusive,
                   dom.high_inclusive, dom.null_allowed)).encode())


def _update_tuple_domain(h, constraint) -> None:
    if constraint is None or constraint.is_all():
        h.update(b"|all|")
        return
    for col in sorted(constraint.domains):
        h.update(f"|c:{col}|".encode())
        _update_domain(h, constraint.domains[col])


def _stable_repr(obj) -> Optional[str]:
    """repr(obj) when it is content-based; None when it falls back to the
    identity form (``<... object at 0x...>``) — an unstable key component
    means bypass, not a guess."""
    r = repr(obj)
    if " at 0x" in r or " object at " in r:
        return None
    return r


def scan_signature(node, constraint, applied_domains) -> Optional[str]:
    """Projection/pruning digest for one TableScanNode staging, or None
    when any component has no stable content repr."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(tuple(node.column_names)).encode())
    handle = getattr(node, "table_handle", None)
    if handle is not None:
        r = _stable_repr(handle)
        if r is None:
            return None
        h.update(b"|h:")
        h.update(r.encode())
    _update_tuple_domain(h, constraint)
    for col in sorted(applied_domains or {}):
        h.update(f"|applied:{col}|".encode())
        _update_domain(h, applied_domains[col])
    return h.hexdigest()


def splits_shard(splits: List) -> Optional[str]:
    """Shard component for a worker task's assigned split set (split
    boundaries and any pushdown payload riding ``Split.info``)."""
    h = hashlib.blake2b(digest_size=12)
    for s in splits:
        h.update(repr((s.schema, s.table, s.lo, s.hi)).encode())
        info = getattr(s, "info", None)
        if info is not None:
            r = _stable_repr(info)
            if r is None:
                return None
            h.update(r.encode())
    return f"splits:{len(splits)}:{h.hexdigest()}"


def host_split_keys(session, node, constraint, applied_domains, splits):
    """Host-tier cache keys for a split list's decoded column sets (None
    per bypassed split). Identity = the scan signature (projection +
    handle + constraint + host-APPLIED domain subset — the pruning baked
    into the cached arrays) + each split's own boundary digest as the
    shard, so the same split reached through ANY grouping (whole-table
    staging, a worker's assigned set, any SPMD mesh width) lands on one
    entry. The signature (which digests full dynamic-filter domains —
    megabytes at sf10) and the connector version probe are computed ONCE
    for the whole list; only the cheap per-split shard digest varies. The
    bypass rules (disabled cache, unversioned connector, transaction
    overlay, unstable handle/info repr) are scan_cache_key's, unchanged."""
    import dataclasses as _dc

    base = scan_cache_key(session, node, constraint, applied_domains,
                          shard="host")
    if base is None:
        return [None] * len(splits)
    # decoded host columns do not depend on the session's device
    base = _dc.replace(base, device="host")
    out = []
    for split in splits:
        shard = splits_shard([split])
        out.append(None if shard is None else
                   _dc.replace(base, shard="host:" + shard))
    return out


def cached_stage(session, node, constraint, applied_domains, shard, loader):
    """The one consult-the-pool-or-stage step every staging tier runs:
    build the key, serve from :data:`DEVICE_CACHE` under a
    ``device-cache/lookup`` span, or run ``loader`` directly on bypass.
    ``loader() -> (value, rows, nbytes, splits)``; returns
    ``(CacheEntry, "hit"|"miss"|"bypass")`` — bypass wraps the loaded
    artifact in a transient (never-admitted) entry so callers read one
    shape."""
    import time

    from trino_tpu_torch.devcache.cache import DEVICE_CACHE, CacheEntry
    from trino_tpu_torch.obs import trace as tracing

    key = scan_cache_key(session, node, constraint, applied_domains,
                         shard=shard)
    if key is None:
        value, rows, nbytes, splits = loader()
        now = time.time()
        return CacheEntry(None, value, rows, int(nbytes), splits,
                          created_at=now, last_used_at=now), "bypass"
    with tracing.span("device-cache/lookup", table=node.table) as sp:
        ent, disposition = DEVICE_CACHE.lookup_or_stage(
            key, loader, admit_bytes=admit_budget(session))
        sp.set("result", disposition)
        sp.set("bytes", ent.nbytes)
    return ent, disposition


def cached_build(session, node, constraint, applied_domains, key_channels,
                 key_dtypes: str, loader):
    """Device-cached SORTED BUILD artifact for a join whose build side is a
    bare versioned table scan: the ops/join.py ``SortedBuild`` (sorted key
    columns + row permutation + live flags, all device tensors) keyed by
    the scan's staging signature PLUS the join-key signature (key channels
    and their post-alignment physical dtypes — the probe side's dtype
    participates in alignment, so two probes of different widths need two
    artifacts). A warm repeated join skips the build-side sort entirely.

    Same pool and accounting as staged scans (:data:`DEVICE_CACHE`);
    build hits count under ``DEVICE_CACHE_BUILD_HITS`` (and, like any pool
    hit, the general hit counter). Returns ``(SortedBuild, disposition)``
    — or ``(None, "bypass")`` WITHOUT running ``loader`` when the key is
    not cacheable, so callers can keep the (cheaper) fully-fused path for
    uncacheable builds instead of paying a separate build sort.

    ``loader() -> (SortedBuild, rows, nbytes, splits)``.
    """
    from trino_tpu_torch.devcache.cache import DEVICE_CACHE
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.obs import trace as tracing

    shard = "build:" + ",".join(str(c) for c in key_channels) \
        + ":" + key_dtypes
    key = scan_cache_key(session, node, constraint, applied_domains,
                         shard=shard)
    if key is None:
        return None, "bypass"
    with tracing.span("device-cache/lookup", table=node.table) as sp:
        ent, disposition = DEVICE_CACHE.lookup_or_stage(
            key, loader, admit_bytes=admit_budget(session))
        sp.set("result", disposition)
        sp.set("bytes", ent.nbytes)
        sp.set("artifact", "sorted-build")
    if disposition == "hit":
        M.DEVICE_CACHE_BUILD_HITS.inc()
    return ent.value, disposition


def scan_cache_key(session, node, constraint,
                   applied_domains: Optional[Dict] = None,
                   shard: Optional[str] = "table") -> Optional[CacheKey]:
    """CacheKey for staging this scan under this session, or None when
    the cache must be bypassed (disabled, unversioned connector, active
    transaction, unstable handle/split repr)."""
    if shard is None or not cache_enabled(session):
        return None
    if getattr(session, "transaction", None) is not None:
        # transaction overlays are unversioned by construction (the
        # overlay never defines data_version) — this check just makes the
        # bypass explicit and future-proof
        return None
    conn = (getattr(session, "catalogs", None) or {}).get(node.catalog)
    if conn is None:
        return None
    try:
        version = conn.data_version(node.schema, node.table)
    except Exception:  # noqa: BLE001 — a failing version probe means bypass
        return None
    if version is None:
        return None
    sig = scan_signature(node, constraint, applied_domains or {})
    if sig is None:
        return None
    return CacheKey(node.catalog, node.schema, node.table, str(version),
                    sig, shard, instance_token(conn),
                    str(getattr(session, "device", "")))
