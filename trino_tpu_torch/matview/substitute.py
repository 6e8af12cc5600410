"""Transparent materialized-view substitution: the optimizer's MV pass (a
copy of trino_tpu/matview/substitute.py).

Reference: the reference planner's ``getMaterializedView`` flow — when a
query references a fresh materialized view, the plan reads the storage
table instead of the view query. This engine goes further (there is no
view *name* required): the pass matches a query's **optimized plan
subtree** against every registered MV definition by canonical plan
fingerprint (``cache/plan_key.canonicalize_plan`` — the exact machinery
the result cache keys on), so a repeated q3-shaped join+aggregate turns
into a table scan of the precomputed storage table whether or not the
user ever mentions the view. The scan then lands on the device-cache
tiers: a fresh hit is a warm scan from device memory instead of a
sort-merge join.

Correctness contract:

- substitution happens ONLY when the view is **fresh**: every base-table
  ``data_version`` captured when the REFRESH planned still matches the
  connector's current token, the storage table still exists, and its own
  version still matches the one recorded at the swap. Anything else —
  including a never-refreshed view, a mid-refresh mutation, or an
  out-of-band storage edit — falls back to the base plan. Stale never
  means wrong rows; it means the join runs.
- per-user access control re-fires: the substituting principal must be
  allowed to SELECT every base table of the definition (a storage scan
  must not launder table grants through the view).
- sessions inside an explicit transaction never substitute (their reads
  go through copy-on-write overlay connectors whose versions are not the
  registry's vocabulary).
- the rewritten tree is COPY-ON-WRITE: plans can be shared with the
  logical-plan cache, so ancestors of a substituted subtree are shallow-
  copied and the cached tree is never mutated.

The caller threads the returned substitutions into the result-cache key:
the captured versions of a substituted plan are the STORAGE version plus
the view's recorded BASE versions, so both a REFRESH and a base-table
DML invalidate cached results naturally.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.matview.registry import MaterializedView
from trino_tpu_torch.sql.planner import plan as P


def substitution_enabled(session) -> bool:
    v = (getattr(session, "properties", None) or {}).get(
        "materialized_view_substitution", True)
    return str(v).lower() not in ("false", "0", "no")


def staleness_reason(catalogs, mv: MaterializedView) -> Optional[str]:
    """None when the view is fresh (substitutable); else a human-readable
    reason. Shared by the substitution pass, EXPLAIN annotations, and
    ``system.metadata.materialized_views``."""
    if mv.base_versions is None:
        return "never refreshed"
    for (c, s, t), v in mv.base_versions:
        conn = catalogs.get(c)
        try:
            cur = conn.data_version(s, t) if conn is not None else None
        except Exception:  # noqa: BLE001 — unreadable == stale
            cur = None
        if cur is None or str(cur) != v:
            return f"base table {c}.{s}.{t} moved ({v} -> {cur})"
    sconn = catalogs.get(mv.storage_catalog)
    try:
        meta = (sconn.get_table(mv.storage_schema, mv.storage_table)
                if sconn is not None else None)
    except Exception:  # noqa: BLE001 — unreadable == stale, never fail
        meta = None
    if meta is None:
        return f"storage table {mv.storage_qualified} missing"
    try:
        cur = sconn.data_version(mv.storage_schema, mv.storage_table)
    except Exception:  # noqa: BLE001 — unreadable == stale, never fail
        cur = None
    if cur is None or str(cur) != mv.storage_version:
        return (f"storage version moved "
                f"({mv.storage_version} -> {cur})")
    return None


def _access_denied_reason(session, mv: MaterializedView) -> Optional[str]:
    """Re-fire plan-time access control on the defining query's base
    tables for the CURRENT principal (the reference's view-security
    check): a denied base table suppresses substitution."""
    ac = getattr(session, "access_control", None)
    if ac is None:
        return None
    identity = getattr(session, "identity", None)
    for c, s, t in mv.base_tables:
        try:
            ac.check_can_select(identity, c, s, t)
        except PermissionError:
            return f"access denied on base table {c}.{s}.{t}"
    return None


def _scan_table_sets(root: P.PlanNode) -> Dict[int, frozenset]:
    """node id -> frozenset of (catalog, schema, table) the subtree
    scans — the cheap prefilter before canonicalizing a subtree."""
    out: Dict[int, frozenset] = {}

    def walk(node: P.PlanNode) -> frozenset:
        if isinstance(node, P.TableScanNode):
            s = frozenset({(node.catalog, node.schema, node.table)})
        else:
            s = frozenset()
            for child in node.sources:
                s = s | walk(child)
        out[node.id] = s
        return s

    walk(root)
    return out


def _set_sources(node: P.PlanNode, sources: List[P.PlanNode]) -> None:
    if isinstance(node, (P.JoinNode, P.SetOpNode)):
        node.left, node.right = sources
    elif isinstance(node, P.UnionNode):
        node.sources_ = list(sources)
    elif sources:
        node.source = sources[0]


def _storage_scan(mv: MaterializedView, subtree: P.PlanNode,
                  width: Optional[int]) -> P.TableScanNode:
    """The replacement scan over the MV storage table: full width for an
    exact match, the leading ``width`` columns for a prefix match. Types
    come from the MATCHED subtree so the channel contract (and the plan
    sanity checker) hold exactly."""
    k = width if width is not None else len(mv.column_names)
    return P.TableScanNode(
        catalog=mv.storage_catalog, schema=mv.storage_schema,
        table=mv.storage_table,
        column_names=list(mv.column_names[:k]),
        column_types=list(subtree.output_types),
        mv_name=mv.qualified,
    )


def substitute_plan(session, root: P.PlanNode
                    ) -> Tuple[P.PlanNode, List[dict]]:
    """Match ``root``'s subtrees against the session's registered MVs and
    rewrite fresh matches into storage-table scans. Returns
    ``(new_root, substitution notes)`` — ``new_root`` is ``root`` itself
    when nothing substituted (the input tree is never mutated). Notes:
    ``{"view", "result": "substituted"|"stale"|"access-denied",
    "reason", "prefix"}`` — one per decided match, for EXPLAIN headers,
    queryStats.mvHits, and the substitution metric."""
    registry = getattr(session, "matviews", None)
    if registry is None or registry.empty():
        return root, []
    if not substitution_enabled(session):
        return root, []
    if getattr(session, "transaction", None) is not None:
        return root, []
    # candidate table: canonical -> (mv, prefix width or None). Views
    # without a completed REFRESH have nothing to substitute.
    candidates: Dict[str, tuple] = {}
    base_sets: List[frozenset] = []
    for mv in registry.snapshot():
        if mv.base_versions is None or not mv.canonical:
            continue
        candidates[mv.canonical] = (mv, None)
        for canon, k in mv.prefix_canonicals.items():
            candidates.setdefault(canon, (mv, k))
        base_sets.append(frozenset(tuple(t) for t in mv.base_tables))
    if not candidates:
        return root, []

    from trino_tpu_torch.cache.plan_key import canonicalize_plan
    from trino_tpu_torch.obs import metrics as M
    from trino_tpu_torch.obs import trace as tracing

    tables_of = _scan_table_sets(root)
    notes: List[dict] = []
    mv_by_name: Dict[str, MaterializedView] = {}
    decided: set = set()  # view names already decided stale/denied
    # the freshness verdict is memoized per view for the duration of the
    # pass: a plan with N subtrees matching one view pays the live
    # data_version probes once, and the verdict stays consistent across
    # all N decisions even if a REFRESH lands mid-pass
    freshness: Dict[str, Optional[str]] = {}

    def _reason(mv: MaterializedView) -> Optional[str]:
        if mv.qualified not in freshness:
            freshness[mv.qualified] = (
                staleness_reason(session.catalogs, mv)
                or _access_denied_reason(session, mv))
        return freshness[mv.qualified]

    def try_match(node: P.PlanNode) -> Optional[P.TableScanNode]:
        if isinstance(node, (P.OutputNode, P.ValuesNode)):
            return None
        if not any(tables_of[node.id] == s for s in base_sets):
            return None
        hit = candidates.get(canonicalize_plan(node))
        if hit is None:
            return None
        mv, width = hit
        mv_by_name[mv.qualified] = mv
        reason = _reason(mv)
        if reason is not None:
            if mv.qualified not in decided:
                decided.add(mv.qualified)
                result = ("access-denied" if reason.startswith("access")
                          else "stale")
                notes.append({"view": mv.qualified, "result": result,
                              "reason": reason, "prefix": width})
            return None
        notes.append({"view": mv.qualified, "result": "substituted",
                      "reason": None, "prefix": width})
        return _storage_scan(mv, node, width)

    def rewrite(node: P.PlanNode) -> P.PlanNode:
        scan = try_match(node)
        if scan is not None:
            return scan
        srcs = list(node.sources)
        new_srcs = [rewrite(s) for s in srcs]
        if all(n is s for n, s in zip(new_srcs, srcs)):
            return node
        # copy-on-write: the input tree may be shared with the plan
        # cache — ancestors of a substitution are shallow-copied,
        # untouched sibling subtrees are shared into the new tree
        clone = copy.copy(node)
        _set_sources(clone, new_srcs)
        return clone

    with tracing.timed("plan/mv-substitute", M.PLAN_SECONDS) as sp:
        new_root = rewrite(root)
        if new_root is not root:
            # the rewrite must uphold every plan invariant (arity/
            # channel/type): a bad substitution falls back to the base
            # plan, never fails the query or corrupts rows
            try:
                from trino_tpu_torch.sql.planner.sanity import validate_plan

                validate_plan(new_root, phase="mv-substitute")
            except Exception:  # noqa: BLE001 — containment: base plan
                for n in notes:
                    if n["result"] == "substituted":
                        n["result"] = "invalid"
                        n["reason"] = "substituted plan failed validation"
                new_root = root
        # metrics + hit counters AFTER the validation verdict, so a
        # contained invalid rewrite never counts as 'substituted'
        for n in notes:
            M.MV_SUBSTITUTIONS.inc(1, n["result"])
            if n["result"] == "substituted":
                mv = mv_by_name[n["view"]]
                registry.record_hit(mv.catalog, mv.schema, mv.name)
        substituted = [n for n in notes if n["result"] == "substituted"]
        sp.set("candidates", len(candidates))
        sp.set("substituted", len(substituted))
        if notes:
            sp.set("views", ",".join(sorted({n["view"] for n in notes})))
            sp.set("results", ",".join(n["result"] for n in notes))
    return new_root, notes


def substitution_versions(session, root: P.PlanNode,
                          notes: List[dict]) -> Optional[list]:
    """The captured data versions of a substituted plan for result-cache
    keying: the plan's own scanned versions (storage + any unsubstituted
    scans) UNION every substituted view's recorded base versions — so a
    REFRESH (storage version moves) and a base-table DML (base version
    moves) both invalidate cached results. None when any component is
    unversioned (the cache then bypasses)."""
    from trino_tpu_torch.cache.plan_key import capture_versions

    versions = capture_versions(session, root)
    if versions is None:
        return None
    merged = dict(versions)
    registry = getattr(session, "matviews", None)
    if registry is None:
        return list(versions)
    seen = {n["view"] for n in notes if n["result"] == "substituted"}
    for mv in registry.snapshot():
        if mv.qualified in seen and mv.base_versions is not None:
            for key, v in mv.base_versions:
                merged.setdefault(tuple(key), v)
    return sorted(merged.items())
