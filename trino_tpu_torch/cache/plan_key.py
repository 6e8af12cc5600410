"""Canonical plan keys: deterministic fingerprints of optimized plans (a
copy of trino_tpu/cache/plan_key.py).

Reference role: the cache keys of plan-/result-caching front-ends
(canonical SQL is too weak — ``select 1+1`` and ``SELECT 2`` should
collide, session catalog/schema must distinguish ``orders`` from
``tpch.sf1.orders`` — and too strong — comments and whitespace should
not split entries). Fingerprinting the OPTIMIZED plan tree solves both:
names are resolved, constants folded, and pushed-down handles and
constraints participate in the key.

Plan-node ids are process-global counters (sql/planner/plan.py
``_next_plan_id``), so two plantings of identical SQL produce structurally
identical trees with different ids. Canonicalization maps every id to its
pre-order ordinal before serialization — including the join-node ids that
``TableScanNode.dynamic_filters`` references — so the fingerprint depends
only on plan STRUCTURE.

Connector data versions ride into the fingerprint (``plan_fingerprint``'s
``versions``), which is the whole invalidation story: a table mutation
bumps its version, the next identical query fingerprints differently, and
the stale entry is never consulted again (TTL/LRU reclaims it).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, List, Optional, Sequence, Tuple

from trino_tpu_torch.sql import ir
from trino_tpu_torch.sql.planner import plan as P


def canonicalize_plan(root: P.PlanNode) -> str:
    """Deterministic text form of a plan tree, independent of plan-node
    id allocation. Same SQL planned twice -> same string."""
    ordinal = {}
    for i, node in enumerate(P.walk_plan(root)):
        # a DAG-shaped plan (shared subtree) keeps the FIRST ordinal, so
        # repeated visits serialize consistently
        ordinal.setdefault(node.id, i)
    out: List[str] = []
    _serialize_node(root, ordinal, out)
    return "".join(out)


def _serialize_node(node: P.PlanNode, ordinal: dict, out: List[str]) -> None:
    out.append(f"{type(node).__name__}#{ordinal[node.id]}(")
    for f in dataclasses.fields(node):
        if f.name == "id":
            continue
        v = getattr(node, f.name)
        if f.name == "dynamic_filters" and v:
            # entries are (join_node_id, key_index, column_name): the join
            # id is a raw plan-node id and must canonicalize like the rest
            v = [(ordinal.get(jid, -1), ki, col) for jid, ki, col in v]
        out.append(f"{f.name}=")
        _serialize_value(v, ordinal, out)
        out.append(",")
    out.append(")")


def _serialize_value(v, ordinal: dict, out: List[str]) -> None:
    if isinstance(v, P.PlanNode):
        _serialize_node(v, ordinal, out)
    elif isinstance(v, ir.Expr):
        # ir reprs are deterministic (channel indices + literal values)
        out.append(repr(v))
    elif isinstance(v, (list, tuple)):
        out.append("[")
        for x in v:
            _serialize_value(x, ordinal, out)
            out.append(",")
        out.append("]")
    elif isinstance(v, (str, int, float, bool)) or v is None:
        out.append(repr(v))
    else:
        # types, TupleDomain constraints, pushdown handles, AST fragments
        # (MATCH_RECOGNIZE defines/measures): dataclass reprs, determined
        # by construction, not by identity
        out.append(repr(v))


def plan_fingerprint(
    root: P.PlanNode,
    versions: Optional[Iterable[Tuple[Tuple[str, str, str], str]]] = None,
    extra: Sequence[str] = (),
) -> str:
    """sha256 over the canonical plan + captured connector data versions
    (+ any extra discriminators, e.g. result-affecting session values)."""
    return fingerprint_from_canonical(canonicalize_plan(root), versions,
                                      extra)


def fingerprint_from_canonical(
    canonical: str,
    versions: Optional[Iterable[Tuple[Tuple[str, str, str], str]]] = None,
    extra: Sequence[str] = (),
) -> str:
    """``plan_fingerprint`` over an already-canonicalized plan string.
    The prepared-EXECUTE hot path canonicalizes its parameterized plan
    ONCE (the bindings ride in ``extra``) instead of re-serializing the
    bound plan on every request."""
    h = hashlib.sha256()
    h.update(canonical.encode())
    for (catalog, schema, table), version in sorted(versions or ()):
        h.update(f"|{catalog}.{schema}.{table}@{version}".encode())
    for x in extra:
        h.update(f"|{x}".encode())
    return h.hexdigest()


def scanned_tables(root: P.PlanNode) -> List[Tuple[str, str, str]]:
    """Distinct (catalog, schema, table) identities the plan scans."""
    seen = []
    for node in P.walk_plan(root):
        if isinstance(node, P.TableScanNode):
            key = (node.catalog, node.schema, node.table)
            if key not in seen:
                seen.append(key)
    return seen


def capture_versions(session, root: P.PlanNode):
    """Current connector data version per scanned table, or None when any
    scanned table is unversioned (its connector returned None) — an
    unversioned table cannot be invalidated, so its queries must bypass."""
    versions = []
    for catalog, schema, table in scanned_tables(root):
        conn = session.catalogs.get(catalog)
        v = conn.data_version(schema, table) if conn is not None else None
        if v is None:
            return None
        versions.append(((catalog, schema, table), str(v)))
    return versions
