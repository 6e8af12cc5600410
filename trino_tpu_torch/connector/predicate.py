"""Connector predicate model: Domain / TupleDomain.

Reference: ``core/trino-spi/.../spi/predicate/`` — ``TupleDomain.java``
(column→Domain map), ``Domain.java`` (ValueSet + null-allowed), ``Range``.
Simplified to the shapes the engine produces today: one contiguous range
(optionally unbounded on either side) OR a discrete in-set, per column.
Constraints are ADVISORY to connectors: the engine always keeps the
enforcing filter (the reference drops it only when the connector promises
full enforcement via applyFilter's result), so a connector that ignores or
over-approximates a constraint is still correct — pushdown only reduces
rows materialized.

Values are storage representations (ints for bigint/date-as-epoch-days/
scaled decimals, floats, Python str for varchar).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Optional


@dataclasses.dataclass(frozen=True)
class Domain:
    """Allowed values of one column: either ``values`` (discrete set) or a
    [low, high] range with optional open bounds; plus NULL admissibility."""

    low: Optional[object] = None  # None = unbounded below
    high: Optional[object] = None  # None = unbounded above
    low_inclusive: bool = True
    high_inclusive: bool = True
    values: Optional[FrozenSet] = None  # discrete set; overrides range
    null_allowed: bool = False
    # lazily-cached sorted numpy array of ``values`` (phase-1 dynamic
    # filters reach millions of keys; per-use frozenset iteration is the
    # cost that matters, not storage). Excluded from equality/repr.
    values_sorted: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)

    @staticmethod
    def all() -> "Domain":
        return Domain(null_allowed=True)

    @staticmethod
    def from_values(vals, null_allowed: bool = False) -> "Domain":
        import numpy as np

        arr = None
        if isinstance(vals, np.ndarray):
            arr = np.sort(vals)
            vals = arr.tolist()
        return Domain(values=frozenset(vals), null_allowed=null_allowed,
                      values_sorted=arr)

    @staticmethod
    def range(low=None, high=None, low_inclusive=True, high_inclusive=True) -> "Domain":
        return Domain(low, high, low_inclusive, high_inclusive)

    @staticmethod
    def only_null() -> "Domain":
        return Domain(values=frozenset(), null_allowed=True)

    def is_all(self) -> bool:
        return self.values is None and self.low is None and self.high is None and self.null_allowed

    def is_none(self) -> bool:
        """Provably empty (no value and no NULL admitted)."""
        if self.null_allowed:
            return False
        if self.values is not None:
            return len(self.values) == 0
        if self.low is not None and self.high is not None:
            if self.low > self.high:
                return True
            if self.low == self.high and not (self.low_inclusive and self.high_inclusive):
                return True
        return False

    def value_bounds(self):
        """(low, high) closed bounds, or None on that side if unbounded.
        In-set domains report their min/max."""
        if self.values is not None:
            if not self.values:
                return None, None
            return min(self.values), max(self.values)
        return self.low, self.high

    def contains(self, v) -> bool:
        if v is None:
            return self.null_allowed
        if self.values is not None:
            return v in self.values
        if self.low is not None and (v < self.low or (v == self.low and not self.low_inclusive)):
            return False
        if self.high is not None and (v > self.high or (v == self.high and not self.high_inclusive)):
            return False
        return True

    def intersect(self, other: "Domain") -> "Domain":
        null_ok = self.null_allowed and other.null_allowed
        if self.values is not None or other.values is not None:
            if self.values is not None and other.values is not None:
                vals = self.values & other.values
            elif self.values is not None:
                vals = frozenset(v for v in self.values if other.contains(v))
            else:
                vals = frozenset(v for v in other.values if self.contains(v))
            return Domain(values=vals, null_allowed=null_ok)
        low, low_inc = self.low, self.low_inclusive
        if other.low is not None and (low is None or other.low > low
                                      or (other.low == low and not other.low_inclusive)):
            low, low_inc = other.low, other.low_inclusive
        high, high_inc = self.high, self.high_inclusive
        if other.high is not None and (high is None or other.high < high
                                       or (other.high == high and not other.high_inclusive)):
            high, high_inc = other.high, other.high_inclusive
        return Domain(low, high, low_inc, high_inc, None, null_ok)


def sorted_values_array(dom: Domain):
    """Sorted numpy array of an in-set Domain's values, cached on the
    instance (frozen dataclass: installed via object.__setattr__)."""
    import numpy as np

    if dom.values_sorted is not None:
        return dom.values_sorted
    if not dom.values:
        arr = np.empty(0, dtype=np.int64)
    else:
        # dtype-aware: an int64 fromiter would silently truncate float
        # domain values (double join keys) and drop every matching row
        dt = np.int64 if all(
            isinstance(v, (int, np.integer)) for v in dom.values) else np.float64
        arr = np.sort(np.fromiter(dom.values, dtype=dt, count=len(dom.values)))
    object.__setattr__(dom, "values_sorted", arr)
    return arr


@dataclasses.dataclass(frozen=True)
class TupleDomain:
    """Conjunction of per-column Domains (absent column = unconstrained)."""

    domains: Dict[str, Domain] = dataclasses.field(default_factory=dict)

    @staticmethod
    def all() -> "TupleDomain":
        return TupleDomain({})

    def is_all(self) -> bool:
        return not self.domains

    def is_none(self) -> bool:
        return any(d.is_none() for d in self.domains.values())

    def domain(self, column: str) -> Domain:
        return self.domains.get(column, Domain.all())

    def intersect(self, other: Optional["TupleDomain"]) -> "TupleDomain":
        if other is None:
            return self
        merged = dict(self.domains)
        for col, dom in other.domains.items():
            merged[col] = merged[col].intersect(dom) if col in merged else dom
        return TupleDomain(merged)

    def __repr__(self):
        if not self.domains:
            return "TupleDomain.all()"
        parts = []
        for col, d in sorted(self.domains.items()):
            if d.values is not None:
                vs = sorted(d.values)
                shown = vs if len(vs) <= 4 else vs[:4] + ["…"]
                parts.append(f"{col} IN {shown}")
            else:
                lo = "-inf" if d.low is None else repr(d.low)
                hi = "+inf" if d.high is None else repr(d.high)
                lb = "[" if d.low_inclusive else "("
                rb = "]" if d.high_inclusive else ")"
                parts.append(f"{col} {lb}{lo}, {hi}{rb}")
        return "TupleDomain(" + ", ".join(parts) + ")"
