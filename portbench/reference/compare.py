"""Canonical rows and the comparison that decides ``correct``.

The program answers with Python values (``decimal.Decimal``, ``datetime.date``,
ints, strings); the reference with the canonical form directly. A decimal is
compared with its scale, so ``1.50`` and ``1.5`` differ, as the SQL types do.
Rows compare exactly and in order; where a query's ORDER BY leaves rows tied,
the tied rows may come in any order, so the rows are held to the same multiset
and the program's order to the ORDER BY keys.
"""
from __future__ import annotations

import datetime
import decimal
from typing import Dict, List, Optional, Sequence, Tuple

# ORDER BY keys of each query: (column, descending); None where the query
# has no ORDER BY (a single row)
ORDER_BY: Dict[int, Optional[Sequence[Tuple[int, bool]]]] = {
    1: [(0, False), (1, False)], 2: [(0, True), (2, False), (1, False), (3, False)],
    3: [(1, True), (2, False)], 4: [(0, False)], 5: [(1, True)], 6: None,
    7: [(0, False), (1, False), (2, False)], 8: [(0, False)], 9: [(0, False), (1, True)],
    10: [(2, True)], 11: [(1, True)], 12: [(0, False)], 13: [(1, True), (0, True)],
    14: None, 15: [(0, False)], 16: [(3, True), (0, False), (1, False), (2, False)],
    17: None, 18: [(4, True), (3, False)], 19: None, 20: [(0, False)],
    21: [(1, True), (0, False)], 22: [(0, False)],
}


def canonical_value(v):
    if isinstance(v, decimal.Decimal):
        t = v.as_tuple()
        unscaled = int("".join(map(str, t.digits)) or "0")
        return ("d", -unscaled if t.sign else unscaled, -t.exponent)
    if isinstance(v, datetime.date):
        return ("date", v.isoformat())
    if isinstance(v, bool):
        return v
    return v


def canonical(rows) -> List[tuple]:
    return [tuple(canonical_value(v) for v in r) for r in rows]


def _sortable(v):
    if isinstance(v, tuple) and v and v[0] == "d":
        return decimal.Decimal(v[1]).scaleb(-v[2])
    if isinstance(v, tuple) and v and v[0] == "date":
        return v[1]
    return v


def _ordered(rows, order) -> bool:
    for a, b in zip(rows, rows[1:]):
        for c, desc in order:
            x, y = _sortable(a[c]), _sortable(b[c])
            if x == y:
                continue
            if (x < y) == desc:
                return False
            break
    return True


def same_answer(q: int, got: List[tuple], want: List[tuple]) -> bool:
    """The program's canonical rows ``got`` against the reference's ``want``."""
    if got == want:
        return True
    order = ORDER_BY.get(q)
    if order is None or len(got) != len(want):
        return False
    if sorted(map(repr, got)) != sorted(map(repr, want)):
        return False
    return _ordered(got, order)


def first_difference(got: List[tuple], want: List[tuple]) -> str:
    """A short note of where two answers part, for the run's report."""
    if len(got) != len(want):
        return f"{len(got)} rows, reference {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return f"row {i}: {a!r} != reference {b!r}"[:400]
    return "same rows in another order"
