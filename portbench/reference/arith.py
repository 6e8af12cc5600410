"""Decimal arithmetic of the plain reference: exact scaled integers, or float64.

A decimal value is ``(v, s)``: in the exact mode ``v`` holds integers scaled by
``10**s`` (int64 on the device, Python ints on the host); in the float64 mode
``v`` holds the real value as a double and ``s`` only the scale the SQL type
gives, used when the result is written out. The float64 mode is the benchmark's
control: the same queries with every decimal computed in the nearest precision
below exact, which the comparison has to refuse.

The rules are Trino's: a product's scale is the sum of the scales, a sum's the
larger, ``avg`` keeps its argument's scale, a quotient takes the larger of the
two scales, and ``avg`` and division round half away from zero.
"""
from __future__ import annotations

from decimal import ROUND_HALF_UP, Decimal
from typing import List, Optional

import torch


def half_up_div(n: int, d: int) -> int:
    """round(n / d), halves away from zero, in Python integers."""
    if d < 0:
        n, d = -n, -d
    q = (2 * abs(n) + d) // (2 * d)
    return q if n >= 0 else -q


def half_up_div_t(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Elementwise round(n / d) for int64 tensors with d > 0."""
    q = torch.div(2 * n.abs() + d, 2 * d, rounding_mode="floor")
    return torch.where(n >= 0, q, -q)


class Arith:
    def __init__(self, exact: bool = True):
        self.exact = exact

    # ------------------------------------------------------------- values
    def col(self, t: torch.Tensor, s: int):
        """A stored decimal column (int64 scaled by 10**s)."""
        if self.exact:
            return t.to(torch.int64), s
        return t.to(torch.float64) / (10 ** s), s

    def lit(self, text: str):
        """A decimal literal, as SQL writes it (``0.2``, ``100.00``, ``1``)."""
        d = Decimal(text)
        s = max(0, -d.as_tuple().exponent)
        if self.exact:
            return int(d.scaleb(s)), s
        return float(d), s

    def _align(self, a, b):
        (va, sa), (vb, sb) = a, b
        if not self.exact:
            return va, vb, max(sa, sb)
        s = max(sa, sb)
        return va * 10 ** (s - sa), vb * 10 ** (s - sb), s

    def add(self, a, b):
        va, vb, s = self._align(a, b)
        return va + vb, s

    def sub(self, a, b):
        va, vb, s = self._align(a, b)
        return va - vb, s

    def mul(self, a, b):
        return a[0] * b[0], a[1] + b[1]

    # --------------------------------------------------------- comparison
    def cmp(self, a, b, op: str) -> torch.Tensor:
        va, vb, _ = self._align(a, b)
        return {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
                "=": torch.eq}[op](va, vb)

    # --------------------------------------------------------- aggregates
    def _check_sum(self, exact: torch.Tensor, approx: torch.Tensor) -> None:
        """int64 sums are exact unless they wrapped: hold them against float64."""
        bad = (exact.to(torch.float64) - approx).abs() > 1e-9 * approx.abs() + 1e3
        if bool(bad.any()):
            raise OverflowError("a decimal sum left int64")

    def sum_by(self, a, inv: torch.Tensor, n: int):
        v, s = a
        out = torch.zeros(n, dtype=v.dtype, device=v.device).index_add_(0, inv, v)
        if self.exact:
            approx = torch.zeros(n, dtype=torch.float64, device=v.device).index_add_(
                0, inv, v.to(torch.float64))
            self._check_sum(out, approx)
        return out, s

    def total(self, a):
        """The sum of a column as a host value, None over no rows (SQL's NULL)."""
        v, s = a
        if v.numel() == 0:
            return None, s
        if self.exact:
            out = v.sum()
            self._check_sum(out.reshape(1), v.to(torch.float64).sum().reshape(1))
            return int(out), s
        return float(v.sum()), s

    def host(self, a) -> List:
        v, s = a
        return [(x, s) for x in v.tolist()]

    def avg(self, total, count: int):
        """avg over ``count`` rows of a sum ``total`` (host values)."""
        v, s = total
        if v is None or count == 0:
            return None, s
        if self.exact:
            return half_up_div(v, count), s
        return v / count, s

    def avg_t(self, sums, counts: torch.Tensor):
        """Per-group avg on the device; groups with no rows give 0 (masked by callers)."""
        v, s = sums
        c = counts.clamp(min=1)
        if self.exact:
            return half_up_div_t(v, c.to(torch.int64)), s
        return v / c.to(torch.float64), s

    def div(self, a, b):
        """a / b for host values, NULL where either is NULL."""
        (va, sa), (vb, sb) = a, b
        s = max(sa, sb)
        if va is None or vb is None:
            return None, s
        if self.exact:
            return half_up_div(va * 10 ** (s - sa + sb), vb), s
        return va / vb, s

    # -------------------------------------------------------------- output
    def out(self, a) -> Optional[tuple]:
        """The canonical form of a decimal answer: ("d", unscaled, scale)."""
        v, s = a
        if v is None:
            return None
        if self.exact:
            return ("d", int(v), s)
        q = Decimal(repr(float(v))).quantize(Decimal(1).scaleb(-s), rounding=ROUND_HALF_UP)
        return ("d", int(q.scaleb(s)), s)
