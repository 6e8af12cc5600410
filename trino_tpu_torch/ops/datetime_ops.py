"""Civil-calendar math on epoch-day tensors: the port of
trino_tpu/ops/datetime_ops.py for the functions the TPC-H queries reach.

Branch-free integer arithmetic (Howard Hinnant's public-domain days <->
civil algorithms, the math java.time uses). Every division is a floor
division, so days before 1970 land on the right date.
"""
from __future__ import annotations

import torch


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days: torch.Tensor):
    """epoch days -> (year, month, day), elementwise int64 tensors."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524) - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)  # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1  # [1, 31]
    m = mp + torch.where(mp < 10, 3, -9)  # [1, 12]
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> epoch days, elementwise int64."""
    m = m.to(torch.int64)
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400  # [0, 399]
    mp = m + torch.where(m > 2, -3, 9)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def extract_year(days: torch.Tensor) -> torch.Tensor:
    return civil_from_days(days)[0]


def days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    lengths = torch.tensor([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                           dtype=torch.int64, device=m.device)
    base = lengths[(m.to(torch.int64) - 1)]
    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) | \
        (torch.remainder(y, 400) == 0)
    return base + ((m == 2) & leap).to(torch.int64)


def add_months(days: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """date + INTERVAL n MONTH, the day clamped to the end of the month."""
    y, m, d = civil_from_days(days)
    m0 = m - 1 + n.to(torch.int64)
    y2 = y + _fdiv(m0, 12)
    m2 = torch.remainder(m0, 12) + 1
    d2 = torch.minimum(d, days_in_month(y2, m2))
    return days_from_civil(y2, m2, d2)
