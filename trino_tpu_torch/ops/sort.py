"""Sort kernel: stable multi-key sort with SQL null placement — the port of
trino_tpu/ops/sort.py (ORDER BY and TopN).

Per-key transform to a sortable array (descending = negation for floats,
bitwise NOT for integers; NULLs = a rank-prefix key per nulls_first), then
one stable lexicographic sort (ops/ranks.lex_sort). Dead rows always sort
last so LIMIT sees live rows first.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from trino_tpu_torch.ops import ranks

Lowered = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _sort_key(vals, valid, ascending: bool, nulls_first: Optional[bool]):
    """(null_rank_key, value_key): NULLS LAST for ASC, NULLS FIRST for DESC
    unless specified. Descending integers reverse via bitwise NOT (order-
    reversing over the full dtype range)."""
    if nulls_first is None:
        nulls_first = not ascending
    v = vals
    if v.dtype == torch.bool:
        v = v.to(torch.int8)
    if not ascending:
        v = -v if v.dtype.is_floating_point else ~v
    if valid is None:
        return [v]
    null_rank = valid.to(torch.int8) if nulls_first else (~valid).to(torch.int8)
    return [null_rank, torch.where(valid, v, torch.zeros_like(v))]


def _sort_operands(
    keys: List[Tuple[Lowered, bool, Optional[bool]]],
    sel: Optional[torch.Tensor],
) -> List[torch.Tensor]:
    sort_keys: List[torch.Tensor] = []
    if sel is not None:
        sort_keys.append(~sel)  # dead rows last
    for (vals, valid), asc, nf in keys:
        sort_keys.extend(_sort_key(vals, valid, asc, nf))
    return sort_keys


def sort_payloads(
    keys: List[Tuple[Lowered, bool, Optional[bool]]],
    sel: Optional[torch.Tensor],
    payloads: List[torch.Tensor],
) -> List[torch.Tensor]:
    """Every payload array permuted into sort order (dead rows last)."""
    sort_keys = _sort_operands(keys, sel)
    if not sort_keys:
        return list(payloads)
    _, out = ranks.lex_sort(sort_keys, payloads)
    return out
