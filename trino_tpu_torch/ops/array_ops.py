"""Array and map kernels over flattened child columns: the port of
trino_tpu/ops/array_ops.py.

A nested column is (int32 lengths[n], flat children), so every per-row
operation is either a gather at ``offset[row] + k`` (subscript,
element_at) or a pass over the flat child followed by a per-row reduction
over the row's [offset, offset + length) range (contains, position, the
array sums, map key lookup). ``rowid_of_flat`` maps a flat position back
to its row, with one searchsorted over the offsets; it is also the core of
the UNNEST expansion.

Every gather clamps its index (torch raises on an out-of-range index where
JAX clamps), and an empty flat child is never indexed.
"""
from __future__ import annotations

from typing import Tuple

import torch


def offsets_from_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """int32[n+1] exclusive prefix sum of per-row element counts."""
    lens = lengths.to(torch.int32)
    return torch.cat([torch.zeros((1,), dtype=torch.int32, device=lens.device),
                      torch.cumsum(lens, 0, dtype=torch.int32)])


def rowid_of_flat(offsets: torch.Tensor, flat_n: int) -> torch.Tensor:
    """int32[flat_n]: the parent row of each flat element position."""
    pos = torch.arange(flat_n, dtype=torch.int32, device=offsets.device)
    return torch.searchsorted(offsets.contiguous(), pos, right=True).to(torch.int32) - 1


def segment_reduce_by_range(offsets: torch.Tensor, flat_vals: torch.Tensor) -> torch.Tensor:
    """Per-row sums of a flat array by cumsum and boundary difference
    (exact for integers, which widen to int64 so narrow dtypes cannot
    wrap)."""
    if not flat_vals.dtype.is_floating_point:
        flat_vals = flat_vals.to(torch.int64)
    c = torch.cumsum(flat_vals, 0, dtype=flat_vals.dtype)
    c0 = torch.cat([torch.zeros((1,), dtype=c.dtype, device=c.device), c])
    return c0[offsets[1:].long()] - c0[offsets[:-1].long()]


def nonempty(t: torch.Tensor) -> torch.Tensor:
    """``t``, or one zero of its dtype when it is empty: a gather source
    that a clamped index can always read."""
    return t if t.shape[0] else torch.zeros((1,), dtype=t.dtype, device=t.device)


def gather_at(offsets: torch.Tensor, lengths: torch.Tensor, flat_vals: torch.Tensor,
              index1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The element at 1-based ``index1`` of each row -> (values, in_bounds).
    A negative index counts from the end."""
    lens = lengths.to(torch.int32)
    i1 = index1.to(torch.int32)
    eff = torch.where(i1 < 0, lens + i1 + 1, i1)
    in_bounds = (eff >= 1) & (eff <= lens)
    flat_n = max(int(flat_vals.shape[0]), 1)
    idx = (offsets[:-1] + eff - 1).clamp(0, flat_n - 1).long()
    return nonempty(flat_vals)[idx], in_bounds


def first_match_index(offsets: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """int32[n]: the 1-based index of the first True of each row's range
    of the flat ``match``, 0 if none: a reverse running minimum of the
    matching positions, read at each row's start."""
    flat_n = int(match.shape[0])
    if flat_n == 0:
        return torch.zeros((offsets.shape[0] - 1,), dtype=torch.int32, device=offsets.device)
    pos = torch.arange(flat_n, dtype=torch.int32, device=match.device)
    cand = torch.where(match, pos, torch.full_like(pos, flat_n))
    suffix_min = torch.flip(torch.cummin(torch.flip(cand, (0,)), 0).values, (0,))
    starts = offsets[:-1]
    first = suffix_min[starts.clamp(0, flat_n - 1).long()]
    lens = offsets[1:] - starts
    hit = (first < offsets[1:]) & (lens > 0)
    return torch.where(hit, first - starts + 1, torch.zeros_like(first))


def count_in_ranges(offsets: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """int32[n]: the count of True flat flags in each row's range."""
    c = torch.cumsum(flags.to(torch.int32), 0, dtype=torch.int32)
    c0 = torch.cat([torch.zeros((1,), dtype=torch.int32, device=c.device), c])
    return c0[offsets[1:].long()] - c0[offsets[:-1].long()]
