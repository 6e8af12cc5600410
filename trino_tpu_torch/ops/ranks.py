"""Stable multi-key sorts and merge ranks: the port of trino_tpu/ops/ranks.py.

``jax.lax.sort(operands, num_keys=k, is_stable=True)`` sorts k key columns
lexicographically and carries payload operands along in one pass. PyTorch's
``torch.sort`` takes one key, so the multi-key sort here is the plain first
version: a least-significant-first chain of stable ``torch.sort`` calls
that composes one permutation, and payloads are gathered by it once at the
end. (A Hopper radix sort over packed keys is later work.)

Ordering differences from ``lax.sort``: bool keys sort False < True in
both; ``torch.sort`` keeps -0.0 and +0.0 in input order where ``lax.sort``
puts -0.0 first, and both put NaN last. No float sort key is on the ported
query path.

Index outputs keep the reference's int32 contract.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def _iota32(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _sort_key(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.uint8) if v.dtype == torch.bool else v


def lex_perm(sort_keys: List[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation (most significant key first),
    int64 indices: one stable ``torch.sort`` per key, least significant
    first, each on the keys already permuted by the less significant ones."""
    perm = None
    for k in reversed(sort_keys):
        k = _sort_key(k)
        kk = k if perm is None else k[perm]
        step = torch.sort(kk, stable=True).indices
        perm = step if perm is None else perm[step]
    return perm


def lex_sort(sort_keys: List[torch.Tensor], payloads=()) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(sorted keys, permuted payloads): the ``lax.sort`` with payload
    operands, as a composed permutation plus one gather per array."""
    perm = lex_perm(sort_keys)
    return [k[perm] for k in sort_keys], [p[perm] for p in payloads]


def argsort32(vals: torch.Tensor) -> torch.Tensor:
    """Stable argsort returning int32 indices."""
    return torch.sort(_sort_key(vals), stable=True).indices.to(torch.int32)


def lex_argsort32(sort_keys: List[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort (most significant first), int32."""
    return lex_perm(sort_keys).to(torch.int32)


def batched_gather(arrays: List[torch.Tensor], idx: torch.Tensor) -> List[torch.Tensor]:
    """Gather many same-length arrays at the same indices. The reference
    stacks same-dtype columns into one [n, k] row gather because separate
    computed-index gathers do not fuse under XLA; eager PyTorch launches one
    gather per array either way, so this is a plain loop."""
    i = idx.long()
    return [a[i] for a in arrays]


def apply_inverse(perm: torch.Tensor, payloads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each payload re-ordered so slot perm[i] moves to slot i
    (payload[inverse_permutation(perm)]): one scatter per payload through
    the permutation, whose indices are unique."""
    p = perm.long()
    out = []
    for x in payloads:
        y = torch.empty_like(x)
        y[p] = x
        out.append(y)
    return out


def sorted_ranks(
    build_cols_sorted: List[torch.Tensor],
    query_cols: List[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per query row: (left_rank, match_count) against the lex-sorted build.

    ``left_rank`` = number of build tuples strictly less than the query
    (searchsorted side='left'); ``match_count`` = number equal. Both int32,
    in original query order. One combined stable sort with builds first
    (equal keys keep builds before queries), then streaming prefixes."""
    nb = build_cols_sorted[0].shape[0]
    nq = query_cols[0].shape[0]
    n = nb + nq
    device = build_cols_sorted[0].device
    operands = []
    for b, q in zip(build_cols_sorted, query_cols):
        dt = torch.promote_types(b.dtype, q.dtype)
        operands.append(torch.cat([b.to(dt), q.to(dt)]))
    sorted_cols, (idx_s,) = lex_sort(operands, [_iota32(n, device)])
    is_build = (idx_s < nb).to(torch.int32)
    prefix_incl = torch.cumsum(is_build, 0, dtype=torch.int32)
    prefix_excl = prefix_incl - is_build
    neq = torch.zeros((max(n - 1, 0),), dtype=torch.bool, device=device)
    for c in sorted_cols:
        neq = neq | (c[1:] != c[:-1])
    run_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=device), neq])
    # left rank for every slot of a run = build prefix at the run start,
    # propagated by a running max (prefixes are non-decreasing across runs)
    left_at_start = torch.where(run_start, prefix_excl,
                                torch.full_like(prefix_excl, -1))
    left_all = torch.cummax(left_at_start, 0).values
    left_o, right_o = apply_inverse(idx_s, [left_all, prefix_incl])
    lo = left_o[nb:]
    counts = right_o[nb:] - lo
    return lo, counts

