"""Group-by kernel, sort/segment based: the port of trino_tpu/ops/groupby.py.

Stable multi-key sort (dead rows last, NULL keys their own group), boundary
detection and dense group ids via cumsum. Payloads ride the same sort
permutation into sorted (layout) space.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from trino_tpu_torch.ops import ranks

Lowered = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (vals, valid|None)


def group_plan(
    keys: List[Lowered], sel: Optional[torch.Tensor], payloads=()
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Permute rows group-contiguous and assign dense group ids.

    Returns (order[n] int32, gid_sorted[n] int32 non-decreasing,
    num_groups scalar, sorted_payloads). Dead rows (sel false) sort last
    and receive group ids >= num_groups."""
    n = keys[0][0].shape[0]
    device = keys[0][0].device
    dead = torch.zeros((n,), dtype=torch.bool, device=device) if sel is None else ~sel
    sort_keys: List[torch.Tensor] = [dead]
    for vals, valid in keys:
        if valid is not None:
            sort_keys.append(~valid)
            sort_keys.append(torch.where(valid, vals, torch.zeros_like(vals)))
        else:
            sort_keys.append(vals)
    iota = ranks._iota32(n, device)
    gathered, out = ranks.lex_sort(sort_keys, [iota, *payloads])
    order = out[0]
    sorted_payloads = out[1:]
    first = torch.ones((1,), dtype=torch.bool, device=device)
    boundary = torch.zeros((n,), dtype=torch.bool, device=device)
    for g in gathered:
        boundary = boundary | torch.cat([first, g[1:] != g[:-1]])
    gid_sorted = torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1
    dead_sorted = gathered[0]
    num_groups = (boundary & ~dead_sorted).sum()
    return order, gid_sorted, num_groups, sorted_payloads


def gather_group_keys(keys: List[Lowered], rep: torch.Tensor) -> List[Lowered]:
    """Group-key output columns: each key gathered at the representative
    row (empty slots carry rep == n, clipped)."""
    n = keys[0][0].shape[0]
    arrays = [vals for vals, _ in keys] + [valid for _, valid in keys if valid is not None]
    gathered = ranks.batched_gather(arrays, rep.long().clamp(0, n - 1))
    out = []
    vi = len(keys)
    for i, (_, valid) in enumerate(keys):
        if valid is None:
            out.append((gathered[i], None))
        else:
            out.append((gathered[i], gathered[vi]))
            vi += 1
    return out
