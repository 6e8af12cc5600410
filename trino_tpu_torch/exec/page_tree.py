"""Page <-> flat tensor-list conversion for the compiled tier: the port of
trino_tpu/exec/page_tree.py.

The dynamic parts of a Page (values, null masks, high limbs, the selection,
nested child columns) flatten to a list of tensors; the static parts (types,
dictionaries, vranges) go into a PageSpec. Nested (array/map/row) columns
flatten recursively: the parent's lengths first, then each child column.
The flat list of the staged scan pages is a captured CUDA graph's static
input set, and the flat list of the output page its output set
(exec/compiled.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.dictionary import Dictionary
from trino_tpu_torch.data.page import Column, Page


@dataclasses.dataclass
class ColSpec:
    """Static description of one column's flat layout."""

    type: T.Type
    dictionary: Optional[Dictionary]
    has_nulls: bool
    vrange: Optional[tuple] = None
    ascending: bool = False
    has_hi: bool = False
    children: Optional[List["ColSpec"]] = None

    def count(self) -> int:
        return (1 + (1 if self.has_nulls else 0) + (1 if self.has_hi else 0)
                + sum(k.count() for k in (self.children or ())))


@dataclasses.dataclass
class PageSpec:
    col_specs: List[ColSpec]
    has_sel: bool
    live_prefix: bool = False

    def array_count(self) -> int:
        """How many flat tensors a page with this spec occupies."""
        return sum(c.count() for c in self.col_specs) + (1 if self.has_sel else 0)


def _flatten_col(c: Column, arrays: List[torch.Tensor]) -> ColSpec:
    arrays.append(c.values)
    if c.nulls is not None:
        arrays.append(c.nulls)
    if c.hi is not None:
        arrays.append(c.hi)
    children = None
    if c.children is not None:
        children = [_flatten_col(k, arrays) for k in c.children]
    return ColSpec(c.type, c.dictionary, c.nulls is not None, c.vrange,
                   bool(c.ascending), c.hi is not None, children)


def _unflatten_col(spec: ColSpec, arrays: List[torch.Tensor], i: int
                   ) -> Tuple[Column, int]:
    vals = arrays[i]
    i += 1
    nulls = None
    if spec.has_nulls:
        nulls = arrays[i]
        i += 1
    hi = None
    if spec.has_hi:
        hi = arrays[i]
        i += 1
    children = None
    if spec.children is not None:
        children = []
        for ks in spec.children:
            k, i = _unflatten_col(ks, arrays, i)
            children.append(k)
    return Column(spec.type, vals, nulls, spec.dictionary, spec.vrange,
                  spec.ascending, hi=hi, children=children), i


def flatten_page(page: Page) -> Tuple[List[torch.Tensor], PageSpec]:
    arrays: List[torch.Tensor] = []
    col_specs = [_flatten_col(c, arrays) for c in page.columns]
    if page.sel is not None:
        arrays.append(page.sel)
    return arrays, PageSpec(col_specs, page.sel is not None, page.live_prefix)


def unflatten_page(spec: PageSpec, arrays: List[torch.Tensor]) -> Page:
    cols: List[Column] = []
    i = 0
    for cs in spec.col_specs:
        c, i = _unflatten_col(cs, arrays, i)
        cols.append(c)
    sel = arrays[i] if spec.has_sel else None
    return Page(cols, sel, live_prefix=spec.live_prefix)
