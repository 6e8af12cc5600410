"""TPC-H tables for the plain reference, regenerated from the frozen generator.

A table is generated in row ranges on a few host threads (numpy releases the
interpreter lock in its array passes), one pass per set of columns, and each
column is moved to the device once and kept for the queries that follow. A
varchar column is an int32 tensor of codes into a sorted list of strings, so
the order of its codes is the order of its strings. Nothing here imports the
program under test.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from portbench.reference import generator as G

# generation ranges: orders and lineitem by order index, the rest by row
_BY_ORDER = ("orders", "lineitem")
_MIN_CHUNK = 1 << 16


def generation_rows(table: str, sf: float) -> int:
    return G.table_row_count("orders" if table in _BY_ORDER else table, sf)


def _merge_varchar(parts: List[Tuple[np.ndarray, List[str]]]) -> Tuple[np.ndarray, List[str]]:
    """Codes into chunk dictionaries -> codes into their sorted union."""
    vocabs = [v for _, v in parts]
    if all(v == vocabs[0] for v in vocabs[1:]):
        return np.concatenate([c for c, _ in parts]).astype(np.int32), vocabs[0]
    union = sorted(set().union(*vocabs))
    arr = np.asarray(union)
    codes = [np.searchsorted(arr, np.asarray(v))[c] for c, v in parts]
    return np.concatenate(codes).astype(np.int32), union


class Tables:
    """Columns of TPC-H at scale factor ``sf`` on ``device``, made on demand."""

    def __init__(self, sf: float, device, threads: int = 8):
        self.sf = sf
        self.device = torch.device(device)
        self.threads = threads
        self._cols: Dict[Tuple[str, str], torch.Tensor] = {}
        self._vocab: Dict[Tuple[str, str], List[str]] = {}

    def load(self, table: str, columns: Iterable[str]) -> None:
        missing = [c for c in columns if (table, c) not in self._cols]
        if not missing:
            return
        n = generation_rows(table, self.sf)
        k = max(1, min(self.threads * 2, n // _MIN_CHUNK))
        bounds = np.linspace(0, n, k + 1).astype(np.int64)
        ranges = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]

        def gen(r):
            return G.generate(table, self.sf, r[0], r[1], missing)

        if len(ranges) == 1:
            chunks = [gen(ranges[0])]
        else:
            with ThreadPoolExecutor(min(self.threads, len(ranges))) as pool:
                chunks = list(pool.map(gen, ranges))
        for c in missing:
            parts = [ch[c] for ch in chunks]
            if parts[0].dictionary is not None:
                values, vocab = _merge_varchar([(p.values, p.dictionary.values) for p in parts])
                self._vocab[(table, c)] = vocab
            else:
                values = np.concatenate([p.values for p in parts])
            if values.dtype == np.int32:
                t = torch.from_numpy(values)
            else:
                t = torch.from_numpy(values.astype(np.int64, copy=False))
            self._cols[(table, c)] = t.to(self.device)
            del values
        del chunks

    def col(self, table: str, column: str) -> torch.Tensor:
        self.load(table, [column])
        return self._cols[(table, column)]

    def vocab(self, table: str, column: str) -> List[str]:
        self.load(table, [column])
        return self._vocab[(table, column)]

    def rows(self, table: str) -> int:
        first = G.SCHEMAS[table][0][0]
        return int(self.col(table, first).shape[0])
