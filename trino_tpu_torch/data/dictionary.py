"""Host-side string dictionaries backing varchar columns.

Reference: Trino's ``DictionaryBlock`` (``core/trino-spi/.../spi/block/
DictionaryBlock.java``) — there, an optimization; here, the *primary*
representation of strings: the device holds int32 codes, the host holds the
code -> UTF-8 mapping. Device-side string work (grouping, equality, ordering)
happens on codes; code order is made to match string order by sorting the
vocabulary at build time, so ORDER BY / min / max on varchar reduce to integer
ops on codes (SURVEY.md §7.1 "dictionary-first").
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

NULL_CODE = -1  # code used in the values array where the row is NULL


class Dictionary:
    """An ordered vocabulary: code i is the i-th smallest string.

    Invariant: ``values`` is sorted ascending (bytewise UTF-8, which matches
    Trino's collation-free varchar ordering), so ``code_a < code_b`` iff
    ``str_a < str_b``. This keeps ORDER BY and range predicates on varchar as
    pure integer comparisons on device.
    """

    __slots__ = ("values", "_index")

    def __init__(self, sorted_values: Sequence[str]):
        self.values: List[str] = list(sorted_values)
        self._index = {v: i for i, v in enumerate(self.values)}

    @classmethod
    def build(cls, strings: Iterable[Optional[str]]) -> "Dictionary":
        uniq = sorted({s for s in strings if s is not None})
        return cls(uniq)

    def __len__(self) -> int:
        return len(self.values)

    def encode(self, strings: Sequence[Optional[str]]) -> np.ndarray:
        out = np.empty(len(strings), dtype=np.int32)
        idx = self._index
        for i, s in enumerate(strings):
            out[i] = NULL_CODE if s is None else idx[s]
        return out

    def code_of(self, s: str) -> int:
        """Code for a literal, or -1 if absent (comparison will be all-false)."""
        return self._index.get(s, NULL_CODE)

    def lower_bound(self, s: str) -> int:
        """First code whose string >= s (for range predicates on varchar)."""
        import bisect

        return bisect.bisect_left(self.values, s)

    def decode(self, codes: np.ndarray) -> List[Optional[str]]:
        vals = self.values
        return [None if c == NULL_CODE else vals[int(c)] for c in codes]

    def decode_one(self, code: int) -> Optional[str]:
        return None if code == NULL_CODE else self.values[code]

    def merge(self, other: "Dictionary") -> "Dictionary":
        return Dictionary(sorted(set(self.values) | set(other.values)))

    def recode_table(self, target: "Dictionary") -> np.ndarray:
        """int32 mapping old code -> code in ``target`` (for cross-table ops)."""
        return np.array([target.code_of(v) for v in self.values], dtype=np.int32)
