"""Page/Column over torch tensors: the port of trino_tpu/data/page.py.

A Column is a struct-of-arrays: ``values`` (int32 dictionary codes for
varchar), an optional bool ``nulls`` mask (True = NULL), the host-side
Dictionary, a static ``vrange`` bound from connector stats, the
``ascending`` sort-order flag and the long-decimal ``hi`` limb. A Page may
carry a selection mask ``sel`` instead of being compacted.

The physical dtypes are the reference's: integer, date and decimal columns
whose table-wide ``vrange`` fits int32 ride int32 (``fits_int32``), so the
dense-join gate, the merge kernel's int32 contract and ``vrange`` agree
with the JAX package. Nested (array/map/row) columns are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.dictionary import Dictionary

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(np_dtype) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(np_dtype)]


def to_device(arr, device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (dtype kept exactly; the
    tensor never shares a read-only host buffer)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class Column:
    type: T.Type
    values: torch.Tensor
    nulls: Optional[torch.Tensor] = None  # bool[n], True where NULL
    dictionary: Optional[Dictionary] = None  # required when type.is_varchar
    vrange: Optional[tuple] = None  # static (min, max) of values
    ascending: bool = False  # values non-decreasing in row order
    hi: Optional[torch.Tensor] = None  # long-decimal high limb (int64)

    def __post_init__(self):
        if self.type.is_varchar and self.dictionary is None:
            raise ValueError("varchar column requires a dictionary")
        if self.type.is_nested:
            raise NotImplementedError(f"nested column {self.type} is not ported")

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def to_python(self, idx: Optional[np.ndarray] = None) -> List:
        """Device -> host, decoding reprs back to Python values (rows
        ``idx`` only, when given)."""
        def host(t):
            a = to_numpy(t)
            return a if idx is None else a[idx]

        nulls = host(self.nulls).tolist() if self.nulls is not None else None
        vals = host(self.values)
        if self.hi is not None:
            his = host(self.hi).tolist()
            los = vals.astype(np.int64).view(np.uint64).tolist()
            out = [_from_repr(self.type, (h << 64) | lo) for h, lo in zip(his, los)]
        elif self.type.is_varchar:
            out = self.dictionary.decode(vals)
        else:
            out = [_from_repr(self.type, v) for v in vals.tolist()]
        if nulls is not None:
            out = [None if isnull else v for v, isnull in zip(out, nulls)]
        return out


def fits_int32(vrange) -> bool:
    """True when a (min, max) range can ride int32 physically. The bounds
    are strict: the dtype max stays free for join sentinels and the min
    stays negation-safe for descending sort keys."""
    if vrange is None:
        return False
    lo, hi = vrange
    return -(2**31) < lo and hi < 2**31 - 1


def merge_vrange(a, b):
    """Union of two optional (min, max) ranges; None dominates (unknown)."""
    if a is None or b is None:
        return None
    return (min(a[0], b[0]), max(a[1], b[1]))


def _from_repr(typ: T.Type, r):
    if isinstance(typ, T.TimestampType):
        import datetime

        unit = 10 ** typ.precision
        micros = int(r) * 1_000_000 // unit
        base = datetime.datetime(
            1970, 1, 1,
            tzinfo=datetime.timezone.utc if typ.with_tz else None)
        return base + datetime.timedelta(microseconds=micros)
    if typ == T.DATE:
        import datetime

        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(r))
    if typ.is_decimal:
        import decimal
        from decimal import Decimal

        with decimal.localcontext() as ctx:
            ctx.prec = 60
            return Decimal(r).scaleb(-typ.scale)
    if typ == T.BOOLEAN:
        return bool(r)
    if typ.is_floating:
        return float(r)
    return int(r)


@dataclasses.dataclass
class Page:
    """A batch of rows: one Column per channel + optional selection mask
    (bool[n], True = live; None = all live). ``live_prefix``: the live rows
    are exactly rows [0, k) — the shape ``compact_to`` produces."""

    columns: List[Column]
    sel: Optional[torch.Tensor] = None
    live_prefix: bool = False

    @property
    def num_rows(self) -> int:
        return 0 if not self.columns else len(self.columns[0])

    @staticmethod
    def all_dead(types: Sequence[T.Type], device) -> "Page":
        """One all-dead row of the given types — the canonical empty page
        (zero-length arrays break downstream gathers)."""
        cols = [
            Column(t, torch.zeros((1,), dtype=torch_dtype(t.np_dtype or np.int64),
                                  device=device),
                   None, Dictionary([""]) if t.is_varchar else None)
            for t in types
        ]
        return Page(cols, torch.zeros((1,), dtype=torch.bool, device=device))

    def to_pylist(self) -> List[tuple]:
        """Materialize live rows as Python tuples (host side)."""
        idx = None
        n = self.num_rows
        if self.sel is not None:
            idx = np.nonzero(to_numpy(self.sel))[0]
            n = len(idx)
        cols = [c.to_python(idx) for c in self.columns]
        return [tuple(col[i] for col in cols) for i in range(n)]


def page_from_numpy(columns: Iterable, sel=None, *, live_prefix: bool = False,
                    device) -> Page:
    """A port Page from host arrays plus column metadata — what a
    reference Page gives through ``np.asarray`` on each array. Each entry
    of ``columns`` is an object with ``type``, ``values`` and,
    optionally, ``nulls``, ``dictionary``, ``vrange``, ``ascending`` and
    ``hi``. Types and dictionaries of another package are rebuilt as this
    package's (by type name and vocabulary); dtypes are kept exactly."""
    cols = []
    for c in columns:
        typ = c.type
        if not isinstance(typ, T.Type):
            typ = T.parse_type(str(typ))
        d = getattr(c, "dictionary", None)
        if d is not None and not isinstance(d, Dictionary):
            d = Dictionary(list(d.values))
        nulls, hi = getattr(c, "nulls", None), getattr(c, "hi", None)
        vr = getattr(c, "vrange", None)
        cols.append(Column(
            typ,
            to_device(np.asarray(c.values), device),
            to_device(np.asarray(nulls), device) if nulls is not None else None,
            d,
            tuple(vr) if vr is not None else None,
            ascending=bool(getattr(c, "ascending", False)),
            hi=to_device(np.asarray(hi), device) if hi is not None else None,
        ))
    s = to_device(np.asarray(sel), device) if sel is not None else None
    return Page(cols, s, live_prefix=live_prefix)
