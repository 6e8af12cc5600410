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

Python rows enter as host ``ColumnData`` (``column_data_from_python``,
used by the memory connector and VALUES) and reach the device only
through staging or ``to_device``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.dictionary import NULL_CODE, Dictionary

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
            decode = _repr_decoder(self.type)
            out = [decode((h << 64) | lo) for h, lo in zip(his, los)]
        elif self.type.is_varchar:
            out = self.dictionary.decode(vals)
        else:
            out = list(map(_repr_decoder(self.type), vals.tolist()))
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


def _repr_encoder(typ: T.Type):
    """Python value -> storage representation (int days, scaled int, ...)
    for one type: the type is dispatched once, the function returned runs
    per value."""
    if isinstance(typ, T.TimestampType):
        import datetime

        unit = 10 ** typ.precision
        epoch = datetime.datetime(1970, 1, 1)

        def timestamp(v):
            if isinstance(v, str):
                v = datetime.datetime.fromisoformat(v)
            if isinstance(v, datetime.datetime):
                if v.tzinfo is not None:
                    v = v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
                delta = v - epoch
                micros = (delta.days * 86_400_000_000
                          + delta.seconds * 1_000_000 + delta.microseconds)
                return micros * unit // 1_000_000
            if isinstance(v, datetime.date):
                return (v - datetime.date(1970, 1, 1)).days * 86_400 * unit
            return int(v)

        return timestamp
    if typ == T.DATE:
        import datetime

        epoch = datetime.date(1970, 1, 1)

        def date(v):
            if isinstance(v, str):
                v = datetime.date.fromisoformat(v)
            if isinstance(v, datetime.date):
                return (v - epoch).days
            return int(v)

        return date
    if typ.is_decimal:
        import decimal

        ctx = decimal.getcontext().copy()
        ctx.prec = 60  # p=38 plus headroom: scaleb must not round
        scale = typ.scale

        def scaled(v):
            return int(decimal.Decimal(str(v)).scaleb(scale, context=ctx)
                       .to_integral_value(context=ctx))

        return scaled
    if typ == T.BOOLEAN:
        return bool
    if typ.is_floating:
        return float
    return int


def column_data_from_python(typ: T.Type, data: Sequence):
    """Python values (None = NULL) -> a host ``ColumnData``: what the
    reference's ``Column.from_python`` and ``spi.column_data_from_column``
    give together, without a trip through the device. Long decimals beyond
    int64 take two limbs."""
    from trino_tpu_torch.connector.spi import ColumnData

    n = len(data)
    nulls = (np.array([v is None for v in data], dtype=np.bool_)
             if any(v is None for v in data) else None)
    if typ.is_varchar:
        if typ.is_varbinary:
            # bytes ride the dictionary as hex strings (hex order is
            # unsigned-byte order)
            data = [v.hex() if isinstance(v, (bytes, bytearray)) else v for v in data]
        d = Dictionary.build(data)
        return ColumnData(typ, d.encode(list(data)), nulls, d)
    if typ.is_nested:
        raise NotImplementedError(f"nested column {typ} is not ported")
    np_dtype = typ.np_dtype
    encode = _repr_encoder(typ)
    reprs = [0 if v is None else encode(v) for v in data]
    if typ.is_decimal and any(
            isinstance(r, int) and not -(2**63) <= r < 2**63 for r in reprs):
        lo = np.array([r & (2**64 - 1) for r in reprs], dtype=np.uint64)
        hi = np.array([r >> 64 for r in reprs], dtype=np.int64)
        return ColumnData(typ, lo.view(np.int64), nulls, hi=hi)
    arr = np.array(reprs, dtype=np_dtype) if n else np.empty(0, dtype=np_dtype)
    return ColumnData(typ, arr, nulls)


def host_take(c: Column, idx: np.ndarray) -> Column:
    """Row gather through the host (numpy), back onto the column's device.
    The sorted flag survives only order-preserving gathers."""
    device = c.values.device
    monotone = bool(c.ascending) and (len(idx) < 2 or bool(np.all(np.diff(idx) >= 0)))
    return Column(
        c.type,
        to_device(to_numpy(c.values)[idx], device),
        to_device(to_numpy(c.nulls)[idx], device) if c.nulls is not None else None,
        c.dictionary,
        c.vrange,
        ascending=monotone,
        hi=to_device(to_numpy(c.hi)[idx], device) if c.hi is not None else None,
    )


def _concat_col(ca: Column, cb: Column) -> Column:
    va, vb = ca.values, cb.values
    if va.dtype != vb.dtype:  # mixed physical widths: promote
        dt = torch.promote_types(va.dtype, vb.dtype)
        va, vb = va.to(dt), vb.to(dt)
    d = ca.dictionary
    if (d is not None and cb.dictionary is not None and d is not cb.dictionary
            and d.values != cb.dictionary.values):
        d = ca.dictionary.merge(cb.dictionary)

        def recode(v, src):
            t = np.asarray(src.recode_table(d))
            # an all-NULL side has an empty vocabulary: pad the table
            table = to_device(t if len(t) else np.array([NULL_CODE], np.int32), v.device)
            return torch.where(v >= 0, table[v.long().clamp(min=0)],
                               torch.full_like(v, NULL_CODE))

        va, vb = recode(va, ca.dictionary), recode(vb, cb.dictionary)
    nulls = None
    if ca.nulls is not None or cb.nulls is not None:
        na = ca.nulls if ca.nulls is not None else torch.zeros_like(va, dtype=torch.bool)
        nb = cb.nulls if cb.nulls is not None else torch.zeros_like(vb, dtype=torch.bool)
        nulls = torch.cat([na, nb])
    hi = None
    if ca.hi is not None or cb.hi is not None:
        # a missing high limb is the sign extension of the low word
        ha = ca.hi if ca.hi is not None else (va.to(torch.int64) >> 63)
        hb = cb.hi if cb.hi is not None else (vb.to(torch.int64) >> 63)
        hi = torch.cat([ha, hb])
    vr = None if hi is not None else merge_vrange(ca.vrange, cb.vrange)
    return Column(ca.type, torch.cat([va, vb]), nulls, d, vr, hi=hi)


def _repr_decoder(typ: T.Type):
    """Storage representation -> Python value for one type, dispatched
    once; the function returned runs per value."""
    if isinstance(typ, T.TimestampType):
        import datetime

        unit = 10 ** typ.precision
        base = datetime.datetime(
            1970, 1, 1,
            tzinfo=datetime.timezone.utc if typ.with_tz else None)

        def timestamp(r):
            return base + datetime.timedelta(microseconds=int(r) * 1_000_000 // unit)

        return timestamp
    if typ == T.DATE:
        import datetime

        epoch = datetime.date(1970, 1, 1)

        def date(r):
            return epoch + datetime.timedelta(days=int(r))

        return date
    if typ.is_decimal:
        import decimal

        ctx = decimal.getcontext().copy()
        ctx.prec = 60
        scale = -typ.scale

        def scaled(r):
            return decimal.Decimal(r).scaleb(scale, context=ctx)

        return scaled
    if typ == T.BOOLEAN:
        return bool
    if typ.is_floating:
        return float
    return int


def _from_repr(typ: T.Type, r):
    return _repr_decoder(typ)(r)


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

    @staticmethod
    def concat_pages(a: "Page", b: "Page") -> "Page":
        """Row-wise concatenation (n_a + n_b rows); differing dictionaries
        are merged on the host and recoded by one gather on the device."""
        cols = [_concat_col(ca, cb) for ca, cb in zip(a.columns, b.columns)]
        sa = a.sel if a.sel is not None else torch.ones(
            (a.num_rows,), dtype=torch.bool, device=cols[0].values.device)
        sb = b.sel if b.sel is not None else torch.ones(
            (b.num_rows,), dtype=torch.bool, device=cols[0].values.device)
        return Page(cols, torch.cat([sa, sb]))

    def compact(self) -> "Page":
        """Drop dead rows (a gather through the host)."""
        if self.sel is None:
            return self
        idx = np.nonzero(to_numpy(self.sel))[0]
        return Page([host_take(c, idx) for c in self.columns], None)

    def to_pylist(self) -> List[tuple]:
        """Materialize live rows as Python tuples (host side)."""
        idx = None
        n = self.num_rows
        if self.sel is not None:
            idx = np.nonzero(to_numpy(self.sel))[0]
            n = len(idx)
        cols = [c.to_python(idx) for c in self.columns]
        return list(zip(*cols)) if cols else [()] * n


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
