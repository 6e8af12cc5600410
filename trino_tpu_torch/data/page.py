"""Page/Column over torch tensors: the port of trino_tpu/data/page.py.

A Column is a struct-of-arrays: ``values`` (int32 dictionary codes for
varchar), an optional bool ``nulls`` mask (True = NULL), the host-side
Dictionary, a static ``vrange`` bound from connector stats, the
``ascending`` sort-order flag and the long-decimal ``hi`` limb. A Page may
carry a selection mask ``sel`` instead of being compacted.

The physical dtypes are the reference's: integer, date and decimal columns
whose table-wide ``vrange`` fits int32 ride int32 (``fits_int32``), so the
dense-join gate, the merge kernel's int32 contract and ``vrange`` agree
with the JAX package. A nested (array, map or row) column holds per-row
int32 element counts in ``values`` (int8 zeros for a row) and its
flattened child columns in ``children``: ``[elements]`` for an array,
``[keys, values]`` for a map, the fields for a row.

Python rows enter as host ``ColumnData`` (``column_data_from_python``,
used by the memory connector and VALUES) and reach the device only
through staging or ``to_device``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.dictionary import NULL_CODE, Dictionary
from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs import trace as tracing

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


_NUMPY_DTYPES = {t: d for d, t in _TORCH_DTYPES.items()}


def torch_dtype(np_dtype) -> torch.dtype:
    return _TORCH_DTYPES[np.dtype(np_dtype)]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype ``to_numpy`` gives a tensor of ``dtype``."""
    return _NUMPY_DTYPES[dtype]


def to_device(arr, device) -> torch.Tensor:
    """Host numpy array -> tensor on ``device`` (dtype kept exactly; the
    tensor never shares a read-only host buffer). Inside ``constant_store``
    the tensor comes from that store."""
    arr = np.ascontiguousarray(arr)
    store = _CONSTANTS.get()
    if store is not None:
        return store.tensor(arr, device)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


class ConstantStore:
    """The host-computed constants of one compiled query body (lookup
    tables over dictionaries, Values rows, fixed tables), on the device
    and keyed by content. A captured CUDA graph may not copy from host
    memory, so the warm-up run of the body fills the store and the
    capture reuses its tensors; once ``frozen``, a constant the warm-up
    did not upload raises. The body only reads these tensors."""

    def __init__(self):
        self._tensors: Dict[tuple, torch.Tensor] = {}
        self.frozen = False

    def __len__(self) -> int:
        return len(self._tensors)

    def tensor(self, arr: np.ndarray, device) -> torch.Tensor:
        device = torch.device(device)
        key = (str(device), arr.dtype.str, arr.shape, arr.tobytes())
        t = self._tensors.get(key)
        if t is None:
            if self.frozen:
                raise RuntimeError(
                    f"constant of shape {arr.shape} ({arr.dtype}) first uploaded "
                    "after the warm-up run of a compiled body")
            host = torch.from_numpy(arr.copy())
            if device.type == "cuda":
                # pinned and asynchronous: no synchronizing copy
                t = host.pin_memory().to(device, non_blocking=True)
            else:
                t = host.to(device)
            self._tensors[key] = t
        return t


_CONSTANTS: "contextvars.ContextVar[Optional[ConstantStore]]" = contextvars.ContextVar(
    "trino_tpu_torch_constants", default=None)


@contextlib.contextmanager
def constant_store(store: ConstantStore):
    """Route every ``to_device`` of the block through ``store``."""
    token = _CONSTANTS.set(store)
    try:
        yield store
    finally:
        _CONSTANTS.reset(token)


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
    # nested columns: the flattened child columns (see the module docstring)
    children: Optional[List["Column"]] = None

    def __post_init__(self):
        if self.type.is_varchar and self.dictionary is None:
            raise ValueError("varchar column requires a dictionary")
        if self.type.is_nested and self.children is None:
            raise ValueError(f"nested column {self.type} requires children")

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def offsets(self) -> np.ndarray:
        """Host int64 offsets[n+1] of an array or map column's rows in its
        flat children. The lengths describe the flat layout even under a
        NULL row, which may own elements that are never read."""
        lens = to_numpy(self.values).astype(np.int64)
        return np.concatenate([np.zeros(1, np.int64), np.cumsum(lens)])

    def to_python(self, idx: Optional[np.ndarray] = None) -> List:
        """Device -> host, decoding reprs back to Python values (rows
        ``idx`` only, when given). A NULL row's slot is never decoded: it
        may hold anything (the identity of an empty group's max)."""
        return self._python_values(self._host_copy(idx))

    def _host_copy(self, idx: Optional[np.ndarray] = None):
        """Every device-to-host copy ``to_python`` makes, rows ``idx`` only:
        for a nested column the column on the host; else the values with a
        NULL row's slot cleared, the NULL flags and the high limbs, as
        numpy arrays (``_python_values`` decodes either)."""
        if self.type.is_nested:
            return self._on_host() if idx is None else host_take(self, idx, torch.device("cpu"))

        def host(t):
            a = to_numpy(t)
            return a if idx is None else a[idx]

        nulls = host(self.nulls) if self.nulls is not None else None
        vals = host(self.values)
        his = host(self.hi) if self.hi is not None else None
        if nulls is not None:
            vals = np.where(nulls, vals.dtype.type(NULL_CODE if self.type.is_varchar else 0),
                            vals)
            if his is not None:
                his = np.where(nulls, 0, his)
        return vals, nulls, his

    def _on_host(self) -> "Column":
        """This column, its NULL flags, high limbs and children on the host."""
        return dataclasses.replace(
            self, values=self.values.cpu(),
            nulls=None if self.nulls is None else self.nulls.cpu(),
            hi=None if self.hi is None else self.hi.cpu(),
            children=None if self.children is None else [k._on_host() for k in self.children])

    def _python_values(self, host) -> List:
        """The Python values of ``_host_copy``'s result."""
        if self.type.is_nested:
            return host._nested_to_python()
        vals, nulls, his = host
        if his is not None:
            los = vals.astype(np.int64).view(np.uint64).tolist()
            decode = _repr_decoder(self.type)
            out = [decode((h << 64) | lo) for h, lo in zip(his.tolist(), los)]
        elif self.type.is_varchar:
            out = self.dictionary.decode(vals)
            if self.type.is_varbinary:  # the dictionary holds hex
                out = [None if v is None else bytes.fromhex(v) for v in out]
        else:
            out = list(map(_repr_decoder(self.type), vals.tolist()))
        if nulls is not None:
            out = [None if isnull else v for v, isnull in zip(out, nulls.tolist())]
        return out

    def _nested_to_python(self) -> List:
        kids = [c.to_python() for c in self.children]
        if isinstance(self.type, T.RowType):
            out = [tuple(f[i] for f in kids) for i in range(len(self))]
        else:
            off = self.offsets().tolist()
            if isinstance(self.type, T.MapType):
                keys, vals = kids
                out = [dict(zip(keys[off[i]:off[i + 1]], vals[off[i]:off[i + 1]]))
                       for i in range(len(self))]
            else:
                (flat,) = kids
                out = [flat[off[i]:off[i + 1]] for i in range(len(self))]
        if self.nulls is not None:
            out = [None if isnull else v
                   for v, isnull in zip(out, to_numpy(self.nulls).tolist())]
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
        return _nested_data_from_python(typ, data, nulls)
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


def _nested_data_from_python(typ: T.Type, data: Sequence, nulls):
    """The reference's ``Column._nested_from_python`` as host ColumnData: a
    map's entries in the order of their keys' text."""
    from trino_tpu_torch.connector.spi import ColumnData

    n = len(data)
    if isinstance(typ, T.RowType):
        kids = [column_data_from_python(ft, [None if r is None else r[i] for r in data])
                for i, ft in enumerate(typ.field_types)]
        return ColumnData(typ, np.zeros(n, np.int8), nulls, children=kids)
    if isinstance(typ, T.MapType):
        rows = [[] if m is None else sorted(m.items(), key=lambda kv: str(kv[0]))
                for m in data]
        kids = [column_data_from_python(typ.key, [k for r in rows for k, _ in r]),
                column_data_from_python(typ.value, [v for r in rows for _, v in r])]
    else:
        rows = [[] if a is None else list(a) for a in data]
        kids = [column_data_from_python(typ.element, [v for r in rows for v in r])]
    lens = np.array([len(r) for r in rows], dtype=np.int32)
    return ColumnData(typ, lens, nulls, children=kids)


def column_to_device(c, device) -> Column:
    """A port Column on ``device`` from host arrays plus metadata: a
    ``ColumnData``, or a column of another package read through
    ``np.asarray`` (its type and dictionary rebuilt as this package's, by
    type name and vocabulary). Dtypes are kept exactly; children recurse."""
    typ = c.type
    if not isinstance(typ, T.Type):
        typ = T.parse_type(str(typ))
    d = getattr(c, "dictionary", None)
    if d is not None and not isinstance(d, Dictionary):
        d = Dictionary(list(d.values))
    nulls, hi = getattr(c, "nulls", None), getattr(c, "hi", None)
    vr = getattr(c, "vrange", None)
    kids = getattr(c, "children", None)
    return Column(
        typ,
        to_device(np.asarray(c.values), device),
        to_device(np.asarray(nulls), device) if nulls is not None else None,
        d,
        tuple(vr) if vr is not None else None,
        ascending=bool(getattr(c, "ascending", getattr(c, "sorted", False))),
        hi=to_device(np.asarray(hi), device) if hi is not None else None,
        children=[column_to_device(k, device) for k in kids] if kids is not None else None,
    )


def _flat_take_index(off: np.ndarray, lens: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Flat child positions of rows ``idx`` in order: each row's
    [off, off + len) range, concatenated."""
    take = lens[idx]
    total = int(take.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    shift = np.repeat(off[idx] - (np.cumsum(take) - take), take)
    return shift + np.arange(total, dtype=np.int64)


def host_take(c: Column, idx: np.ndarray, device=None) -> Column:
    """Row gather through the host (numpy), onto ``device`` (the column's
    own by default). The one gather that re-flattens a nested column's
    children. The sorted flag survives only order-preserving gathers."""
    device = c.values.device if device is None else device
    if c.type.is_nested:
        nulls = to_numpy(c.nulls)[idx] if c.nulls is not None else None
        if isinstance(c.type, T.RowType):
            kids = [host_take(k, idx, device) for k in c.children]
            vals = to_numpy(c.values)[idx]
        else:
            lens = to_numpy(c.values).astype(np.int64)
            child_idx = _flat_take_index(c.offsets(), lens, np.asarray(idx, np.int64))
            kids = [host_take(k, child_idx, device) for k in c.children]
            vals = lens[idx].astype(np.int32)
        return Column(c.type, to_device(vals, device),
                      to_device(nulls, device) if nulls is not None else None,
                      children=kids)
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


def _align_flat(kids: List[Column], lens_a: torch.Tensor, na: int, nb: int) -> List[Column]:
    """The concatenated flat children of an array or map column with the
    second part's entries moved to where the combined lengths put them. A
    map aggregate's flat child holds dead entries past its rows' ranges,
    so the second part starts at sum(lens_a), not at ``na``; the dead
    entries move to the end. One gather on the device, no host read (the
    identity when the first part has no dead entries). The reference
    concatenates as is, and a UNION ALL of two map aggregates reads the
    second branch's maps shifted."""
    if any(k.type.is_nested for k in kids):
        return kids
    device = lens_a.device
    live_a = lens_a.to(torch.int64).sum()
    p = torch.arange(na + nb, dtype=torch.int64, device=device)
    idx = torch.where(p < live_a, p,
                      torch.where(p < live_a + nb, p - live_a + na, p - nb))
    return [Column(k.type, k.values[idx], k.nulls[idx] if k.nulls is not None else None,
                   k.dictionary, k.vrange, hi=k.hi[idx] if k.hi is not None else None)
            for k in kids]


def _concat_col(ca: Column, cb: Column) -> Column:
    va, vb = ca.values, cb.values
    if ca.type.is_nested:
        # lengths concatenate, and so do the flat children
        nulls = None
        if ca.nulls is not None or cb.nulls is not None:
            na = ca.nulls if ca.nulls is not None else torch.zeros_like(va, dtype=torch.bool)
            nb = cb.nulls if cb.nulls is not None else torch.zeros_like(vb, dtype=torch.bool)
            nulls = torch.cat([na, nb])
        kids = [_concat_col(ka, kb) for ka, kb in zip(ca.children, cb.children)]
        if not ca.type.is_row:
            kids = _align_flat(kids, va, len(ca.children[0]), len(cb.children[0]))
        return Column(ca.type, torch.cat([va, vb]), nulls, children=kids)
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
    (bool[n], True = live; None = all live). ``replicated``: under the SPMD
    tier (parallel/spmd.py), every rank holds the same rows (after a gather
    or a broadcast); False, a rank's own shard. Host bookkeeping only; off
    the mesh it is False everywhere. ``live_prefix``: the live rows are
    exactly rows [0, k) — the shape ``compact_to`` produces."""

    columns: List[Column]
    sel: Optional[torch.Tensor] = None
    replicated: bool = False
    live_prefix: bool = False

    @property
    def num_rows(self) -> int:
        return 0 if not self.columns else len(self.columns[0])

    @staticmethod
    def all_dead(types: Sequence[T.Type], device) -> "Page":
        """One all-dead row of the given types — the canonical empty page
        (zero-length arrays break downstream gathers). A row's fields have
        its rows; an array's or map's children are empty."""
        def col_of(t: T.Type, nrows: int) -> Column:
            kids = ([col_of(ct, nrows if t.is_row else 0) for ct in T.type_children(t)]
                    if t.is_nested else None)
            return Column(t, torch.zeros((nrows,), dtype=torch_dtype(t.np_dtype or np.int64),
                                         device=device),
                          None, Dictionary([""]) if t.is_varchar else None, children=kids)

        return Page([col_of(t, 1) for t in types],
                    torch.zeros((1,), dtype=torch.bool, device=device))

    @staticmethod
    def concat_pages(a: "Page", b: "Page") -> "Page":
        """Row-wise concatenation (n_a + n_b rows); differing dictionaries
        are merged on the host and recoded by one gather on the device."""
        cols = [_concat_col(ca, cb) for ca, cb in zip(a.columns, b.columns)]
        sa = a.sel if a.sel is not None else torch.ones(
            (a.num_rows,), dtype=torch.bool, device=cols[0].values.device)
        sb = b.sel if b.sel is not None else torch.ones(
            (b.num_rows,), dtype=torch.bool, device=cols[0].values.device)
        return Page(cols, torch.cat([sa, sb]), a.replicated and b.replicated)

    def compact(self) -> "Page":
        """Drop dead rows (a gather through the host)."""
        if self.sel is None:
            return self
        idx = np.nonzero(to_numpy(self.sel))[0]
        return Page([host_take(c, idx) for c in self.columns], None, self.replicated)

    def slice_rows(self, lo: int, hi: int) -> "Page":
        """Row range [lo, hi) of a compacted page (sel must be None)."""
        assert self.sel is None, "slice_rows requires a compacted page"
        cols = [
            host_take(c, np.arange(lo, min(hi, len(c)), dtype=np.int64))
            if c.type.is_nested
            else Column(c.type, c.values[lo:hi],
                        c.nulls[lo:hi] if c.nulls is not None else None,
                        c.dictionary, c.vrange, ascending=c.ascending,
                        hi=c.hi[lo:hi] if c.hi is not None else None)
            for c in self.columns
        ]
        return Page(cols, None, self.replicated)

    def row_byte_estimate(self) -> int:
        """Rough serialized bytes a row (dtype widths; a nested column's
        children amortized over the parent rows)."""
        total = 0
        for c in self.columns:
            total += c.values.element_size()
            if c.nulls is not None:
                total += 1
            if c.children is not None and self.num_rows:
                for k in c.children:
                    total += max(1, (len(k) * k.values.element_size()) // self.num_rows)
        return max(total, 1)

    def to_pylist(self) -> List[tuple]:
        """Materialize live rows as Python tuples (host side): the
        ``rows/copy`` span (the selection and every column's host copies,
        its seconds to ``trino_tpu_rows_copy_seconds_total``), then
        ``rows/convert`` (the Python values and their tuples)."""
        with tracing.timed("rows/copy", M.ROWS_COPY_SECONDS, detail=True):
            idx = None
            n = self.num_rows
            if self.sel is not None:
                idx = np.nonzero(to_numpy(self.sel))[0]
                n = len(idx)
            hosts = [c._host_copy(idx) for c in self.columns]
        with tracing.timed("rows/convert", detail=True):
            cols = [c._python_values(h) for c, h in zip(self.columns, hosts)]
            return list(zip(*cols)) if cols else [()] * n


def page_from_numpy(columns: Iterable, sel=None, *, live_prefix: bool = False,
                    device) -> Page:
    """A port Page from host arrays plus column metadata — what a
    reference Page gives through ``np.asarray`` on each array
    (``column_to_device`` per column)."""
    s = to_device(np.asarray(sel), device) if sel is not None else None
    return Page([column_to_device(c, device) for c in columns], s, live_prefix=live_prefix)
