"""Columnar wire format, Page <-> bytes: the port of trino_tpu/data/serde.py,
byte for byte the reference's version 3 (and it reads version 2).

A device page is compacted on its device first (one gather a column by the
live rows' positions), then each array is copied to the host once; the
encoding itself is host work over numpy arrays. Decoding builds host arrays
and ends in one host->device copy an array. The physical dtype written is
the reference's for the same logical type, so both packages write the same
bytes for the same rows and each decodes the other's.

Format (little-endian):
  magic u32 | version u8 | codec u8 | num_columns u16 | num_rows u32
  then per column: block_codec u8 | block_len u32 | block bytes
  (block_codec = CODEC_ZLIB when compressed, CODEC_NONE when stored raw:
  a block zlib does not shrink is stored raw)
  where each block decodes to:
    type_name: u16 len + utf8
    has_nulls: u8; if 1: packed bitmap ceil(n/8) bytes
    dtype_code: u8 (the physical dtype; bit 7 set: a long-decimal high
      limb of n int64 follows the values)
    values: n * itemsize bytes
    if varchar: dict_len u32, then dict_len strings (u32 len + utf8)
    if nested: per child, u32 flat row count and the child block
Version 2 compressed the whole body with zlib once.
"""
from __future__ import annotations

import struct
import time
import zlib
from typing import List

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.data.dictionary import Dictionary
from trino_tpu_torch.data.page import Column, Page, host_take, to_device, to_numpy
from trino_tpu_torch.obs import metrics as M

MAGIC = 0x7E51_00D5
CODEC_NONE = 0
CODEC_ZLIB = 1

_CODEC_NAMES = {CODEC_NONE: "none", CODEC_ZLIB: "zlib"}

_DTYPE_CODES = {
    np.dtype(np.bool_): 0, np.dtype(np.int8): 1, np.dtype(np.int16): 2,
    np.dtype(np.int32): 3, np.dtype(np.int64): 4,
    np.dtype(np.float32): 5, np.dtype(np.float64): 6,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_CPU = torch.device("cpu")


def _host_column(c: Column) -> Column:
    """The column with every array on the host (one copy each)."""
    return Column(
        c.type, c.values.to(_CPU), c.nulls.to(_CPU) if c.nulls is not None else None,
        c.dictionary, c.vrange, ascending=c.ascending,
        hi=c.hi.to(_CPU) if c.hi is not None else None,
        children=[_host_column(k) for k in c.children] if c.children is not None else None)


def compact_on_device(page: Page) -> Page:
    """The page's live rows, gathered on its device by their positions
    (one read of the selection); a nested column gathers through the
    host, as ``host_take`` does, and lands back on the page's device."""
    if page.sel is None or not page.columns:
        return page
    idx = torch.nonzero(page.sel).squeeze(1)
    idx_np = None
    cols = []
    for c in page.columns:
        if c.type.is_nested:
            if idx_np is None:
                idx_np = to_numpy(idx)
            cols.append(host_take(c, idx_np))
        else:
            cols.append(Column(
                c.type, c.values[idx], c.nulls[idx] if c.nulls is not None else None,
                c.dictionary, c.vrange, ascending=c.ascending,
                hi=c.hi[idx] if c.hi is not None else None))
    return Page(cols, None)


def host_page(page: Page) -> Page:
    """A compacted copy of ``page`` on the host: the live rows gathered on
    the page's device, then each array copied to the host once."""
    return Page([_host_column(c) for c in compact_on_device(page).columns], None)


def _serialize_column(col: Column, parts: List[bytes]) -> None:
    name = str(col.type).encode()
    parts.append(struct.pack("<H", len(name)))
    parts.append(name)
    if col.nulls is not None:
        parts.append(b"\x01")
        parts.append(np.packbits(to_numpy(col.nulls)).tobytes())
    else:
        parts.append(b"\x00")
    vals = np.ascontiguousarray(to_numpy(col.values))
    dtype_code = _DTYPE_CODES[vals.dtype]
    if col.hi is not None:
        parts.append(struct.pack("<B", dtype_code | 0x80))
        parts.append(vals.tobytes())
        parts.append(np.ascontiguousarray(to_numpy(col.hi)).tobytes())
    else:
        parts.append(struct.pack("<B", dtype_code))
        parts.append(vals.tobytes())
    if col.type.is_varchar:
        vocab = col.dictionary.values
        parts.append(struct.pack("<I", len(vocab)))
        for s in vocab:
            b = s.encode()
            parts.append(struct.pack("<I", len(b)))
            parts.append(b)
    if col.type.is_nested:
        for child in col.children:
            parts.append(struct.pack("<I", len(child)))
            _serialize_column(child, parts)


def serialize_page(page: Page, codec: int = CODEC_ZLIB) -> bytes:
    """Version-3 bytes of the page's live rows (the page is compacted and
    brought to the host first where it is not already)."""
    t0 = time.perf_counter()
    if page.sel is not None or any(c.values.device.type != "cpu" for c in page.columns):
        page = host_page(page)
    n = page.num_rows
    out: List[bytes] = [struct.pack("<IBBHI", MAGIC, 3, codec, len(page.columns), n)]
    logical = 0
    compress_s = 0.0
    wire_by_codec = {CODEC_NONE: 0, CODEC_ZLIB: 0}
    for col in page.columns:
        parts: List[bytes] = []
        _serialize_column(col, parts)
        body = b"".join(parts)
        logical += len(body)
        block_codec, block = CODEC_NONE, body
        if codec == CODEC_ZLIB:
            tz = time.perf_counter()
            comp = zlib.compress(body, level=1)
            compress_s += time.perf_counter() - tz
            if len(comp) < len(body):
                block_codec, block = CODEC_ZLIB, comp
        wire_by_codec[block_codec] += len(block)
        out.append(struct.pack("<BI", block_codec, len(block)))
        out.append(block)
    for bc, nbytes in wire_by_codec.items():
        if nbytes:
            M.SERDE_BYTES.inc(nbytes, "encode", _CODEC_NAMES[bc])
    if logical:
        M.SERDE_BYTES.inc(logical, "encode", "logical")
    M.SERDE_SECONDS.inc(compress_s, "compress")
    M.SERDE_SECONDS.inc(time.perf_counter() - t0, "encode")
    return b"".join(out)


def deserialize_page(data: bytes, device="cpu") -> Page:
    """A Page on ``device`` from version-3 (or version-2) bytes."""
    t0 = time.perf_counter()
    device = torch.device(device)
    magic, version, codec, ncols, nrows = struct.unpack_from("<IBBHI", data, 0)
    if magic != MAGIC:
        raise ValueError("bad page magic")
    columns: List[Column] = []
    if version == 2:
        body = data[12:]
        if codec == CODEC_ZLIB:
            body = zlib.decompress(body)
        off = 0
        for _ in range(ncols):
            col, off = _deserialize_column(body, off, nrows, device)
            columns.append(col)
        M.SERDE_SECONDS.inc(time.perf_counter() - t0, "decode")
        return Page(columns)
    if version != 3:
        raise ValueError(f"unsupported page format version {version} (expected 2 or 3)")
    off = 12
    logical = 0
    decompress_s = 0.0
    wire_by_codec = {CODEC_NONE: 0, CODEC_ZLIB: 0}
    for _ in range(ncols):
        block_codec, block_len = struct.unpack_from("<BI", data, off)
        off += 5
        block = data[off:off + block_len]
        off += block_len
        wire_by_codec[block_codec] = wire_by_codec.get(block_codec, 0) + block_len
        if block_codec == CODEC_ZLIB:
            tz = time.perf_counter()
            block = zlib.decompress(block)
            decompress_s += time.perf_counter() - tz
        elif block_codec != CODEC_NONE:
            raise ValueError(f"unknown column block codec {block_codec}")
        logical += len(block)
        col, _end = _deserialize_column(block, 0, nrows, device)
        columns.append(col)
    for bc, nbytes in wire_by_codec.items():
        if nbytes:
            M.SERDE_BYTES.inc(nbytes, "decode", _CODEC_NAMES[bc])
    if logical:
        M.SERDE_BYTES.inc(logical, "decode", "logical")
    M.SERDE_SECONDS.inc(decompress_s, "decompress")
    M.SERDE_SECONDS.inc(time.perf_counter() - t0, "decode")
    return Page(columns)


def _deserialize_column(body: bytes, off: int, nrows: int, device):
    (name_len,) = struct.unpack_from("<H", body, off)
    off += 2
    typ = T.parse_type(body[off:off + name_len].decode())
    off += name_len
    has_nulls = body[off]
    off += 1
    nulls = None
    if has_nulls:
        nbytes = (nrows + 7) // 8
        bits = np.unpackbits(
            np.frombuffer(body, dtype=np.uint8, count=nbytes, offset=off))[:nrows]
        nulls = to_device(bits.astype(np.bool_), device)
        off += nbytes
    code = body[off]
    has_hi = bool(code & 0x80)
    dt = _CODE_DTYPES[code & 0x7F]
    off += 1
    vals = np.frombuffer(body, dtype=dt, count=nrows, offset=off)
    off += nrows * dt.itemsize
    hi = None
    if has_hi:
        hi = np.frombuffer(body, dtype=np.int64, count=nrows, offset=off)
        off += nrows * 8
    dictionary = None
    if typ.is_varchar:
        (dlen,) = struct.unpack_from("<I", body, off)
        off += 4
        vocab = []
        for _ in range(dlen):
            (slen,) = struct.unpack_from("<I", body, off)
            off += 4
            vocab.append(body[off:off + slen].decode())
            off += slen
        dictionary = Dictionary(vocab)
    children = None
    if typ.is_nested:
        children = []
        for _ in T.type_children(typ):
            (crows,) = struct.unpack_from("<I", body, off)
            off += 4
            child, off = _deserialize_column(body, off, crows, device)
            children.append(child)
    return (
        Column(typ, to_device(vals, device), nulls, dictionary, children=children,
               hi=to_device(hi, device) if hi is not None else None),
        off,
    )
