"""The port's wire format (trino_tpu_torch/data/serde.py) against the JAX
package's (trino_tpu/data/serde.py): the same page serializes to the same
bytes in both, each package decodes the other's bytes, version-2 payloads
still decode, and a device page is compacted before it is written.

Pages are built from the same Python values in both packages
(``Column.from_python`` in the reference, ``column_data_from_python`` in the
port); values and bytes must be equal exactly.
"""
import datetime
import struct
import zlib
from decimal import Decimal

import numpy as np
import pytest
import torch

import trino_tpu  # noqa: F401  (turns on JAX x64 first)
import jax.numpy as jnp
from trino_tpu import types as JT
from trino_tpu.data import serde as jserde
from trino_tpu.data.page import Column as JaxColumn
from trino_tpu.data.page import Page as JaxPage

from trino_tpu_torch import types as TT
from trino_tpu_torch.data import serde as tserde
from trino_tpu_torch.data.page import (Page, column_data_from_python, column_to_device,
                                       page_from_numpy)

N = 300
_RNG = np.random.default_rng(11)


def _nullify(vals, rate=0.1):
    mask = _RNG.random(len(vals)) < rate
    return [None if m else v for v, m in zip(vals, mask)]


WORDS = ["apple", "banana", "cherry", "", "dürüm", "egg plant"]
FLAT = {
    "boolean": [bool(v) for v in _RNG.integers(0, 2, N)],
    "tinyint": [int(v) for v in _RNG.integers(-100, 100, N)],
    "smallint": [int(v) for v in _RNG.integers(-30000, 30000, N)],
    "integer": [int(v) for v in _RNG.integers(-2**31 + 1, 2**31 - 1, N)],
    "bigint": [int(v) for v in _RNG.integers(-2**62, 2**62, N)],
    "real": [float(np.float32(v)) for v in _RNG.normal(0, 100, N)],
    "double": [float(v) for v in _RNG.normal(0, 1e6, N)],
    "decimal(12,2)": [Decimal(int(v)).scaleb(-2) for v in _RNG.integers(-10**11, 10**11, N)],
    "decimal(38,2)": [Decimal(int(v)).scaleb(-2) * (10**20 if i % 7 == 0 else 1)
                      for i, v in enumerate(_RNG.integers(-10**9, 10**9, N))],
    "date": [datetime.date(1992, 1, 1) + datetime.timedelta(days=int(v))
             for v in _RNG.integers(0, 2500, N)],
    "varchar": [WORDS[int(v)] for v in _RNG.integers(0, len(WORDS), N)],
}
CASES = [(t, nulls) for t in FLAT for nulls in (False, True)]


def _both(tname, values):
    j = JaxColumn.from_python(JT.parse_type(tname), values)
    t = column_to_device(column_data_from_python(TT.parse_type(tname), values), "cpu")
    return t, j


def _pages(tname, nulls, sel=None):
    values = _nullify(FLAT[tname]) if nulls else FLAT[tname]
    t, j = _both(tname, values)
    # a second column: an id, so every page has a compressible block
    ids = list(range(N))
    ti, ji = _both("bigint", ids)
    jp = JaxPage([j, ji], jnp.asarray(sel) if sel is not None else None)
    tp = Page([t, ti], torch.from_numpy(sel) if sel is not None else None)
    return tp, jp


@pytest.mark.parametrize("codec", [jserde.CODEC_ZLIB, jserde.CODEC_NONE])
@pytest.mark.parametrize("tname,nulls", CASES)
def test_bytes_equal_reference(tname, nulls, codec):
    tp, jp = _pages(tname, nulls)
    jb = jserde.serialize_page(jp, codec=codec)
    tb = tserde.serialize_page(tp, codec=codec)
    assert tb == jb
    # each package reads the other's bytes back to the same rows
    assert tserde.deserialize_page(jb).to_pylist() == jp.to_pylist()
    assert jserde.deserialize_page(tb).to_pylist() == tp.to_pylist()
    back = tserde.deserialize_page(tb)
    assert [str(c.type) for c in back.columns] == [str(c.type) for c in jp.columns]
    assert tserde.serialize_page(back, codec=codec) == tb


def test_incompressible_block_is_stored_raw():
    """A block zlib does not shrink (uniform 64-bit integers) is stored raw,
    in both packages, beside a compressed one."""
    tp, jp = _pages("bigint", False)
    tb = tserde.serialize_page(tp)
    assert tb == jserde.serialize_page(jp)
    off, codecs = 12, []
    for _ in range(2):
        codec, n = struct.unpack_from("<BI", tb, off)
        codecs.append(codec)
        off += 5 + n
    assert codecs == [tserde.CODEC_NONE, tserde.CODEC_ZLIB]


@pytest.mark.parametrize("tname", ["bigint", "varchar", "decimal(38,2)", "boolean"])
def test_selection_compacted_before_writing(tname):
    """A page with a selection writes its live rows: the reference compacts
    first (``Page.compact``), the port gathers on the page's device."""
    sel = _RNG.random(N) < 0.6
    tp, jp = _pages(tname, True, sel)
    assert tserde.serialize_page(tp) == jserde.serialize_page(jp.compact())
    host = tserde.host_page(tp)
    assert host.sel is None and host.num_rows == int(sel.sum())
    assert all(c.values.device.type == "cpu" for c in host.columns)


def _v2_from_v3(data: bytes) -> bytes:
    """The version-2 frame of the same page: every column block inflated,
    concatenated and compressed once."""
    magic, _, codec, ncols, nrows = struct.unpack_from("<IBBHI", data, 0)
    off, body = 12, b""
    for _ in range(ncols):
        bc, n = struct.unpack_from("<BI", data, off)
        block = data[off + 5:off + 5 + n]
        body += zlib.decompress(block) if bc == 1 else block
        off += 5 + n
    return struct.pack("<IBBHI", magic, 2, 1, ncols, nrows) + zlib.compress(body)


@pytest.mark.parametrize("tname", ["varchar", "decimal(38,2)", "date"])
def test_version_2_payloads_decode(tname):
    tp, jp = _pages(tname, True)
    v2 = _v2_from_v3(jserde.serialize_page(jp))
    assert jserde.deserialize_page(v2).to_pylist() == jp.to_pylist()
    assert tserde.deserialize_page(v2).to_pylist() == jp.to_pylist()


def test_unknown_version_and_magic_refused():
    tp, _ = _pages("bigint", False)
    data = bytearray(tserde.serialize_page(tp))
    data[4] = 9
    with pytest.raises(ValueError, match="version 9"):
        tserde.deserialize_page(bytes(data))
    with pytest.raises(ValueError, match="magic"):
        tserde.deserialize_page(b"\0" * 16)


def test_nested_serde_roundtrip():
    """tests/test_arrays.py::test_nested_serde_roundtrip through the port,
    and the bytes equal the reference's."""
    at = TT.array_of(TT.VARCHAR)
    page = Page([column_to_device(column_data_from_python(at, [["x", "y"], None, []]), "cpu")])
    out = tserde.deserialize_page(tserde.serialize_page(page))
    assert out.columns[0].to_python() == [["x", "y"], None, []]
    assert out.columns[0].type == at
    jpage = JaxPage([JaxColumn.from_python(JT.array_of(JT.VARCHAR), [["x", "y"], None, []])])
    assert tserde.serialize_page(page) == jserde.serialize_page(jpage)


NESTED = {
    "array(bigint)": [[1, 2], None, [], [None, 5]],
    "map(varchar, double)": [{"a": 1.5}, {}, None, {"b": -0.0, "c": 2.0}],
    "row(a bigint, b varchar)": [(1, "x"), None, (None, None), (4, "y")],
    "array(decimal(38,2))": [[Decimal("1" * 30 + ".01")], [], None, [Decimal("-2.00")]],
}


@pytest.mark.parametrize("tname", list(NESTED))
def test_nested_bytes_equal_reference(tname):
    t, j = _both(tname, NESTED[tname])
    sel = np.array([True, False, True, True])
    tp, jp = Page([t], torch.from_numpy(sel)), JaxPage([j], jnp.asarray(sel))
    tb = tserde.serialize_page(tp)
    assert tb == jserde.serialize_page(jp.compact())
    assert tserde.deserialize_page(tb).to_pylist() == jp.to_pylist()
    assert jserde.deserialize_page(tb).to_pylist() == jp.to_pylist()


def test_reference_page_arrays_write_the_same_bytes():
    """A port page made from a reference page's arrays (``page_from_numpy``)
    writes the reference's bytes: the physical dtypes carry over."""
    cols = [JaxColumn.from_python(JT.parse_type(t), v) for t, v in FLAT.items()]
    jp = JaxPage(cols)
    tp = page_from_numpy(jp.columns, device="cpu")
    assert [str(c.values.numpy().dtype) for c in tp.columns] == \
        [str(np.asarray(c.values).dtype) for c in jp.columns]
    assert tserde.serialize_page(tp) == jserde.serialize_page(jp)


def test_client_value_decoders_equal_the_inline_protocol():
    """client/remote.py ``decode_pages`` over framed pages gives the rows
    the statement protocol's JSON carries, and the reference's segment
    decoder's rows for the same bytes."""
    from trino_tpu.client.remote import _decode_segment
    from trino_tpu_torch.client.remote import decode_pages
    from trino_tpu_torch.server import wire
    from trino_tpu_torch.server.coordinator import _jsonable

    cols = [_both(t, _nullify(FLAT[t]))[0] for t in FLAT]
    page = Page(cols)
    body = wire.frame_pages([tserde.serialize_page(page.slice_rows(0, 120)),
                             tserde.serialize_page(page.slice_rows(120, N))])
    want = [[_jsonable(v) for v in row] for row in page.to_pylist()]
    assert decode_pages(body) == want
    assert _decode_segment(body) == want


def test_serde_counters_move():
    from trino_tpu_torch.obs import metrics as M

    tp, _ = _pages("varchar", False)
    b0 = M.SERDE_BYTES.value("encode", "logical")
    s0 = M.SERDE_SECONDS.value("decode")
    tserde.deserialize_page(tserde.serialize_page(tp))
    assert M.SERDE_BYTES.value("encode", "logical") > b0
    assert M.SERDE_SECONDS.value("decode") > s0


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_device_page_round_trip_on_the_card():
    tp, jp = _pages("decimal(38,2)", True, _RNG.random(N) < 0.5)
    dev = Page([column_to_device(c, "cuda") for c in tp.columns], tp.sel.cuda())
    tb = tserde.serialize_page(dev)
    assert tb == jserde.serialize_page(jp.compact())
    back = tserde.deserialize_page(tb, "cuda")
    assert back.columns[0].values.is_cuda
    assert back.to_pylist() == jp.to_pylist()
