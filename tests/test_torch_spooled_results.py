"""The port's spooled result protocol (trino_tpu_torch/server/segments.py,
the result-segment writer of server/task.py, the coordinator's spool paths
and ``/v1/segment`` routes, client/remote.py's segment fetch) held against
the JAX package's: the 15 cases of the reference's
tests/test_spooled_results.py that are not marked slow
(``test_results_bench_check`` is a gate of the JAX package's bench and
stays there).

- The serde tier builds one page from the same numpy arrays in both
  packages: the port's bytes equal the reference's, and each package
  decodes the other's (a segment file is framed serde pages).
- The segment-store tier runs the same writes, reads, ranges, acks and
  sweeps through both packages' stores: equal manifests, equal file bytes.
- The cluster tier runs each case on a port CPU cluster and a JAX CPU
  cluster (two workers each) with the same SQL and session properties:
  equal rows (exact, after the protocol's JSON values), the same spool
  mode, every segment acked and reclaimed; the port's segment bodies read
  back through the reference's ``deserialize_page`` and
  ``wire.unframe_pages``, and the reference's through the port's.
"""
import os
import struct
import sys
import time
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import trino_tpu  # noqa: E402,F401  (turns on JAX x64 first)
import jax.numpy as jnp  # noqa: E402
from trino_tpu import types as JT  # noqa: E402
from trino_tpu.client import remote as jremote  # noqa: E402
from trino_tpu.data import serde as jserde  # noqa: E402
from trino_tpu.data.dictionary import Dictionary as JDictionary  # noqa: E402
from trino_tpu.data.page import Column as JColumn  # noqa: E402
from trino_tpu.data.page import Page as JPage  # noqa: E402
from trino_tpu.server import segments as jsegments  # noqa: E402
from trino_tpu.server import wire as jwire  # noqa: E402

from torch_obs_common import BOTH, TINY, stop_cluster  # noqa: E402
from torch_obs_common import start_cluster as start_pkg_cluster  # noqa: E402

from trino_tpu_torch import types as TT  # noqa: E402
from trino_tpu_torch.client import dbapi  # noqa: E402
from trino_tpu_torch.client import remote as tremote  # noqa: E402
from trino_tpu_torch.data import serde as tserde  # noqa: E402
from trino_tpu_torch.data.dictionary import Dictionary as TDictionary  # noqa: E402
from trino_tpu_torch.data.page import Column as TColumn  # noqa: E402
from trino_tpu_torch.data.page import Page as TPage  # noqa: E402
from trino_tpu_torch.obs import metrics as M  # noqa: E402
from trino_tpu_torch.server import segments as tsegments  # noqa: E402
from trino_tpu_torch.server import wire  # noqa: E402


# ----------------------------------------------------------- serde tier
def _segment_scale_arrays(n=50_000):
    """Every encoding the segment path carries: a dictionary varchar with
    NULLs, a two-limb long decimal, and an incompressible double."""
    rng = np.random.default_rng(7)
    vocab = [f"name-{i}" for i in range(257)]
    return {
        "ids": np.arange(n, dtype=np.int64),
        "vocab": vocab,
        "codes": rng.integers(0, len(vocab), n).astype(np.int32),
        "nulls": rng.random(n) < 0.1,
        "lo": rng.integers(-(10 ** 12), 10 ** 12, n).astype(np.int64),
        "hi": rng.integers(-5, 5, n).astype(np.int64),
        "entropy": rng.standard_normal(n),
    }


def _pages(n=50_000):
    """(port page, reference page) of the same arrays."""
    a = _segment_scale_arrays(n)
    tp = TPage([
        TColumn(TT.parse_type("bigint"), torch.from_numpy(a["ids"])),
        TColumn(TT.parse_type("varchar"), torch.from_numpy(a["codes"]),
                torch.from_numpy(a["nulls"]), TDictionary(a["vocab"])),
        TColumn(TT.parse_type("decimal(30,2)"), torch.from_numpy(a["lo"]),
                hi=torch.from_numpy(a["hi"])),
        TColumn(TT.parse_type("double"), torch.from_numpy(a["entropy"])),
    ], None)
    jp = JPage([
        JColumn(JT.parse_type("bigint"), jnp.asarray(a["ids"])),
        JColumn(JT.parse_type("varchar"), jnp.asarray(a["codes"]), jnp.asarray(a["nulls"]),
                JDictionary(a["vocab"])),
        JColumn(JT.parse_type("decimal(30,2)"), jnp.asarray(a["lo"]), hi=jnp.asarray(a["hi"])),
        JColumn(JT.parse_type("double"), jnp.asarray(a["entropy"])),
    ])
    return tp, jp


def _pages_equal(a, b):
    """Two pages (of either package) with equal arrays and vocabularies."""
    assert a.num_rows == b.num_rows and len(a.columns) == len(b.columns)
    for ca, cb in zip(a.columns, b.columns):
        np.testing.assert_array_equal(np.asarray(ca.values), np.asarray(cb.values))
        assert (ca.hi is None) == (cb.hi is None) and (ca.nulls is None) == (cb.nulls is None)
        if ca.hi is not None:
            np.testing.assert_array_equal(np.asarray(ca.hi), np.asarray(cb.hi))
        if ca.nulls is not None:
            np.testing.assert_array_equal(np.asarray(ca.nulls), np.asarray(cb.nulls))
        if ca.dictionary is not None:
            assert list(ca.dictionary.values) == list(cb.dictionary.values)


def test_serde_segment_scale_roundtrip():
    tp, jp = _pages()
    blob = tserde.serialize_page(tp)
    assert blob == jserde.serialize_page(jp)
    _pages_equal(tp, tserde.deserialize_page(blob))
    # each package reads the other's bytes
    _pages_equal(tp, jserde.deserialize_page(blob))
    _pages_equal(jp, tserde.deserialize_page(jserde.serialize_page(jp)))


def test_serde_incompressible_column_stores_raw():
    """Entropy stores raw (block codec NONE), a constant column compresses,
    the codec counters move, and the bytes equal the reference's."""
    rng = np.random.default_rng(3)
    ints = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 20_000, dtype=np.int64)
    raw0 = M.SERDE_BYTES.value("encode", "none")
    zlib0 = M.SERDE_BYTES.value("encode", "zlib")
    blob = tserde.serialize_page(TPage([TColumn(TT.parse_type("bigint"),
                                                torch.from_numpy(ints))], None))
    assert M.SERDE_BYTES.value("encode", "none") > raw0
    assert blob == jserde.serialize_page(JPage([JColumn(JT.parse_type("bigint"),
                                                        jnp.asarray(ints))]))
    magic, version, _codec, ncols, _nrows = struct.unpack_from("<IBBHI", blob, 0)
    assert (magic, version, ncols) == (tserde.MAGIC, 3, 1)
    block_codec, _len = struct.unpack_from("<BI", blob, 12)
    assert block_codec == tserde.CODEC_NONE
    np.testing.assert_array_equal(np.asarray(tserde.deserialize_page(blob).columns[0].values),
                                  ints)
    zeros = np.zeros(20_000, np.int64)
    blob2 = tserde.serialize_page(TPage([TColumn(TT.parse_type("bigint"),
                                                 torch.from_numpy(zeros))], None))
    assert M.SERDE_BYTES.value("encode", "zlib") > zlib0
    block_codec2, block_len2 = struct.unpack_from("<BI", blob2, 12)
    assert block_codec2 == tserde.CODEC_ZLIB and block_len2 < 20_000 * 8
    assert blob2 == jserde.serialize_page(JPage([JColumn(JT.parse_type("bigint"),
                                                         jnp.asarray(zeros))]))


def test_serde_reads_legacy_v2_frames():
    """Spool files of the previous whole-body zlib format still decode, in
    both packages, and the two packages' v2 bodies are the same bytes."""
    tp, jp = _pages(5_000)
    tparts, jparts = [], []
    for col in tp.columns:
        tserde._serialize_column(col, tparts)
    for col in jp.columns:
        jserde._serialize_column(col, jp.num_rows, jparts)
    assert b"".join(tparts) == b"".join(jparts)
    v2 = struct.pack("<IBBHI", tserde.MAGIC, 2, tserde.CODEC_ZLIB, len(tp.columns),
                     tp.num_rows) + zlib.compress(b"".join(tparts), 1)
    _pages_equal(tp, tserde.deserialize_page(v2))
    _pages_equal(jp, jserde.deserialize_page(v2))


# ---------------------------------------------------- segment store tier
STORES = (("torch", tsegments), ("jax", jsegments))


def test_segment_store_write_read_range_ack(tmp_path):
    out = {}
    for name, seg in STORES:
        store = seg.SegmentStore(base_dir=str(tmp_path / name))
        w = store.writer("q1", target_bytes=80, ttl_s=60.0)
        w.add(b"a" * 80, 10)  # reaches the target: rolls segment 0
        w.add(b"b" * 30, 5)   # partial: rolled by finish()
        metas = w.finish()
        sid = metas[0].segment_id
        full = store.read(sid)
        assert full == struct.pack("<I", 80) + b"a" * 80
        assert seg.parse_range("bytes=0-3", 100) == (0, 4)
        assert seg.parse_range("bytes=-10", 100) == (90, 10)
        with pytest.raises(ValueError):
            seg.parse_range("bytes=200-", 100)
        part = store.read(sid, 4, 8)
        files = sorted(open(m.path, "rb").read() for m in metas)
        assert store.ack(sid) and not store.ack(sid)
        out[name] = ([(m.rows, m.bytes, m.codec, m.query_id) for m in metas], full, part, files,
                     store.read(sid), os.path.exists(metas[0].path), len(store))
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [(10, 84, "pages", "q1"), (5, 34, "pages", "q1")]
    assert out["torch"][4:] == (None, False, 1)
    # the port's ack counts in the port's registry
    acked0 = M.RESULT_SEGMENTS_RECLAIMED.value("ack")
    store = tsegments.SegmentStore(base_dir=str(tmp_path / "count"))
    w = store.writer("q1", target_bytes=1, ttl_s=60.0)
    w.add(b"z", 1)
    (meta,) = w.finish()
    assert store.ack(meta.segment_id)
    assert M.RESULT_SEGMENTS_RECLAIMED.value("ack") == acked0 + 1


def test_segment_store_ttl_and_orphan_sweep(tmp_path):
    out = {}
    for name, seg in STORES:
        base = tmp_path / name
        store = seg.SegmentStore(base_dir=str(base), default_ttl_s=60.0)
        w = store.writer("q2", target_bytes=1 << 20, ttl_s=0.05)
        w.add(b"x" * 100, 1)
        (meta,) = w.finish()
        ttl_bytes0 = seg.M.RESULT_SEGMENT_RECLAIMED_BYTES.value("ttl")
        time.sleep(0.06)
        reclaimed = store.sweep()
        assert reclaimed == meta.bytes and len(store) == 0 and not os.path.exists(meta.path)
        assert seg.M.RESULT_SEGMENT_RECLAIMED_BYTES.value("ttl") == ttl_bytes0 + meta.bytes
        # a stale file of a dead process goes at the next store's start; a
        # live one (its mtime is its expiry, in the future) stays
        stale = base / "deadq.s0-ff.seg"
        stale.write_bytes(b"z" * 64)
        os.utime(stale, (time.time() - 3600, time.time() - 3600))
        live = base / "liveq.s0-aa.seg"
        live.write_bytes(b"y" * 64)
        os.utime(live, (time.time() + 1800, time.time() + 1800))
        store2 = seg.SegmentStore(base_dir=str(base), default_ttl_s=60.0)
        out[name] = (reclaimed, store2.orphans_reclaimed_bytes, stale.exists(), live.exists())
    assert out["torch"] == out["jax"] == (104, 64, False, True)


def test_segment_writer_abandon(tmp_path):
    for name, seg in STORES:
        store = seg.SegmentStore(base_dir=str(tmp_path / name))
        w = store.writer("q3", target_bytes=10, ttl_s=60.0)
        w.add(b"p" * 50, 3)
        assert len(store) == 1
        w.abandon()
        assert len(store) == 0 and w.finish() == [] and os.listdir(tmp_path / name) == []


# -------------------------------------------------------- cluster tier
EXPORT_SQL = "select o_orderkey, o_custkey, o_totalprice, o_orderdate from orders"
SORTED_SQL = EXPORT_SQL + " order by o_orderkey"

SPOOL_PROPS = {
    "spooled_results_enabled": "true",
    "spooled_results_threshold_bytes": "1024",
    "spooled_results_segment_bytes": "65536",
}
PKGS = {pkg.name: pkg for pkg in BOTH}


@pytest.fixture(scope="module")
def clusters():
    started = {}
    try:
        for pkg in BOTH:
            started[pkg.name] = start_pkg_cluster(pkg, f"spool-{pkg.name}-")
        yield {name: (c, ws) for name, (c, ws) in started.items()}
    finally:
        for coord, ws in started.values():
            stop_cluster(coord, ws)


def _dbapi(name):
    if name == "torch":
        return dbapi
    from trino_tpu.client import dbapi as jdbapi

    return jdbapi


@pytest.fixture(scope="module")
def inline_rows(clusters):
    """The sorted export through the inline protocol, per package; the two
    packages' rows are equal."""
    out = {}
    for name, (coord, _ws) in clusters.items():
        cur = _dbapi(name).connect(coordinator_url=coord.base_url).cursor()
        cur.execute(SORTED_SQL)
        out[name] = cur.fetchall()
    assert out["torch"] == out["jax"] and len(out["torch"]) == 15000
    return out


def _client(name, coord, props=None, **kw):
    return PKGS[name].remote.StatementClient(coord.base_url, {**TINY, **(props or {})}, **kw)


def _wait_released(workers, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(len(w.segments) for w in workers):
        time.sleep(0.05)
    return [len(w.segments) for w in workers]


def test_worker_direct_spool_row_equality(clusters, inline_rows):
    """The export shape: the workers write the segments, the manifest's
    URIs are the workers', the ack URIs the coordinator's, the parallel
    fetch gives the inline rows, and the acks reclaim every segment."""
    out = {}
    for name, (coord, workers) in clusters.items():
        client = _client(name, coord, SPOOL_PROPS, fetch_streams=4)
        _cols, rows = client.execute(EXPORT_SQL, timeout=120.0)
        assert client.stats["spooled"] == "worker-direct"
        assert client.spooled_segments >= 2
        assert sorted(tuple(r) for r in rows) == [tuple(r) for r in inline_rows[name]]
        q = coord.get_query(client.query_id)
        urls = {w.base_url for w in workers}
        for entry in q.result_segments:
            assert any(entry["uri"].startswith(u) for u in urls)
            assert entry["ackUri"].startswith(coord.base_url)
        assert len(coord.segments) == 0
        assert _wait_released(workers) == [0, 0]
        info = PKGS[name].wire.json_request("GET", f"{coord.base_url}/v1/query/{client.query_id}")
        tl = info["queryStats"]["timeline"]
        assert tl["phases"]["segment-fetch"] >= 0.0 and tl["coverage"] >= 0.95
        out[name] = (sorted(tuple(r) for r in rows), client.stats["resultRows"],
                     sum(e["rows"] for e in q.result_segments))
    assert out["torch"] == out["jax"]


def test_coordinator_spool_preserves_order(clusters, inline_rows):
    """ORDER BY at the root: the coordinator spools from its own store, and
    a fetch of 1 stream and of 4 keeps the inline order."""
    for name, (coord, _ws) in clusters.items():
        for streams in (1, 4):
            client = _client(name, coord, SPOOL_PROPS, fetch_streams=streams)
            _cols, rows = client.execute(SORTED_SQL, timeout=120.0)
            assert client.stats["spooled"] == "coordinator"
            assert [tuple(r) for r in rows] == [tuple(r) for r in inline_rows[name]]
            assert len(coord.segments) == 0  # acked


def test_fast_path_and_prepared_spool(clusters, inline_rows):
    """The short-query fast path and a prepared EXECUTE spool too, with the
    inline rows."""
    for name, (coord, _ws) in clusters.items():
        cur = _dbapi(name).connect(coordinator_url=coord.base_url,
                                   short_query_fast_path="true", **SPOOL_PROPS).cursor()
        cur.execute(SORTED_SQL)
        assert cur.stats["spooled"] == "coordinator"
        assert cur.stats["fastPath"] == "fast-path"
        assert cur.fetchall() == inline_rows[name]
        cur.execute(SORTED_SQL.replace("order by", "where o_orderkey > ? order by"), (0,))
        assert cur.stats["spooled"] is not None
        assert cur.fetchall() == inline_rows[name]


def test_local_catalog_spool(clusters):
    """A process-local catalog's query spools from the coordinator's store,
    with the inline rows."""
    sql = "select node_id, http_uri, state from system.runtime.nodes order by node_id"
    counts = {}
    for name, (coord, _ws) in clusters.items():
        base = _dbapi(name).connect(coordinator_url=coord.base_url, catalog="system").cursor()
        base.execute(sql)
        inline = base.fetchall()
        cur = _dbapi(name).connect(coordinator_url=coord.base_url, catalog="system",
                                   spooled_results_enabled="true",
                                   spooled_results_threshold_bytes="1").cursor()
        cur.execute(sql)
        assert cur.stats["spooled"] == "coordinator"
        assert cur.fetchall() == inline
        counts[name] = (len(inline), [r[2] for r in inline])
    assert counts["torch"] == counts["jax"]


def test_segment_fetch_retries_once_on_transient_failure(clusters, inline_rows, monkeypatch):
    for name, (coord, _ws) in clusters.items():
        w = PKGS[name].wire
        orig = w.http_request
        fails = {"n": 0}

        def flaky(method, url, *a, _orig=orig, _fails=fails, **k):
            if method == "GET" and "/v1/segment/" in url and _fails["n"] == 0:
                _fails["n"] += 1
                raise ConnectionError("injected transient segment failure")
            return _orig(method, url, *a, **k)

        monkeypatch.setattr(w, "http_request", flaky)
        try:
            _cols, rows = _client(name, coord, SPOOL_PROPS).execute(SORTED_SQL, timeout=120.0)
        finally:
            monkeypatch.setattr(w, "http_request", orig)
        assert fails["n"] == 1
        assert [tuple(r) for r in rows] == [tuple(r) for r in inline_rows[name]]


def _finished(coord, sql, props):
    q = coord.submit(sql, dict(props, catalog="tpch", schema="tiny"))
    deadline = time.monotonic() + 60.0
    while not q.state.is_terminal() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert q.state.get() == "FINISHED", q.failure
    assert q.result_segments
    return q


def test_missing_and_truncated_segment_raise_typed(clusters):
    """A segment truncated on disk, or acked away before the fetch, fails
    with the typed SegmentFetchError after the one retry."""
    for name, (coord, _ws) in clusters.items():
        remote = PKGS[name].remote
        q = _finished(coord, SORTED_SQL, SPOOL_PROPS)
        client = remote.StatementClient(coord.base_url)
        first = q.result_segments[0]
        with open(coord.segments.get(first["id"]).path, "wb") as f:
            f.write(b"\x00" * 16)
        with pytest.raises(remote.SegmentFetchError) as err:
            client._fetch_one_segment(first)
        assert err.value.segment_id == first["id"]
        gone = q.result_segments[-1]
        coord.segments.ack(gone["id"])
        with pytest.raises(remote.SegmentFetchError):
            client._fetch_one_segment(gone)
        for e in q.result_segments:
            coord.segments.ack(e["id"])


def test_inline_result_memory_guard(clusters, inline_rows):
    """Over inline_result_max_bytes: a loud failure with the protocol off
    (the export shape's during the gather), a spool with it on."""
    for name, (coord, _ws) in clusters.items():
        mod = _dbapi(name)
        metric = PKGS[name].M.INLINE_RESULT_REJECTIONS
        rejected0 = metric.value()
        cur = mod.connect(coordinator_url=coord.base_url, inline_result_max_bytes="2000").cursor()
        with pytest.raises(mod.DatabaseError, match="INLINE_RESULT_TOO_LARGE"):
            cur.execute(SORTED_SQL)
        assert metric.value() == rejected0 + 1
        with pytest.raises(mod.DatabaseError, match="while pulling the root fragment"):
            cur.execute(EXPORT_SQL)
        assert metric.value() == rejected0 + 2
        cur2 = mod.connect(coordinator_url=coord.base_url, inline_result_max_bytes="2000",
                           spooled_results_enabled="true",
                           spooled_results_threshold_bytes="1073741824").cursor()
        cur2.execute(SORTED_SQL)
        assert cur2.stats["spooled"] == "coordinator"
        assert cur2.fetchall() == inline_rows[name]


def test_small_results_stay_inline(clusters):
    for name, (coord, _ws) in clusters.items():
        cur = _dbapi(name).connect(coordinator_url=coord.base_url,
                                   spooled_results_enabled="true",
                                   spooled_results_threshold_bytes="1073741824").cursor()
        cur.execute("select o_orderkey from orders where o_orderkey = 7")
        assert cur.stats["spooled"] is None
        assert cur.fetchall() == [(7,)]


def test_segment_http_range_fetch(clusters):
    """GET /v1/segment/{id} with Range: 206 and Content-Range; a range past
    the end 416; an unknown id 404. The port's segment bytes decode through
    the reference's frames and serde to the same rows, and the reference's
    through the port's."""
    bodies = {}
    for name, (coord, _ws) in clusters.items():
        w = PKGS[name].wire
        q = _finished(coord, SORTED_SQL, SPOOL_PROPS)
        seg = q.result_segments[0]
        status, full, headers = w.http_request("GET", seg["uri"])
        assert status == 200 and len(full) == seg["bytes"]
        assert headers.get("X-Segment-Rows") == str(seg["rows"])
        status, part, headers = w.http_request("GET", seg["uri"], headers={"Range": "bytes=4-11"})
        assert status == 206 and part == full[4:12]
        assert headers.get("Content-Range") == f"bytes 4-11/{seg['bytes']}"
        status, _b, _h = w.http_request("GET", seg["uri"],
                                        headers={"Range": f"bytes={seg['bytes']}-"})
        assert status == 416
        status, _b, _h = w.http_request("GET", f"{coord.base_url}/v1/segment/nosuch.s0-00")
        assert status == 404
        bodies[name] = (full, seg["rows"])
        for e in q.result_segments:
            coord.segments.ack(e["id"])
    assert bodies["torch"][0] == bodies["jax"][0]
    for name, (body, rows) in bodies.items():
        want = tremote._decode_segment(body, rows)
        assert jremote._decode_segment(body, rows) == want
        frames = jwire.unframe_pages(body)
        assert frames == wire.unframe_pages(body)
        for fb in frames:
            _pages_equal(jserde.deserialize_page(fb), tserde.deserialize_page(fb))
