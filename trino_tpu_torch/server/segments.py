"""Spooled result segments: the data plane of the spooled client protocol.

A copy of trino_tpu/server/segments.py. Segment files hold the serde's
frames, so the reference's ``deserialize_page`` reads the port's segments
and the port's reads the reference's. Reference: Trino 455's spooled client protocol (the same segment
mechanism the FTE exchange uses for spooling task outputs) — large
results are written as durable, size-bounded SEGMENTS by the process
that produced them (a worker for the root fragment's output, the
coordinator for coordinator-local/fast-path queries), the statement
response carries a segment MANIFEST (`{uri, rows, bytes, codec}`), and
clients fetch the segments directly, in parallel, off the statement
protocol. The coordinator leaves the data path entirely for the
worker-direct shape.

Lifecycle (mirror of the exchange ``_cleanup_spool`` contract):

- a segment is deleted on client ACK (``DELETE /v1/segment/{id}``) —
  the normal path;
- un-acked segments expire by TTL (``result_segment_ttl_ms``), swept
  opportunistically (worker announce loop / coordinator submit);
- a server start sweeps ORPHANED segment files left in a shared spool
  directory by dead processes — a file's mtime is stamped with its
  EXPIRY at write, so only segments whose own TTL has passed are ever
  touched;
- every reclaimed byte is counted, by reason (ack | ttl | orphan).

Segment ids are unguessable capabilities (``{query_id}.s{n}-{token}``):
the segment endpoints are served without the cluster-internal HMAC so
plain protocol clients can fetch them — the reference's pre-signed
segment URI model.
"""
from __future__ import annotations

import dataclasses
import os
import secrets
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.obs import metrics as M
from trino_tpu_torch.obs.flowledger import FLOW_LEDGER

# default lifetime of an un-acked segment; the per-query
# ``result_segment_ttl_ms`` session property overrides per segment
DEFAULT_TTL_S = 300.0
# default target serialized bytes per segment
# (``spooled_results_segment_bytes`` overrides)
DEFAULT_SEGMENT_BYTES = 8 << 20

_SEGMENT_SUFFIX = ".seg"


@dataclasses.dataclass
class SegmentMeta:
    """One registered segment: identity + manifest fields + expiry."""

    segment_id: str
    query_id: str
    path: str
    rows: int
    bytes: int
    codec: str
    expires_at: float

    def manifest_entry(self) -> dict:
        """The fields a statement-response manifest carries (uri/ackUri
        are added by the coordinator, which knows the serving URLs)."""
        return {"id": self.segment_id, "rows": self.rows,
                "bytes": self.bytes, "codec": self.codec}


class SegmentStore:
    """Durable result segments served by one process.

    Backed by a directory: the cluster-shared spool (``TRINO_TPU_SPOOL_DIR``,
    under ``result-segments/``) when configured — the same "object storage"
    the FTE exchange spools to — else a per-process temp directory."""

    def __init__(self, node_id: str = "node",
                 base_dir: Optional[str] = None,
                 default_ttl_s: float = DEFAULT_TTL_S):
        from trino_tpu_torch.server.task import spool_directory

        self.node_id = node_id
        self.default_ttl_s = float(default_ttl_s)
        if base_dir is None:
            spool = spool_directory()
            base_dir = (os.path.join(spool, "result-segments") if spool
                        else tempfile.mkdtemp(prefix="trino-tpu-segments-"))
        self.base_dir = base_dir
        self._segments: Dict[str, SegmentMeta] = {}
        self._lock = threading.Lock()
        self._last_sweep = time.monotonic()
        self.orphans_reclaimed_bytes = self._sweep_orphans()

    # ------------------------------------------------------------- writing
    def writer(self, query_id: str,
               target_bytes: int = DEFAULT_SEGMENT_BYTES,
               ttl_s: Optional[float] = None) -> "SegmentWriter":
        return SegmentWriter(self, query_id, target_bytes,
                             self.default_ttl_s if ttl_s is None else ttl_s)

    def _register(self, query_id: str, seq: int, frames: List[bytes],
                  rows: int, ttl_s: float) -> SegmentMeta:
        """Write one segment file (frames are length-prefixed serialized
        pages, the exchange wire framing) and register it for serving."""
        import struct

        segment_id = f"{query_id}.s{seq}-{secrets.token_hex(8)}"
        os.makedirs(self.base_dir, exist_ok=True)
        path = os.path.join(self.base_dir, segment_id + _SEGMENT_SUFFIX)
        tmp = path + ".tmp"
        nbytes = 0
        t0 = time.perf_counter()
        with open(tmp, "wb") as f:
            for frame in frames:
                f.write(struct.pack("<I", len(frame)))
                f.write(frame)
                nbytes += 4 + len(frame)
        os.replace(tmp, path)  # atomic publish, like the exchange spool
        FLOW_LEDGER.record_transfer(
            "spool-write", f"query:{query_id}", nbytes,
            time.perf_counter() - t0, pages=len(frames),
            src=FLOW_LEDGER.node_id or None, dst="segment-store",
            direction="send")
        expires_at = time.time() + ttl_s
        # the file's mtime IS its expiry: another server's boot-time
        # orphan sweep over a shared spool dir can then never reclaim a
        # live segment, whatever per-query TTL it was written with
        try:
            os.utime(path, (expires_at, expires_at))
        except OSError:
            pass
        meta = SegmentMeta(segment_id, query_id, path, int(rows), nbytes,
                           "pages", expires_at)
        with self._lock:
            self._segments[segment_id] = meta
        M.RESULT_SEGMENTS_WRITTEN.inc()
        M.RESULT_SEGMENT_BYTES.inc(nbytes, "written")
        return meta

    # ------------------------------------------------------------- serving
    def get(self, segment_id: str) -> Optional[SegmentMeta]:
        with self._lock:
            return self._segments.get(segment_id)

    def read(self, segment_id: str, start: int = 0,
             length: Optional[int] = None) -> Optional[bytes]:
        """Segment bytes (or a range of them); None when unknown/gone."""
        meta = self.get(segment_id)
        if meta is None:
            return None
        t0 = time.perf_counter()
        try:
            with open(meta.path, "rb") as f:
                if start:
                    f.seek(start)
                data = f.read() if length is None else f.read(length)
        except OSError:
            return None
        M.RESULT_SEGMENT_BYTES.inc(len(data), "served")
        FLOW_LEDGER.record_transfer(
            "segment-fetch", f"query:{meta.query_id}", len(data),
            time.perf_counter() - t0, src="segment-store",
            dst=FLOW_LEDGER.node_id or None, direction="send",
            status="range" if (start or length is not None) else "full")
        return data

    def ack(self, segment_id: str) -> bool:
        """Client ack: the segment was fetched — delete it now instead of
        waiting out the TTL. Idempotent."""
        return self._drop(segment_id, "ack")

    def discard(self, segment_id: str) -> bool:
        """Producer-side early drop (failed attempt, EXPLAIN ANALYZE's
        inner query): nobody will ever fetch this segment. Counted under
        the ``ttl`` reclaim reason — same 'never acked' meaning, just
        sooner — so the ack series stays a pure client-fetch signal."""
        return self._drop(segment_id, "ttl")

    def _drop(self, segment_id: str, reason: str) -> bool:
        with self._lock:
            meta = self._segments.pop(segment_id, None)
        if meta is None:
            return False
        self._reclaim(meta, reason)
        return True

    # ------------------------------------------------------------ lifecycle
    SWEEP_INTERVAL_S = 10.0

    def maybe_sweep(self) -> int:
        """Opportunistic TTL sweep (rate-limited): callers on periodic
        paths (announce loop, submit) invoke this instead of timing their
        own sweeps."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_sweep < self.SWEEP_INTERVAL_S:
                return 0
            self._last_sweep = now
        return self.sweep()

    def sweep(self) -> int:
        """Drop every expired segment; returns reclaimed bytes."""
        now = time.time()
        with self._lock:
            expired = [m for m in self._segments.values()
                       if m.expires_at <= now]
            for m in expired:
                del self._segments[m.segment_id]
        reclaimed = 0
        for m in expired:
            reclaimed += self._reclaim(m, "ttl")
        return reclaimed

    def drop_query(self, query_id: str) -> int:
        """Drop a query's segments early (FAILED/CANCELED: no client will
        ever fetch them). Counted as TTL reclaims — same 'nobody acked'
        meaning, just sooner."""
        with self._lock:
            doomed = [m for m in self._segments.values()
                      if m.query_id == query_id]
            for m in doomed:
                del self._segments[m.segment_id]
        return sum(self._reclaim(m, "ttl") for m in doomed)

    def _reclaim(self, meta: SegmentMeta, reason: str) -> int:
        try:
            os.remove(meta.path)
        except OSError:
            pass
        M.RESULT_SEGMENTS_RECLAIMED.inc(1, reason)
        M.RESULT_SEGMENT_RECLAIMED_BYTES.inc(meta.bytes, reason)
        return meta.bytes

    # clock-skew slack for cross-server expiry comparisons in a shared
    # spool directory
    ORPHAN_GRACE_S = 60.0

    def _sweep_orphans(self) -> int:
        """Server-start sweep of segment files left behind by dead
        processes (the exchange ``_cleanup_spool`` contract, applied at
        boot). A segment file's mtime is its EXPIRY (stamped at write),
        so only files whose own TTL has passed are touched — a shared
        spool directory's LIVE segments, owned by other running servers,
        are never reclaimed out from under them, whatever per-query TTL
        they carry."""
        reclaimed = 0
        try:
            names = os.listdir(self.base_dir)
        except OSError:
            return 0
        cutoff = time.time() - self.ORPHAN_GRACE_S
        for name in names:
            if not name.endswith(_SEGMENT_SUFFIX):
                continue
            path = os.path.join(self.base_dir, name)
            try:
                st = os.stat(path)
                if st.st_mtime > cutoff:
                    continue
                os.remove(path)
            except OSError:
                continue
            reclaimed += st.st_size
            M.RESULT_SEGMENTS_RECLAIMED.inc(1, "orphan")
            M.RESULT_SEGMENT_RECLAIMED_BYTES.inc(st.st_size, "orphan")
        return reclaimed

    def close(self) -> None:
        """Server stop: delete every segment this store still holds (a
        stopped server cannot serve them; shared spool dirs must not
        accumulate until someone else's orphan sweep)."""
        with self._lock:
            metas, self._segments = list(self._segments.values()), {}
        for m in metas:
            try:
                os.remove(m.path)
            except OSError:
                pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._segments)

    def held_bytes(self) -> int:
        with self._lock:
            return sum(m.bytes for m in self._segments.values())


class SegmentWriter:
    """Accumulates serialized page frames for one query and rolls a new
    size-bounded segment whenever the target is reached — the producer
    half of the spooled protocol (size-bounded segments are what make
    client-side PARALLEL fetch worth anything)."""

    def __init__(self, store: SegmentStore, query_id: str,
                 target_bytes: int, ttl_s: float):
        self._store = store
        self._query_id = query_id
        self._target = max(1, int(target_bytes))
        self._ttl_s = float(ttl_s)
        self._frames: List[bytes] = []
        self._frame_rows = 0
        self._bytes = 0
        self._seq = 0
        self._metas: List[SegmentMeta] = []

    def add(self, frame: bytes, rows: int) -> None:
        self._frames.append(frame)
        self._frame_rows += int(rows)
        self._bytes += len(frame)
        if self._bytes >= self._target:
            self._roll()

    def _roll(self) -> None:
        if not self._frames:
            return
        self._metas.append(self._store._register(
            self._query_id, self._seq, self._frames, self._frame_rows,
            self._ttl_s))
        self._seq += 1
        self._frames, self._frame_rows, self._bytes = [], 0, 0

    def finish(self) -> List[SegmentMeta]:
        self._roll()
        return list(self._metas)

    @property
    def segment_count(self) -> int:
        return self._seq

    def abandon(self) -> None:
        """Producer failed: drop everything already rolled (nobody will
        ever receive a manifest pointing at these)."""
        self._frames, self._frame_rows, self._bytes = [], 0, 0
        for m in self._metas:
            self._store.discard(m.segment_id)
        self._metas = []


# --------------------------------------------------------- HTTP plumbing
_RANGE_ERR = (416, b'{"error": "unsatisfiable range"}',
              {}, "application/json")


def parse_range(header: Optional[str], total: int
                ) -> Optional[Tuple[int, int]]:
    """``Range: bytes=a-b`` -> (start, length), or None for a full read.
    Raises ValueError on a malformed/unsatisfiable range."""
    if not header:
        return None
    h = header.strip().lower()
    if not h.startswith("bytes="):
        raise ValueError(f"unsupported range unit: {header}")
    spec = h[len("bytes="):]
    start_s, _, end_s = spec.partition("-")
    if start_s == "":  # suffix form: bytes=-N (last N bytes)
        n = int(end_s)
        if n <= 0:
            raise ValueError("empty suffix range")
        start = max(0, total - n)
        return start, total - start
    start = int(start_s)
    end = int(end_s) if end_s else total - 1
    if start >= total or end < start:
        raise ValueError(f"range {header} outside 0..{total - 1}")
    return start, min(end, total - 1) - start + 1


def segment_response(store: SegmentStore, segment_id: str,
                     range_header: Optional[str] = None):
    """Shared GET handler body for the coordinator and worker
    ``/v1/segment/{id}`` routes: returns ``(status, body, headers,
    content_type)``. Range semantics: a ``Range: bytes=a-b`` header gets
    a 206 slice + ``Content-Range`` (clients resume a cut-off fetch
    without re-pulling the prefix)."""
    from trino_tpu_torch.server import wire

    meta = store.get(segment_id)
    if meta is None:
        return 404, b'{"error": "no such segment"}', {}, "application/json"
    try:
        rng = parse_range(range_header, meta.bytes)
    except ValueError:
        return _RANGE_ERR
    if rng is None:
        data = store.read(segment_id)
        if data is None:
            return (404, b'{"error": "segment file gone"}', {},
                    "application/json")
        headers = {"X-Segment-Rows": str(meta.rows),
                   "X-Segment-Bytes": str(meta.bytes)}
        return 200, data, headers, wire.MEDIA_PAGES
    start, length = rng
    data = store.read(segment_id, start, length)
    if data is None:
        return 404, b'{"error": "segment file gone"}', {}, "application/json"
    headers = {
        "X-Segment-Rows": str(meta.rows),
        "X-Segment-Bytes": str(meta.bytes),
        "Content-Range":
            f"bytes {start}-{start + len(data) - 1}/{meta.bytes}",
    }
    return 206, data, headers, wire.MEDIA_PAGES
