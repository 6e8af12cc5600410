"""Remote statement client: the REST protocol consumer.

The port of trino_tpu/client/remote.py (reference:
``client/trino-client/.../StatementClientV1.java:70``): submit with
``POST /v1/statement``, then follow ``nextUri`` until the query is
terminal, gathering the result pages; SET/RESET SESSION and
PREPARE/DEALLOCATE round-trip into the client's later requests, and the
``X-Trino-Tpu-Cache`` header gives the result-cache disposition. The value
decoders turn framed serde pages into the inline protocol's JSON values.
A coordinator answering with a spooled segment manifest is refused: the
spooled result protocol is not ported.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from trino_tpu_torch.server import wire


class RemoteQueryError(RuntimeError):
    pass


class StatementClient:
    """Submit one statement at a time and gather its results."""

    def __init__(self, coordinator_url: str,
                 session_properties: Optional[Dict[str, str]] = None,
                 user: Optional[str] = None):
        self.coordinator_url = coordinator_url.rstrip("/")
        self.session_properties = dict(session_properties or {})
        self.user = user
        # the last statement's stats block, query id and response bytes
        self.stats: Optional[Dict] = None
        self.query_id: Optional[str] = None
        self.response_bytes = 0
        # the last statement's result-cache disposition (HIT | MISS |
        # BYPASS) from the X-Trino-Tpu-Cache header; None before the
        # coordinator decided
        self.cache_status: Optional[str] = None
        # prepared statements live on the server (name -> statement text)
        self.prepared_statements: Dict[str, str] = {}

    def execute(self, sql: str, timeout: float = 600.0,
                on_stats=None) -> Tuple[List[str], List[list]]:
        """(column names, rows). ``on_stats`` is called with the stats
        block of every protocol response. Raises RemoteQueryError when the
        query fails or ``timeout`` seconds pass."""
        headers = {f"X-Trino-Session-{k}": str(v) for k, v in self.session_properties.items()}
        if self.user:
            headers["X-Trino-User"] = self.user
        self.cache_status = None
        self.stats = None
        self.query_id = None
        self.response_bytes = 0
        deadline = time.monotonic() + timeout
        status, body, resp_headers = wire.http_request(
            "POST", f"{self.coordinator_url}/v1/statement", sql.encode(), "text/plain",
            timeout=min(timeout, 60.0), headers=headers)
        self._note_cache_header(resp_headers)
        if status >= 400:
            raise RemoteQueryError(f"submit failed: {body[:500].decode(errors='replace')}")
        columns: List[str] = []
        rows: List[list] = []
        while True:
            self.response_bytes += len(body)
            payload = json.loads(body)
            self.query_id = payload.get("id", self.query_id)
            if "stats" in payload:
                self.stats = payload["stats"]
                if on_stats is not None:
                    on_stats(self.stats)
            if "error" in payload:
                raise RemoteQueryError(payload["error"]["message"])
            for k, v in payload.get("setSessionProperties", {}).items():
                self.session_properties[k] = v
            for k in payload.get("resetSessionProperties", []):
                self.session_properties.pop(k, None)
            for k, v in payload.get("addedPreparedStatements", {}).items():
                self.prepared_statements[k] = v
            for k in payload.get("deallocatedPreparedStatements", []):
                self.prepared_statements.pop(k, None)
            if "columns" in payload:
                columns = [c["name"] for c in payload["columns"]]
            rows.extend(payload.get("data", []))
            if payload.get("segments"):
                raise NotImplementedError("spooled result segments are not ported")
            next_uri = payload.get("nextUri")
            if next_uri is None:
                return columns, rows
            if time.monotonic() > deadline:
                try:  # cancel what the client gives up on
                    wire.http_request("DELETE", next_uri, timeout=5.0)
                except Exception:  # noqa: BLE001
                    pass
                raise RemoteQueryError(f"client timeout after {timeout} s")
            status, body, resp_headers = wire.http_request("GET", next_uri, timeout=60.0)
            self._note_cache_header(resp_headers)
            if status >= 400:
                raise RemoteQueryError(f"poll failed: {body[:500].decode(errors='replace')}")

    def _note_cache_header(self, resp_headers: Dict[str, str]) -> None:
        for k, v in (resp_headers or {}).items():
            if k.lower() == "x-trino-tpu-cache":
                self.cache_status = v


def decode_pages(body: bytes) -> list:
    """Framed serde pages -> rows (lists) in the inline protocol's JSON
    vocabulary: dates and timestamps as ISO strings, decimals as decimal
    strings. Plain numeric columns convert column-wise."""
    from trino_tpu_torch.data.serde import deserialize_page

    rows: list = []
    for pb in wire.unframe_pages(body):
        page = deserialize_page(pb)
        cols = [_column_client_values(c) for c in page.columns]
        rows.extend(list(t) for t in zip(*cols))
    return rows


def _column_client_values(col) -> list:
    """One decoded host column -> Python values in the inline protocol's
    JSON vocabulary."""
    import numpy as np

    from trino_tpu_torch import types as T
    from trino_tpu_torch.data.page import to_numpy

    t = col.type
    if (col.children is not None or col.hi is not None or t.is_varchar
            or isinstance(t, T.TimestampType)):
        return _normalized_slow_values(col)
    vals = to_numpy(col.values)
    if t == T.DATE:
        out = np.asarray(vals, "datetime64[D]").astype(str).tolist()
    elif t.is_decimal:
        out = _decimal_strings(vals.tolist(), t.scale)
    elif t == T.BOOLEAN:
        out = np.asarray(vals, bool).tolist()
    else:
        out = vals.tolist()
    if col.nulls is not None:
        out = [None if isnull else v for v, isnull in zip(out, to_numpy(col.nulls).tolist())]
    return out


def _decimal_strings(ints: list, scale: int) -> list:
    """Scaled-int64 decimals -> the strings ``str(Decimal)`` gives."""
    if scale == 0:
        return [str(v) for v in ints]
    p = 10 ** scale
    return [(f"{v // p}.{v % p:0{scale}d}" if v >= 0 else f"-{-v // p}.{-v % p:0{scale}d}")
            for v in ints]


def _normalized_slow_values(col) -> list:
    """``to_python`` and the inline vocabulary (dates -> ISO strings,
    Decimals -> strings), chosen from the first non-NULL value."""
    import datetime
    import decimal

    out = col.to_python()
    conv = None
    for v in out:
        if v is None:
            continue
        if isinstance(v, (datetime.date, datetime.datetime)):
            conv = lambda x: x.isoformat()  # noqa: E731
        elif isinstance(v, decimal.Decimal):
            conv = str
        break
    if conv is None:
        return out
    return [None if v is None else conv(v) for v in out]
