"""Wire helpers of the distributed path: framed page bodies + internal auth
(a copy of trino_tpu/server/wire.py, with ``ServerHTTP``).

Reference: ``application/X-trino-pages`` bodies (concatenated serialized
pages) with sequence-id headers (``server/InternalHeaders.java:21-25``,
SURVEY.md §A.4), and HMAC-style internal authentication
(``server/InternalAuthenticationManager.java`` — JWT there, keyed digest
here; same role: workers only accept control-plane calls from the cluster).
"""
from __future__ import annotations

import hashlib
import hmac
import http.client
import json
import os
import struct
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import urlsplit

MEDIA_PAGES = "application/x-trino-tpu-pages"

H_PAGE_TOKEN = "X-Page-Token"
H_NEXT_TOKEN = "X-Page-Next-Token"
H_BUFFER_COMPLETE = "X-Buffer-Complete"
H_TASK_FAILED = "X-Task-Failed"
H_INTERNAL_AUTH = "X-Internal-Auth"

# Cluster-internal shared secret (reference: the
# internal-communication.shared-secret config). There is NO well-known
# default: task bodies are pickled plans, so accepting a guessable
# signature would be remote code execution. Unset, each process generates
# a random secret — a coordinator must export its secret to its workers
# (get_secret() → TRINO_TPU_INTERNAL_SECRET in the worker environment).
_env_secret = os.environ.get("TRINO_TPU_INTERNAL_SECRET")
if _env_secret is None:
    import secrets as _secrets

    _env_secret = _secrets.token_hex(32)
_SECRET = _env_secret.encode()


class ServerHTTP(ThreadingHTTPServer):
    """The servers' HTTP front: a thread a connection, and a listen backlog
    that takes a burst of clients connecting at once (the socketserver
    default of 5 resets the connections past it); overload is answered by
    the dispatch plane with 429, not by the kernel with a reset."""

    request_queue_size = 128


def get_secret() -> str:
    """This process's cluster secret (pass to spawned workers' env)."""
    return _SECRET.decode()


def sign(body: bytes) -> str:
    return hmac.new(_SECRET, body, hashlib.sha256).hexdigest()


def verify(body: bytes, signature: Optional[str]) -> bool:
    return signature is not None and hmac.compare_digest(sign(body), signature)


def frame_pages(pages: List[bytes]) -> bytes:
    """Length-prefix each serialized page so one body carries a batch."""
    return b"".join(struct.pack("<I", len(p)) + p for p in pages)


def unframe_pages(body: bytes) -> List[bytes]:
    pages = []
    off = 0
    while off < len(body):
        (n,) = struct.unpack_from("<I", body, off)
        off += 4
        pages.append(body[off : off + n])
        off += n
    return pages


# ------------------------------------------------------------ keep-alive
# Connection pool for the control plane and clients: one TCP connect per
# (host, port) instead of per REQUEST (the reference's jetty/OkHttp
# clients pool connections; urllib opened a fresh socket every call —
# three connects per served query on the statement protocol alone).
# Idle connections age out (the server side closes idles on its own
# timeout, so the client TTL stays shorter to avoid request-on-closing
# races) and stale sockets retry once on a fresh connection.
_IDLE_MAX_PER_HOST = 8
_IDLE_TTL_S = 20.0


class _ConnectionPool:
    def __init__(self):
        self._idle = {}  # (host, port) -> [(conn, idle_since), ...]
        self._lock = threading.Lock()

    def get(self, key):
        """A pooled connection that has not idled out, or None."""
        import time as _time

        now = _time.monotonic()
        with self._lock:
            stack = self._idle.get(key)
            while stack:
                conn, since = stack.pop()
                if now - since <= _IDLE_TTL_S:
                    return conn
                try:
                    conn.close()
                except OSError:
                    pass
        return None

    def put(self, key, conn) -> None:
        import time as _time

        with self._lock:
            stack = self._idle.setdefault(key, [])
            if len(stack) < _IDLE_MAX_PER_HOST:
                stack.append((conn, _time.monotonic()))
                return
        try:
            conn.close()
        except OSError:
            pass

    def clear(self) -> None:
        with self._lock:
            stacks, self._idle = list(self._idle.values()), {}
        for stack in stacks:
            for conn, _since in stack:
                try:
                    conn.close()
                except OSError:
                    pass


class _KeepAliveConnection(http.client.HTTPConnection):
    """HTTPConnection with TCP_NODELAY: on a REUSED connection Nagle
    batches the request bytes behind the previous response's delayed ACK
    (a ~40ms stall per request on loopback) — pooling without this is
    slower than fresh connects."""

    def connect(self):
        import socket

        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


_POOL = _ConnectionPool()

# errors that mean "the pooled socket went stale" (server closed it
# between requests) — safe to retry ONCE on a fresh connection; anything
# else (including timeouts) propagates
_STALE_ERRORS = (http.client.BadStatusLine, http.client.CannotSendRequest,
                 http.client.ResponseNotReady, ConnectionResetError,
                 ConnectionAbortedError, BrokenPipeError)


def reset_connection_pool() -> None:
    """Drop every pooled connection (tests / fork hygiene)."""
    _POOL.clear()


def http_request(
    method: str,
    url: str,
    body: bytes = b"",
    content_type: str = "application/octet-stream",
    timeout: float = 30.0,
    headers: Optional[dict] = None,
) -> Tuple[int, bytes, dict]:
    """Minimal signed HTTP call over a pooled keep-alive connection.
    Returns (status, body, headers)."""
    parts = urlsplit(url)
    if parts.scheme != "http":
        return _urllib_request(method, url, body, content_type, timeout,
                               headers)
    from trino_tpu_torch.obs import metrics as M

    key = (parts.hostname, parts.port or 80)
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    hdrs = {"Content-Type": content_type, H_INTERNAL_AUTH: sign(body),
            "Accept-Encoding": "identity"}
    for k, v in (headers or {}).items():
        hdrs[k] = v
    payload = body if method in ("POST", "PUT") else None
    # stale-socket retry safety: GET/DELETE/PUT are idempotent on this
    # protocol (status polls, cancels, announces), so a reused socket
    # that dies mid-RESPONSE may retry. POST is not (a statement may
    # already have executed) — it retries only when the failure happened
    # while SENDING, i.e. the server cannot have received the request.
    response_retry_ok = method != "POST"
    conn = _POOL.get(key)
    reused = conn is not None
    while True:
        if conn is None:
            conn = _KeepAliveConnection(key[0], key[1], timeout=timeout)
            M.HTTP_CONNECTIONS_OPENED.inc()
        else:
            conn.timeout = timeout  # reconnect-after-close honors it too
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
        sent = False
        try:
            conn.request(method, path, body=payload, headers=hdrs)
            sent = True
            resp = conn.getresponse()
            data = resp.read()
            resp_headers = dict(resp.getheaders())
            if resp.will_close:
                conn.close()
            else:
                _POOL.put(key, conn)
            if reused:
                M.HTTP_CONNECTION_REUSES.inc()
            return resp.status, data, resp_headers
        except _STALE_ERRORS:
            try:
                conn.close()
            except OSError:
                pass
            if not reused or (sent and not response_retry_ok):
                raise
            conn, reused = None, False  # one retry on a fresh socket
        except Exception:
            try:
                conn.close()
            except OSError:
                pass
            raise


def _urllib_request(method, url, body, content_type, timeout, headers):
    """Non-http schemes fall back to the original urllib path."""
    req = urllib.request.Request(url, data=body if method in ("POST", "PUT") else None, method=method)
    req.add_header("Content-Type", content_type)
    req.add_header(H_INTERNAL_AUTH, sign(body))
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def json_request(method: str, url: str, payload=None, timeout: float = 30.0):
    import time as _time

    body = json.dumps(payload).encode() if payload is not None else b""
    t0 = _time.perf_counter()
    status, data, _ = http_request(method, url, body, "application/json", timeout)
    elapsed = _time.perf_counter() - t0
    # control-plane flow accounting (announce, task submit/status,
    # cancel): rollup-only (ring=False), so heartbeats at 2/s/worker do
    # not evict the data-plane records a postmortem wants. The wall is
    # charged to the response leg so link seconds never double-count.
    try:
        from trino_tpu_torch.obs.flowledger import FLOW_LEDGER

        if body:
            FLOW_LEDGER.record_transfer(
                "control", "control", len(body), 0.0, direction="send",
                ring=False)
        FLOW_LEDGER.record_transfer(
            "control", "control", len(data), elapsed, direction="recv",
            status=str(status), ring=False)
    except Exception:  # noqa: BLE001 — accounting never fails work
        pass
    if status >= 400:
        raise RuntimeError(f"{method} {url} -> {status}: {data[:500].decode(errors='replace')}")
    return json.loads(data) if data else None
