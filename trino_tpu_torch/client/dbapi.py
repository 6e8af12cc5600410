"""PEP 249 (DB-API 2.0) client — the role of the reference's JDBC driver.
The port of trino_tpu/client/dbapi.py.

Reference: ``client/trino-jdbc`` (TrinoDriver/TrinoConnection/
TrinoStatement over the REST statement protocol) and the companion
``trino-python-client``'s dbapi module. Standard shape: ``connect()`` ->
Connection -> ``cursor()`` -> ``execute(sql, params)`` / ``fetchall()``,
with qmark-style parameters bound through the engine's PREPARE/EXECUTE
path when talking to a coordinator, or substituted locally for embedded
sessions.

Two transports:
- ``connect(coordinator_url=...)`` — remote over the REST protocol
  (client/remote.py StatementClient), the JDBC-over-HTTP analog;
- ``connect(session=...)`` / ``connect()`` — embedded in-process engine
  (the reference's testing QueryRunner role).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

apilevel = "2.0"
threadsafety = 1  # threads may share the module, not connections
paramstyle = "qmark"


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class Connection:
    def __init__(self, coordinator_url: Optional[str] = None, session=None,
                 catalog: str = "tpch", schema: str = "tiny",
                 user: Optional[str] = None, source: Optional[str] = None,
                 password: Optional[str] = None, token: Optional[str] = None,
                 device=None, **properties):
        # ``user`` and ``source`` ride the X-Trino-User and X-Trino-Source
        # headers (resource-group selector inputs), ``password`` or
        # ``token`` Basic or Bearer credentials; ``device`` is the embedded
        # session's torch device (CUDA unless named)
        if coordinator_url is not None:
            from trino_tpu_torch.client.remote import StatementClient

            props = {"catalog": catalog, "schema": schema, **properties}
            self._client = StatementClient(coordinator_url, props, user=user, source=source,
                                           password=password, token=token)
            self._session = None
        else:
            if session is None:
                from trino_tpu_torch.client.session import Session

                session = Session({"catalog": catalog, "schema": schema, **properties},
                                  device=device)
            self._session = session
            self._client = None
        self._closed = False

    def cursor(self) -> "Cursor":
        if self._closed:
            raise InterfaceError("connection is closed")
        return Cursor(self)

    def close(self) -> None:
        self._closed = True

    # transactions (embedded sessions only; the remote protocol is
    # autocommit, like the reference driver's default)
    def commit(self) -> None:
        if self._session is not None and self._session.transaction is not None:
            self._session.transaction.commit()

    def rollback(self) -> None:
        if self._session is not None and self._session.transaction is not None:
            self._session.transaction.rollback()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Cursor:
    arraysize = 1

    def __init__(self, conn: Connection):
        self._conn = conn
        self.description = None  # 7-tuples per PEP 249
        self.rowcount = -1
        # result-cache disposition of the last execute() against a remote
        # coordinator: "HIT" | "MISS" | "BYPASS" (None for embedded
        # sessions, which have no coordinator cache in front of them)
        self.cache_status: Optional[str] = None
        # final query stats of the last execute() against a remote
        # coordinator (the StatementStats analog: elapsedMs, splits, rows,
        # bytes, peakBytes); None for embedded sessions
        self.stats: Optional[dict] = None
        self._rows: List[tuple] = []
        self._pos = 0

    def execute(self, operation: str, parameters: Optional[Sequence] = None):
        if self._conn._closed:
            raise InterfaceError("connection is closed")
        if (parameters is not None and self._conn._client is not None
                and _qmark_count(operation) > 0):
            # remote qmark binding goes through server-side
            # PREPARE/EXECUTE: the parameterized plan caches ONCE on the
            # coordinator and every binding reuses it (the reference
            # driver's prepared-statement path; executemany loops EXECUTE
            # over the same prepared plan)
            return self._execute_prepared_remote(operation, parameters)
        sql = operation
        if parameters:
            # embedded sessions bind by literal substitution (one
            # in-process call; no coordinator plan cache to warm)
            sql = _substitute_qmarks(operation, parameters)
        return self._run(sql)

    def _run(self, sql: str):
        self.cache_status = None
        self.stats = None
        try:
            if self._conn._client is not None:
                columns, rows = self._conn._client.execute(sql)
                self.cache_status = self._conn._client.cache_status
                self.stats = self._conn._client.stats
            else:
                res = self._conn._session.execute(sql)
                columns, rows = res.column_names, res.rows
        except Exception as e:  # noqa: BLE001 — PEP 249 error taxonomy
            raise DatabaseError(str(e)) from e
        self.description = [(c, None, None, None, None, None, None) for c in columns]
        self._rows = [tuple(r) for r in rows]
        self._pos = 0
        self.rowcount = len(self._rows)
        return self

    def _execute_prepared_remote(self, operation: str, parameters: Sequence):
        client = self._conn._client
        name = "dbapi_" + _statement_digest(operation)
        if name not in client.prepared_statements:
            self._run(f"PREPARE {name} FROM {operation}")
        args = ", ".join(_literal(v) for v in parameters)
        sql = f"EXECUTE {name}" + (f" USING {args}" if args else "")
        try:
            return self._run(sql)
        except DatabaseError as e:
            if "prepared statement not found" not in str(e):
                raise
            # the server lost the statement (restart / registry eviction):
            # re-PREPARE once and retry
            client.prepared_statements.pop(name, None)
            self._run(f"PREPARE {name} FROM {operation}")
            return self._run(sql)

    def executemany(self, operation: str, seq_of_parameters):
        # each binding runs through execute(): against a coordinator the
        # first call PREPAREs and every later one is a bare EXECUTE over
        # the one cached parameterized plan
        for params in seq_of_parameters:
            self.execute(operation, params)
        return self

    def fetchone(self):
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None):
        size = size or self.arraysize
        out = self._rows[self._pos : self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self):
        out = self._rows[self._pos :]
        self._pos = len(self._rows)
        return out

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def close(self):
        self._rows = []

    def setinputsizes(self, sizes):  # noqa: D102 — PEP 249 no-ops
        pass

    def setoutputsize(self, size, column=None):
        pass


def connect(coordinator_url: Optional[str] = None, **kwargs) -> Connection:
    return Connection(coordinator_url, **kwargs)


def _statement_digest(sql: str) -> str:
    """Stable per-statement name suffix for driver-generated PREPAREs (two
    cursors binding the same SQL share one server-side plan)."""
    import hashlib

    return hashlib.sha1(sql.strip().encode()).hexdigest()[:12]


def _sql_segments(sql: str):
    """Tokenize into ``("text", chunk)`` / ``("qmark", None)`` segments,
    ``'...'``-literal aware (with ``''`` escapes) — the ONE scanner both
    the qmark counter and the literal substitution consume, so the
    remote-routing decision can never disagree with the substitution."""
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch == "'":
            j = i + 1
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    j += 2
                    continue
                if sql[j] == "'":
                    break
                j += 1
            yield "text", sql[i : j + 1]
            i = j + 1
            continue
        if ch == "?":
            yield "qmark", None
            i += 1
            continue
        yield "text", ch
        i += 1


def _qmark_count(sql: str) -> int:
    """``?`` parameter markers outside string literals."""
    return sum(1 for kind, _ in _sql_segments(sql) if kind == "qmark")


def _substitute_qmarks(sql: str, params: Sequence) -> str:
    """Bind qmark parameters as SQL literals, string-literal-aware
    (embedded sessions only; the remote path sends PREPARE/EXECUTE)."""
    out = []
    it = iter(params)
    for kind, chunk in _sql_segments(sql):
        if kind == "qmark":
            try:
                out.append(_literal(next(it)))
            except StopIteration:
                raise InterfaceError("not enough parameters for statement") from None
        else:
            out.append(chunk)
    return "".join(out)


def _literal(v) -> str:
    import datetime
    import decimal

    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float, decimal.Decimal)):
        return str(v)
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    raise InterfaceError(f"cannot bind parameter of type {type(v).__name__}")
