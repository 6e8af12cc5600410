"""Transactions: explicit START TRANSACTION / COMMIT / ROLLBACK: the port of
trino_tpu/exec/transaction.py, with its isolation repaired.

Reference: ``core/trino-main/.../transaction/InMemoryTransactionManager.java``
— a transaction owns per-catalog connector transaction handles; reads
inside it see the transaction's isolated view; commit publishes
atomically, abort discards. Here the engine's one transactional connector
(memory) is wrapped in a copy-on-write OVERLAY: reads hit the overlay
first, writes change only the overlay, and COMMIT swaps the staged tables
into the base connector under a lock in one step. Writes to a
non-transactional connector inside an explicit transaction raise, as the
reference's "Catalog only supports writes using autocommit".

Isolation. Sessions may share one ``catalogs`` map (server mode). On
``begin`` the session's ``catalogs`` becomes a private map over the shared
one, and overlays are entered only there: no other session sees them,
and another session's autocommit writes go to the base connector, never
into this transaction. (The reference enters the overlay into the shared
map itself, so other sessions read the uncommitted rows and their own
writes vanish on rollback.) COMMIT of a table whose base changed after the
overlay's snapshot raises ``TransactionError`` and discards the
transaction: publishing it would overwrite the other session's committed
rows. The change is seen through the table's ``data_version``.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Tuple

from trino_tpu_torch.connector import spi
from trino_tpu_torch.data.page import column_data_from_python


class TransactionError(RuntimeError):
    pass


class TransactionalOverlay(spi.Connector):
    """The memory connector's transaction view: staged creates, drops and
    appends living only in this object until commit."""

    coordinator_only = True

    def __init__(self, base):
        self.base = base
        self.name = base.name
        # (schema, table) -> (meta, cols) staged state, or None = dropped
        self._staged: Dict[Tuple[str, str], Optional[tuple]] = {}
        # (schema, table) -> the base's data_version when first touched
        self._base_versions: Dict[Tuple[str, str], str] = {}

    # --- reads: overlay first -------------------------------------------
    def list_schemas(self):
        return self.base.list_schemas()

    def list_tables(self, schema):
        names = {
            n for n in self.base.list_tables(schema)
            if self._staged.get((schema, n), ()) is not None
        }
        names |= {
            t for (s, t), v in self._staged.items() if s == schema and v is not None
        }
        return sorted(names)

    def get_table(self, schema, table):
        key = (schema, table)
        if key in self._staged:
            st = self._staged[key]
            return None if st is None else st[0]
        return self.base.get_table(schema, table)

    def table_row_count(self, schema, table):
        key = (schema, table)
        if key in self._staged:
            st = self._staged[key]
            if st is None:
                return None
            _, cols = st
            first = next(iter(cols.values()), None)
            return 0 if first is None else len(first.values)
        return self.base.table_row_count(schema, table)

    def column_stats(self, schema, table, column):
        if (schema, table) in self._staged:
            return None  # staged data: no stats (conservative)
        return self.base.column_stats(schema, table, column)

    def primary_key(self, schema, table):
        if (schema, table) in self._staged:
            return None
        return self.base.primary_key(schema, table)

    def get_splits(self, schema, table, target_splits, constraint=None,
                   handle=None):
        if (schema, table) in self._staged:
            if self._staged[(schema, table)] is None:
                raise KeyError(f"{self.name}.{schema}.{table} does not exist")
            n = self.table_row_count(schema, table) or 0
            return [spi.Split(table, schema, 0, n)]
        return self.base.get_splits(schema, table, target_splits, constraint,
                                    handle=handle)

    def scan(self, split, columns, constraint=None):
        key = (split.schema, split.table)
        if key in self._staged:
            _, cols = self._staged[key]
            return {c: spi.column_data_slice(cols[c], split.lo, split.hi) for c in columns}
        return self.base.scan(split, columns, constraint)

    # --- writes: stage only ---------------------------------------------
    def _touch(self, key):
        """Remember the base table's version when this transaction first
        touches ``key`` (the commit-time conflict check)."""
        if key not in self._base_versions:
            self._base_versions[key] = self.base.data_version(*key)

    def _snapshot(self, schema, table):
        """Copy the base table into the overlay (copy-on-write)."""
        key = (schema, table)
        if key in self._staged:
            if self._staged[key] is None:
                raise KeyError(
                    f"{self.name}.{schema}.{table} does not exist "
                    "(dropped in this transaction)")
            return
        self._touch(key)
        entry = self.base._tables.get(key)
        if entry is None:
            raise KeyError(f"{self.name}.{schema}.{table} does not exist")
        meta, cols = entry
        self._staged[key] = (meta, dict(cols))

    def create_table(self, schema, name, schema_def, rows):
        if self.get_table(schema, name) is not None:
            raise ValueError(f"table already exists: {schema}.{name}")
        self._touch((schema, name))
        cols = {
            cname: column_data_from_python(ctype, [r[i] for r in rows])
            for i, (cname, ctype) in enumerate(schema_def)
        }
        meta = spi.TableMetadata(
            schema, name, [spi.ColumnMetadata(n, t) for n, t in schema_def])
        self._staged[(schema, name)] = (meta, cols)

    def insert_rows(self, schema, table, rows):
        self._snapshot(schema, table)
        meta, cols = self._staged[(schema, table)]
        if not rows:
            return 0
        new_cols = {
            cm.name: spi.concat_column_data(
                [cols[cm.name], column_data_from_python(cm.type, [r[i] for r in rows])])
            for i, cm in enumerate(meta.columns)
        }
        self._staged[(schema, table)] = (meta, new_cols)
        return len(rows)

    def overwrite_rows(self, schema, table, rows):
        self._snapshot(schema, table)
        meta, _cols = self._staged[(schema, table)]
        new_cols = {
            cm.name: column_data_from_python(cm.type, [r[i] for r in rows])
            for i, cm in enumerate(meta.columns)
        }
        self._staged[(schema, table)] = (meta, new_cols)

    def drop_table(self, schema, table):
        if self.get_table(schema, table) is None:
            return
        self._touch((schema, table))
        self._staged[(schema, table)] = None

    # --- lifecycle -------------------------------------------------------
    def conflicts(self):
        """The touched tables whose base changed since this overlay first
        touched them."""
        return sorted(key for key, v in self._base_versions.items()
                      if self.base.data_version(*key) != v)

    def publish(self):
        """Apply every staged change to the base connector (the caller
        holds ``_BASE_LOCK`` and has checked ``conflicts``)."""
        for (schema, table), st in self._staged.items():
            if st is None:
                self.base._tables.pop((schema, table), None)
            else:
                self.base._tables[(schema, table)] = st
            # commit is a data mutation like any other: advance the base
            # table's cache-invalidation version
            self.base._bump(schema, table)


_BASE_LOCK = threading.Lock()


class Transaction:
    """One explicit transaction of one session: catalog name -> overlay,
    entered only in the session's private catalog map."""

    def __init__(self, session):
        self.session = session
        self.overlays: Dict[str, TransactionalOverlay] = {}
        self.shared = session.catalogs
        # writes to this map (the overlays) stay private to the session;
        # reads of every other catalog fall through to the shared map
        session.catalogs = collections.ChainMap({}, self.shared)

    def enlist(self, catalog: str):
        """Wrap ``catalog`` in an overlay on first write (reference:
        TransactionManager.getConnectorTransaction creating the handle)."""
        if catalog in self.overlays:
            return
        conn = self.shared[catalog]
        if not getattr(conn, "supports_transactions", False):
            raise TransactionError(
                f"catalog '{catalog}' only supports writes using autocommit")
        ov = TransactionalOverlay(conn)
        self.overlays[catalog] = ov
        self.session.catalogs[catalog] = ov

    def commit(self):
        try:
            with _BASE_LOCK:
                stale = [(c, key) for c, ov in self.overlays.items() for key in ov.conflicts()]
                if stale:
                    raise TransactionError(
                        "transaction aborted: tables changed by another session since "
                        "this transaction first wrote them: "
                        + ", ".join(f"{c}.{s}.{t}" for c, (s, t) in stale))
                for ov in self.overlays.values():
                    ov.publish()
        finally:
            self._restore()

    def rollback(self):
        self._restore()

    def _restore(self):
        self.session.catalogs = self.shared
        self.session.transaction = None


def begin(session) -> Transaction:
    if session.transaction is not None:
        raise TransactionError("a transaction is already in progress")
    txn = Transaction(session)
    session.transaction = txn
    return txn
