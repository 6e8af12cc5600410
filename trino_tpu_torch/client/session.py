"""User-facing entry point: Session.execute(sql) -> QueryResult.

The port of trino_tpu/client/session.py for the local path. The session
owns the torch device every query runs on: CUDA unless the caller names
another device (the CPU tests pass ``device="cpu"``). A session asked for
CUDA on a machine without a usable GPU raises instead of running
elsewhere. The session owns the generator ``random()`` draws from, on
its device. ``catalogs`` and ``udfs`` share one connector map and one
routine registry between sessions (the reference's server mode), so
tables written through the memory catalog and functions made by CREATE
FUNCTION persist from statement to statement and session to session;
``matviews`` does the same for the materialized-view registry (a private
one when none is passed). An explicit transaction (exec/transaction.py) gives its session a private
map over the shared catalogs for as long as it runs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class Session:
    """A query session: catalogs, session properties, identity and access
    control, SQL routines, prepared statements, materialized views, the
    active transaction and the device."""

    def __init__(self, properties: Optional[Dict[str, Any]] = None, device=None,
                 catalogs=None, identity=None, access_control=None, udfs=None,
                 matviews=None):
        import torch

        from trino_tpu_torch.client.properties import defaulted
        from trino_tpu_torch.connector.registry import default_catalogs
        from trino_tpu_torch.server.security import AccessControl, Identity

        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Session: CUDA device requested but torch.cuda.is_available() "
                "is False (pass device='cpu' to run on the CPU)")
        # random() draws from this generator, on the session's device
        self.generator = torch.Generator(device=self.device)
        self.generator.seed()
        self.catalogs = catalogs if catalogs is not None else default_catalogs()
        self.properties: Dict[str, Any] = defaulted(dict(properties or {}))
        self.identity = identity or Identity()
        self.access_control = access_control or AccessControl()
        # name -> UdfDef (sql/routines.py)
        self.udfs = udfs if udfs is not None else {}
        # the materialized-view registry (matview/): server mode shares one
        # across sessions, like ``catalogs``; an embedded session gets its own
        if matviews is None:
            from trino_tpu_torch.matview.registry import MaterializedViewRegistry

            matviews = MaterializedViewRegistry()
        self.matviews = matviews
        # name -> parsed statement (PREPARE / EXECUTE / DEALLOCATE)
        self.prepared_statements: Dict[str, Any] = {}
        # the active explicit transaction (exec/transaction.py), or None;
        # the device cache bypasses every scan while one is active
        self.transaction = None

    def set_property(self, name: str, value: Any) -> None:
        """SET SESSION analog: typed and validated (client/properties.py)."""
        from trino_tpu_torch.client.properties import validate_property

        self.properties[name] = validate_property(name, value)

    def execute(self, sql: str):
        """Run a statement; returns a QueryResult (column names + Python rows)."""
        from trino_tpu_torch.exec.query import run_query

        return run_query(self, sql)

    def explain(self, sql: str, mode: str = "logical") -> str:
        """The plan text of ``sql`` (EXPLAIN)."""
        from trino_tpu_torch.exec.query import explain_query

        return explain_query(self, sql, mode)
