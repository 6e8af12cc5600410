"""User-facing entry point: Session.execute(sql) -> QueryResult.

The port of trino_tpu/client/session.py for the local path. The session
owns the torch device every query runs on: CUDA unless the caller names
another device (the CPU tests pass ``device="cpu"``). A session asked for
CUDA on a machine without a usable GPU raises instead of running
elsewhere.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def default_catalogs() -> Dict[str, Any]:
    from trino_tpu_torch.connector.tpch import TpchConnector

    return {"tpch": TpchConnector()}


class Session:
    """A query session: catalogs, session properties and the device."""

    def __init__(self, properties: Optional[Dict[str, Any]] = None, device=None):
        import torch

        from trino_tpu_torch.client.properties import defaulted

        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Session: CUDA device requested but torch.cuda.is_available() "
                "is False (pass device='cpu' to run on the CPU)")
        self.catalogs = default_catalogs()
        self.properties: Dict[str, Any] = defaulted(dict(properties or {}))

    def execute(self, sql: str):
        """Run a query; returns a QueryResult (column names + Python rows)."""
        from trino_tpu_torch.exec.query import run_query

        return run_query(self, sql)
