"""User-facing entry point: Session.execute(sql) -> QueryResult.

The port of trino_tpu/client/session.py for the local path. The session
owns the torch device every query runs on: CUDA unless the caller names
another device (the CPU tests pass ``device="cpu"``). A session asked for
CUDA on a machine without a usable GPU raises instead of running
elsewhere. The session owns the generator ``random()`` draws from, on
its device. ``catalogs`` shares one connector map between sessions (the
reference's server mode), so tables written through the memory catalog
persist from statement to statement and session to session.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


class Session:
    """A query session: catalogs, session properties and the device."""

    def __init__(self, properties: Optional[Dict[str, Any]] = None, device=None,
                 catalogs=None):
        import torch

        from trino_tpu_torch.client.properties import defaulted
        from trino_tpu_torch.connector.registry import default_catalogs

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
        # explicit transactions are not ported; the device cache's bypass
        # rule reads this (an active overlay is never cached)
        self.transaction = None

    def set_property(self, name: str, value: Any) -> None:
        """SET SESSION analog: typed and validated (client/properties.py)."""
        from trino_tpu_torch.client.properties import validate_property

        self.properties[name] = validate_property(name, value)

    def execute(self, sql: str):
        """Run a statement; returns a QueryResult (column names + Python rows)."""
        from trino_tpu_torch.exec.query import run_query

        return run_query(self, sql)
