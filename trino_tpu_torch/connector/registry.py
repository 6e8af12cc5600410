"""Catalog registry: the port of trino_tpu/connector/registry.py with the
catalogs ported so far (``tpch``, ``tpcds``, ``memory``, ``blackhole``,
``filesystem`` and, when ``TRINO_TPU_SQLITE_DB`` names a database file,
``sqlite``). The ``system`` catalog waits for the server-side modules
(ROADMAP queue 1, item 8)."""
from __future__ import annotations

import os
from typing import Dict

from trino_tpu_torch.connector.spi import Connector


def default_catalogs() -> Dict[str, Connector]:
    from trino_tpu_torch.connector.blackhole.connector import BlackHoleConnector
    from trino_tpu_torch.connector.filesystem.connector import FileSystemConnector
    from trino_tpu_torch.connector.memory.connector import MemoryConnector
    from trino_tpu_torch.connector.tpcds import TpcdsConnector
    from trino_tpu_torch.connector.tpch import TpchConnector

    cats = {
        "tpch": TpchConnector(),
        "tpcds": TpcdsConnector(),
        "memory": MemoryConnector(),
        "blackhole": BlackHoleConnector(),
        # parquet-on-disk catalog; its root directory from the environment
        "filesystem": FileSystemConnector(os.environ.get("TRINO_TPU_FS_ROOT")),
    }
    # RDBMS catalog (the JDBC plugin family's analog); db file via env
    sqlite_path = os.environ.get("TRINO_TPU_SQLITE_DB")
    if sqlite_path:
        from trino_tpu_torch.connector.sqlite import SqliteConnector

        cats["sqlite"] = SqliteConnector(sqlite_path)
    return cats
