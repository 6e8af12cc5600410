"""Catalog registry: the port of trino_tpu/connector/registry.py with the
catalogs ported so far (``tpch`` and ``memory``)."""
from __future__ import annotations

from typing import Dict

from trino_tpu_torch.connector.spi import Connector


def default_catalogs() -> Dict[str, Connector]:
    from trino_tpu_torch.connector.memory.connector import MemoryConnector
    from trino_tpu_torch.connector.tpch import TpchConnector

    return {"tpch": TpchConnector(), "memory": MemoryConnector()}
