"""Single-flight holder shared by the result cache (cache/result_cache.py)
and the device and host cache tiers: the port's one copy of
trino_tpu/cache/result_cache.py ``_Flight``."""
from __future__ import annotations

import threading
from typing import Optional


class _Flight:
    """One in-progress computation of a cache key (single-flight)."""

    def __init__(self):
        self._event = threading.Event()
        self.value = None
        self.ok = False

    def wait(self, timeout: Optional[float]) -> bool:
        return self._event.wait(timeout)

    def _resolve(self, value, ok: bool) -> None:
        self.value = value
        self.ok = ok
        self._event.set()
