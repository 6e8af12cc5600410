"""Single-flight holder shared by the device and host cache tiers: the
port's copy of trino_tpu/cache/result_cache.py ``_Flight`` (the result
cache itself is not ported)."""
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
