"""Host partition ids for the producers' hash exchange: the port of
trino_tpu/parallel/exchange.py's ``spread_partition_ids``, the host half of
the adaptive skew salting (adaptive/replanner.py). The reference's SPMD
exchange over a device mesh (``_mix64``, ``partition_ids``,
``repartition_page``) is not ported: the port runs on one device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def spread_partition_ids(pid: np.ndarray, hot_partitions, n_parts: int,
                         start: int = 0) -> Tuple[np.ndarray, int]:
    """Salted spread of HOT partitions (host half of the adaptive skew
    mitigation, adaptive/replanner.py): rows whose key hash
    landed in a hot partition are re-dealt round-robin across ALL
    partitions, deterministically by row position (a replay of the
    producer places them alike). ``start`` is the producer's rotating cursor —
    streaming producers call this once per output page, and restarting at
    partition 0 each page would pile every page's few hot rows onto the
    low-numbered partitions, re-creating the skew; the caller threads the
    returned cursor into the next call. Exactness contract: the spread
    side's rows lose key co-location, so the OTHER join side must
    replicate the same hot partitions into every partition — a spread
    probe row then finds its (hot-key) build matches wherever it lands,
    while rows of non-hot partitions cannot spuriously match replicated
    hot-key rows (their key hashes differ by construction). One hot key
    stops serializing on one task; the price is |hot build| x n_parts
    replicated bytes.

    Returns ``(new_pid, next_start)``."""
    pid = np.asarray(pid).copy()
    hot = np.asarray(sorted(hot_partitions), dtype=pid.dtype)
    idx = np.flatnonzero(np.isin(pid, hot))
    pid[idx] = ((start + np.arange(len(idx))) % n_parts).astype(pid.dtype)
    return pid, (start + len(idx)) % n_parts
