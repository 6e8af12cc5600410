"""Staging and device cache: the port's ``trino_tpu_device_cache_misses_total``
over the traced window, per query completed in it."""

COUNTER = "trino_tpu_device_cache_misses_total"


def read(run):
    if not run.completed or COUNTER not in run.counters:
        return None
    return run.counters[COUNTER] / run.completed
