"""Eager executor, dynamic filters: megabytes (10**6 bytes) per query that
the dynamic filters copied from the card to the host, from the port's
``trino_tpu_dynamic_filter_host_bytes_total`` over the traced window (the
build-side key columns with their selection and nulls)."""

COUNTER = "trino_tpu_dynamic_filter_host_bytes_total"


def read(run):
    if not run.completed or COUNTER not in run.counters:
        return None
    return run.counters[COUNTER] / 1e6 / run.completed
