"""Eager executor, host passes: milliseconds per query of the port's host
passes (``exec/host-pass``), the scalar lowerings' passes over a vocabulary
or a table of days and the nested slice's, from
``trino_tpu_scalar_host_seconds_total`` and
``trino_tpu_nested_host_seconds_total`` over the traced window."""

COUNTERS = ("trino_tpu_scalar_host_seconds_total", "trino_tpu_nested_host_seconds_total")


def read(run):
    if not run.completed or any(c not in run.counters for c in COUNTERS):
        return None
    return 1e3 * sum(run.counters[c] for c in COUNTERS) / run.completed
