"""Eager executor, dynamic filters: milliseconds per query of the port's
``trino_tpu_dynamic_filter_seconds_total`` over the traced window (its
``exec/dynamic-filter`` spans: each join's build-side key columns copied to
the host and reduced to a set or a range for the probe scans). They lie
inside the executor's runs, so ``dispatch_ms_per_query`` holds them too."""

COUNTER = "trino_tpu_dynamic_filter_seconds_total"


def read(run):
    if not run.completed or COUNTER not in run.counters:
        return None
    return 1e3 * run.counters[COUNTER] / run.completed
