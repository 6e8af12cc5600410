"""Eager executor, windows and set operations: milliseconds per query of the
port's ``trino_tpu_window_seconds_total`` over the traced window (its
``exec/window`` spans around ``window_over_page``: the shared layout and
every window call). They lie inside the executor's runs, so
``dispatch_ms_per_query`` holds them too."""

COUNTER = "trino_tpu_window_seconds_total"


def read(run):
    if not run.completed or COUNTER not in run.counters:
        return None
    return 1e3 * run.counters[COUNTER] / run.completed
