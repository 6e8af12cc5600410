"""Eager executor, windows and set operations: milliseconds per query of the
port's ``trino_tpu_set_op_seconds_total`` over the traced window (its
``exec/set-op`` spans: UNION ALL's concatenation of its branches,
INTERSECT and EXCEPT). They lie inside the executor's runs, so
``dispatch_ms_per_query`` holds them too."""

COUNTER = "trino_tpu_set_op_seconds_total"


def read(run):
    if not run.completed or COUNTER not in run.counters:
        return None
    return 1e3 * run.counters[COUNTER] / run.completed
