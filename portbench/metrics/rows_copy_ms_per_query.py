"""Result rows: milliseconds per query of the rows' device-to-host copies in
``Page.to_pylist`` (the selection and every column, before the Python
conversion), from the port's ``trino_tpu_rows_copy_seconds_total`` over the
traced window (its ``rows/copy`` spans)."""

COUNTER = "trino_tpu_rows_copy_seconds_total"


def read(run):
    if not run.completed or COUNTER not in run.counters:
        return None
    return 1e3 * run.counters[COUNTER] / run.completed
