"""Session and SQL: milliseconds per query of parsing, planning and
optimizing, from the port's ``trino_tpu_plan_seconds_total`` over the traced
window (fed by its ``parse``, ``analyze/plan``, ``optimize`` and
``plan/mv-substitute`` spans, nested planning once)."""

COUNTER = "trino_tpu_plan_seconds_total"


def read(run):
    if not run.completed or COUNTER not in run.counters:
        return None
    return 1e3 * run.counters[COUNTER] / run.completed
