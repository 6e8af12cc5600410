"""Compiled tier: milliseconds per query of ``CompiledQuery.run`` on the
host beside its wait for the card: the port's
``trino_tpu_compiled_run_seconds_total`` (the ``device/execute`` spans:
enqueue, flag read, ledger, output clone) less
``trino_tpu_replay_wait_seconds_total`` (their ``device/flag-read``), over
the traced window."""

RUN = "trino_tpu_compiled_run_seconds_total"
WAIT = "trino_tpu_replay_wait_seconds_total"


def read(run):
    if not run.completed or RUN not in run.counters or WAIT not in run.counters:
        return None
    return 1e3 * (run.counters[RUN] - run.counters[WAIT]) / run.completed
