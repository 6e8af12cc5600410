"""Eager executor, host dispatch: milliseconds per query of the eager
executor's runs (``exec/run``, ``trino_tpu_executor_seconds_total``) less
its host passes (scalar and nested host seconds), over the traced window.

What stays in it: the dispatch of every plan node's device operations with
its per-operator stats, the device-cache lookups and the device reads the
executor makes where the host must decide (an expansion's total, dynamic
filters, the error flags, the batched stats read)."""

EXECUTOR = "trino_tpu_executor_seconds_total"
HOST_PASSES = ("trino_tpu_scalar_host_seconds_total", "trino_tpu_nested_host_seconds_total")


def read(run):
    names = (EXECUTOR,) + HOST_PASSES
    if not run.completed or any(c not in run.counters for c in names):
        return None
    s = run.counters[EXECUTOR] - sum(run.counters[c] for c in HOST_PASSES)
    return 1e3 * s / run.completed
