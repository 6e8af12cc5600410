"""Staging and device cache: milliseconds per query in the port's own
``staging/*`` and ``device-cache/lookup`` spans (nested ones counted once),
recorded into a tracer the harness activates around each query of the
traced window."""


def read(run):
    if not run.completed or not run.staging_spans:
        return None
    return 1e3 * run.staging_s / run.completed
