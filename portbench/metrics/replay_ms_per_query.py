"""Compiled tier: mean milliseconds of ``CompiledQuery.run()`` and a
synchronize, from the harness's ``replay`` spans over the traced window."""


def read(run):
    d = [s.t1 - s.t0 for s in run.spans if s.name == "replay"]
    return 1e3 * sum(d) / len(d) if d else None
