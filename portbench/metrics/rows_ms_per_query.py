"""Result rows: mean milliseconds of ``Page.to_pylist()``, from the harness's
``rows`` spans over the traced window."""


def read(run):
    d = [s.t1 - s.t0 for s in run.spans if s.name == "rows"]
    return 1e3 * sum(d) / len(d) if d else None
