"""Eager executor, host dispatch: kernels the card ran per query, counted in
torch.profiler's device trace over the profiled passes."""


def read(run):
    p = run.profile
    if p is None or not p.queries or not p.launches:
        return None
    return p.launches / len(p.queries)
