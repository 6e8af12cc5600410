"""Device: the share of the profiled passes' wall in which no kernel, copy
or set of memory ran on the card, from torch.profiler's device activity."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
