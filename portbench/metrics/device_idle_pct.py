"""The card: the share of the window in which no kernel, copy or memset
ran on it, from the profiler's trace, in percent."""


def read(run):
    if not run.busy or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - sum(t - s for s, t in run.busy) / run.window_s)
