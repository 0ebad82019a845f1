"""End to end: the card's busy time in the window (the union of its
kernels, copies and memsets, from the profiler's trace) per 1,000
documents of the window's invocations, in milliseconds."""


def read(run):
    if not run.busy or run.docs <= 0:
        return None
    return 1e6 * sum(t - s for s, t in run.busy) / run.docs
