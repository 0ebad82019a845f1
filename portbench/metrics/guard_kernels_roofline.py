"""The hand-written kernels K1-K7 against their roofline: the bytes the
window's launches must move (harness/kernels.py, from each launch's
shape) at the card's published HBM rate, over the device time the trace
gives their kernels, in percent."""

from portbench.harness.kernels import hbm_bytes_per_s, wrapper_of


def read(run):
    peak = hbm_bytes_per_s(run.device_name)
    if peak is None or not run.launches:
        return None
    lo, hi = run.window
    seconds = sum(e.end - e.start for e in run.device_events
                  if lo <= e.start < hi and wrapper_of(e.name) is not None)
    if seconds <= 0:
        return None
    return 100.0 * sum(b for _name, b in run.launches) / peak / seconds
