"""The kernels layer's tape: the share of the window's walks that ran as
their program's tape (one tape-kernel launch a dataflow level) rather
than op by op, from the program's `dispatch.walks_fused` and
`dispatch.walks_eager` counters, in percent."""


def read(run):
    dispatch = run.counters.get("dispatch") or {}
    fused, eager = dispatch.get("walks_fused"), dispatch.get("walks_eager")
    if fused is None or eager is None or fused + eager == 0:
        return None
    return 100.0 * fused / (fused + eager)
