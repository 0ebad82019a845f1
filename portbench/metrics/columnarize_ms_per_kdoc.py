"""The device phase's columnarization: host milliseconds a 1,000
documents inside `CompiledRules.device_arrays`, by the benchmark's own
timer around it."""


def read(run):
    seconds = run.timers.get("columnarize")
    if not run.docs or not seconds:
        return None
    return seconds * 1e6 / run.docs
