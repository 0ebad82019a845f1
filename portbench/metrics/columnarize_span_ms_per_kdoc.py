"""The device phase's columnarization: host milliseconds a 1,000
documents in the program's `columnarize` spans
(`CompiledRules.device_arrays` and `lit_values`, under each dispatch)."""


def read(run):
    if not run.docs or "columnarize" not in run.spans:
        return None
    return run.spans["columnarize"] * 1e6 / run.docs
