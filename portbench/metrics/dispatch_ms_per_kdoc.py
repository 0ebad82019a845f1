"""The device phase: host milliseconds a 1,000 documents in the
program's `dispatch` spans (columnarization, the copies to the card and
the walks' enqueue)."""


def read(run):
    if not run.docs or "dispatch" not in run.spans:
        return None
    return run.spans["dispatch"] * 1e6 / run.docs
