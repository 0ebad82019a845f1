"""The device phase's wait: host milliseconds a 1,000 documents in the
program's `device_wait` spans (the wait on the walk's event and the
copies back, under each collect)."""


def read(run):
    if not run.docs or "device_wait" not in run.spans:
        return None
    return run.spans["device_wait"] * 1e6 / run.docs
