"""The device phase's enqueue: host milliseconds a 1,000 documents in
the program's `walk_enqueue` spans (the walk's torch ops and kernel
launches, and K3's where a rim rides, under each dispatch)."""


def read(run):
    if not run.docs or "walk_enqueue" not in run.spans:
        return None
    return run.spans["walk_enqueue"] * 1e6 / run.docs
