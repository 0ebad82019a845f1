"""The device phase's copies to the card: host milliseconds a 1,000
documents in the program's `h2d_copy` spans (the columns and literals,
one pageable copy each, under each dispatch)."""


def read(run):
    if not run.docs or "h2d_copy" not in run.spans:
        return None
    return run.spans["h2d_copy"] * 1e6 / run.docs
