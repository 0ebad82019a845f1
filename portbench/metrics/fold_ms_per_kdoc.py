"""The sweep's fold: host milliseconds a 1,000 documents in the
program's `chunk_fold` spans (each chunk's tallies, record, journal
append and manifest line)."""


def read(run):
    if not run.docs or "chunk_fold" not in run.spans:
        return None
    return run.spans["chunk_fold"] * 1e6 / run.docs
