"""The sweep's scans: host milliseconds a 1,000 documents in the
program's `sweep_scan` spans (the directory's listing, the manifest's
read and every chunk's signature, which stats each document again)."""


def read(run):
    if not run.docs or "sweep_scan" not in run.spans:
        return None
    return run.spans["sweep_scan"] * 1e6 / run.docs
