"""The sweep's journal: host milliseconds a 1,000 documents in the run
key (which reads every document again) and the per-chunk appends, from
the program's `journal_key` and `journal_append` spans."""


def read(run):
    names = ("journal_key", "journal_append")
    if not run.docs or not any(n in run.spans for n in names):
        return None
    return sum(run.spans.get(n, 0.0) for n in names) * 1e6 / run.docs
