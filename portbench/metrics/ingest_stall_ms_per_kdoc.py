"""Host ingest: milliseconds a 1,000 documents the main thread waited
for the ingest workers' next encoded chunk, from the program's
`pipeline.ingest_stall_seconds` counter."""


def read(run):
    pipeline = run.counters.get("pipeline") or {}
    if not run.docs or not pipeline.get("chunks_prefetched"):
        return None
    return pipeline["ingest_stall_seconds"] * 1e6 / run.docs
