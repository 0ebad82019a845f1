"""End to end: the seconds from the process's start to the window's
(imports, the card, the builds, the plan, the documents, the ingest
pool, one warm-up invocation)."""


def read(run):
    return run.setup_s
