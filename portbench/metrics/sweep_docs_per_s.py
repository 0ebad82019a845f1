"""The sweep: the documents of every invocation of the window over the
window's seconds, on the host's clock."""


def read(run):
    return run.docs / run.window_s
