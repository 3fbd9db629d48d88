"""Mean host enqueue of a commit (no device sync): the pool's
`pool_commit_dispatch_ms` histogram, its sum and count over the window
(in a traced run, over the part after the trace)."""


def read(run):
    total, n = run["dispatch_ms"]
    return total / n if n else None
