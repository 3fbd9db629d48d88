"""Mean wall of a recovery, reverify included: the pool's
`pool_recovery_total_ms` histogram, its sum and count over the window
(in a traced run, over the part after the trace)."""


def read(run):
    total, n = run["recover_ms"]
    return total / n if n else None
