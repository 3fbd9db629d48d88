"""Share of the commit-program lookups that found a program already
built: 100 x (1 - the count of `txn.commit_build` over the count of
`txn.commit_program`), in the traced part of the window."""
from portbench import layers


def read(run):
    spans = layers.totals()
    n = layers.count(spans, "txn.commit_program")
    if not n:
        return None
    return 100.0 * (1.0 - layers.count(spans, "txn.commit_build") / n)
