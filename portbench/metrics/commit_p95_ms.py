"""95th percentile, by nearest rank over every commit of the window, of the
host wall from the call to `Pool.commit` to its verdict read."""
from portbench import harness


def read(run):
    return harness.percentile(run.get("latency_ms"), 95)
