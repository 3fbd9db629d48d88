"""90th percentile, by nearest rank, of `Server.step`'s host walls over
the window, each ending in the step's tokens read on the host (in a
traced run, the steps after the trace)."""
from portbench import harness


def read(run):
    return harness.percentile(run.get("step_ms"), 90)
