"""95th percentile, by nearest rank, of the ring's tickets' dispatch to
resolve walls (`CommitTicket.resolve_latency_ms`) over the window (in a
traced run, the tickets dispatched after the trace)."""
from portbench import harness


def read(run):
    return harness.percentile(run.get("ticket_ms"), 95)
