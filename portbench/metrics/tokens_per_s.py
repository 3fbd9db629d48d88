"""Generated tokens of every sequence, over the whole window."""


def read(run):
    return run["tokens"] / run["window_s"] if run.get("tokens") else None
