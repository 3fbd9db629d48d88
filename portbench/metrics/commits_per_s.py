"""Transactions whose verdict came back clean, over the whole window."""


def read(run):
    return run["clean"] / run["window_s"] if run.get("commits") else None
