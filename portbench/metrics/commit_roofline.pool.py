"""The least time a commit needs for the bytes the protocol must move
(frozen yardstick, at 3.35 TB/s), over the host time spent in the pool's
commit calls a commit (call to verdict; with the ring, the dispatches and
the waits for verdicts), in a traced run over the part after the trace."""
from portbench.reference import yardstick, zone


def read(run):
    if not run.get("commits"):
        return None
    cfg, mix = run["cfg"], run["mix"]
    ranks = cfg["ranks"] * cfg["model"]
    sizes = {"data": cfg["ranks"], "model": cfg["model"]}
    words = 0
    for v in cfg["leaves"].values():
        n = 1
        for s, a in zip(v["shape"], list(v["spec"]) + [None] * 8):
            n *= s // (sizes[a] if a else 1)
        words += -(-n * (2 if v["dtype"] == "bfloat16" else 4) // 4)
    row = zone.row_words(words, cfg["ranks"], cfg["block_words"])
    payload = words * ranks
    least = yardstick.commit_least_bytes(
        ranks=ranks, row_words=row, block_words=cfg["block_words"],
        r=cfg["protect"]["redundancy"], state_words=payload,
        dirty_pages=mix["pages"] if mix["kind"] == "patch" else None)
    return yardstick.share(least / yardstick.HBM_BYTES_PER_S,
                           run["api_s"] / run["commits"])
