"""Time the PyTorch port's verified commits cold and warm on one GPU.

    python3 scripts/torch_warm_commits.py

Opens the main path's pool of chip_smoke.py (mlpc, r = 1, a zone of
G = 100 ranks holding 1.065 GB of rows), then for a bulk commit with
`verify_old` and a 16-page patch with `verify_old` runs one cold commit,
one warm commit, and one warm commit under `torch.profiler`.  Prints the
card's name and power limit, then one JSON line per kind of commit: the
wall ms of each of the three (host clock, ending in a synchronize) and
the six ops with the most host and device self time in the profiled one.
"""
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (adds src/ to the path)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_warm_commits: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Pool, ProtectConfig
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)

    mesh, specs, cur = smoke.zone_state(dev)
    pool = Pool.open(cur, specs, mesh=mesh, device=dev,
                     config=ProtectConfig(mode="mlpc"))
    patch, dirty = smoke.patch_pages(pool.protector.layout)

    def commit(new, kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smoke.check(bool(pool.commit(new, verify_old=True, **kw)), "commit")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def top(events, attr):
        rows = sorted(events, key=lambda e: getattr(e, attr), reverse=True)
        return [[e.key, getattr(e, attr) / 1e3] for e in rows[:6]]

    for tag, kw, words in (("bulk_verify", {}, None),
                           ("patch_verify", {"dirty_pages": dirty}, patch)):
        ms = []
        for _ in range(2):
            cur = smoke.bumped(cur, words)
            ms.append(commit(cur, kw))
        cur = smoke.bumped(cur, words)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ms.append(commit(cur, kw))
        smoke.invariants(pool, tag)
        events = prof.key_averages()
        smoke.emit(phase=tag, ms_cold=ms[0], ms_warm=ms[1], ms_profiled=ms[2],
                   top_self_cpu_ms=top(events, "self_cpu_time_total"),
                   top_self_device_ms=top(events, "self_device_time_total"))
    print(json.dumps({"ok": True}), flush=True)


if __name__ == "__main__":
    main()
