"""Where the host time of an async commit's dispatch goes, on one GPU.

    python3 scripts/torch_dispatch_profile.py

On chip_smoke.py's main zone (G = 100 ranks, 1.065 GB of rows a pool):
a pool at mlpc, r = 3, pipeline depth 4, and a PoolGroup of four such
tenants in one cohort.  After two warm dispatches of each kind, one more
of each is dispatched into a ring that is not full under `torch.profiler`
(host and device activities): a bulk `commit_async`, a 16-page patch
`commit_async`, and a batched bulk wave (`PoolGroup.commit_async`).
Prints the card's name and power limit, then one JSON line a kind: the
dispatch's host ms (unprofiled, the median of three), the profiled
dispatch's count of ATen ops and of CUDA runtime calls by name, and the
eight ops with the most host self time.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (adds src/ to the path)

TENANTS = 4


def profiled(fn):
    """Run `fn` under the profiler; returns (ATen op count, CUDA runtime
    calls {name: count}, top 8 host self ms by op)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    events = prof.key_averages()
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    runtime = {e.key: e.count for e in events if e.key.startswith("cuda")}
    rows = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    return aten, runtime, [[e.key, e.self_cpu_time_total / 1e3, e.count]
                           for e in rows[:8]]


def report(kind, dispatch, ring, drain):
    """Three timed dispatches (each into a ring that is not full, drained
    after), then one profiled."""
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        smoke.check(len(ring) < ring.depth, f"{kind}: ring full")
        t0 = time.perf_counter()
        dispatch()
        ms.append((time.perf_counter() - t0) * 1e3)
        drain()
    torch.cuda.synchronize()
    aten, runtime, top = profiled(dispatch)
    drain()
    print(json.dumps({"kind": kind, "dispatch_ms": ms,
                      "median_ms": statistics.median(ms), "aten_ops": aten,
                      "cuda_runtime_calls": runtime, "top_host_ms": top}),
          flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_dispatch_profile: no CUDA device")
    from repro_torch import Pool, ProtectConfig
    from repro_torch.tenancy import PoolGroup
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)

    mesh, specs, cur = smoke.zone_state(dev)
    cfg = ProtectConfig(mode="mlpc", redundancy=smoke.R, pipeline_depth=4)
    pool = Pool.open(cur, specs, mesh=mesh, device=dev, config=cfg)
    patch, dirty = smoke.patch_pages(pool.protector.layout)
    state = {"cur": cur}

    def bulk():
        state["cur"] = smoke.bumped(state["cur"])
        pool.commit_async(state["cur"])

    def patch_commit():
        state["cur"] = smoke.bumped(state["cur"], words=patch)
        pool.commit_async(state["cur"], dirty_pages=dirty)
    for kind, fn in (("bulk_commit_async", bulk),
                     ("patch_16_commit_async", patch_commit)):
        for _ in range(2):
            fn()
        pool.drain()
        report(kind, fn, pool._ring, pool.drain)
    del pool, state, cur
    torch.cuda.empty_cache()

    mesh, specs, base = smoke.zone_state(dev)
    group = PoolGroup(mesh, device=dev, pipeline_depth=2)
    tids = [f"t{t}" for t in range(TENANTS)]
    cur = dict(zip(tids, smoke.tenant_states(base, TENANTS)))
    del base
    for tid in tids:
        group.admit(tid, cur[tid], specs, config=ProtectConfig(
            mode="mlpc", redundancy=smoke.R))

    def wave():
        for tid in tids:
            cur[tid] = smoke.bumped(cur[tid])
        group.commit_async(dict(cur))
    for _ in range(2):
        wave()
    group.drain()
    report(f"batched_wave_{TENANTS}_tenants", wave, group._ring, group.drain)


if __name__ == "__main__":
    main()
