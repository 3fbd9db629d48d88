"""Where a served decode step's time goes, on one GPU.

    python3 scripts/torch_serve_profile.py

chip_smoke.py's `sv` server (qwen3-0.6b at full width, batch 16, max_len
2048, (4, 2) zone mesh, block_words 256), unprotected and then protected
(mlpc, r = 1, window 1, depth 1).  After four warm steps, four more are
timed one by one with CUDA events around the step (device ms) beside the
host ms the step took to enqueue, then two more run under
`torch.profiler`.  Prints the card's name and power limit, then one JSON
line a server: the four (device ms, host ms) pairs, the two profiled
steps' CUDA runtime calls by name, their host self ms and device ms, and
the eight kernels (or copies) with the most device time.
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


def steps(srv, prompt, first, n):
    """Decode steps `first`..`first + n - 1` of the prompt, each timed:
    [(device ms, host enqueue ms)]."""
    out = []
    for t in range(first, first + n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        a.record()
        srv.step(prompt[:, t])
        b.record()
        host = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        out.append((a.elapsed_time(b), host))
    return out


def profiled(srv, prompt, first, n):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(first, first + n):
            srv.step(prompt[:, t])
        torch.cuda.synchronize()
    events = prof.key_averages()
    runtime = {e.key: e.count for e in events
               if e.key.startswith("cuda") and e.count}
    # the device's own events (kernels, copies); an ATen op's device time
    # is theirs again
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "cuda_runtime_calls": runtime,
        "host_self_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
        "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
        "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                          for e in top}}


def main():
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import _build
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    cfg, mesh, params, prompt = smoke.sv_model(dev)
    for protect in (False, True):
        srv = smoke.sv_server(dev, cfg, mesh, params, protect=protect)
        steps(srv, prompt, 0, 4)
        timed = steps(srv, prompt, 4, 4)
        prof = profiled(srv, prompt, 8, 2)
        print(json.dumps({"protected": protect, "steps_ms": timed,
                          "profiled_steps": 2, **prof}), flush=True)
        del srv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
