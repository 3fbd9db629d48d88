"""Where a training step's time goes, on one GPU.

    python3 scripts/torch_train_profile.py

chip_smoke.py's `tr` trainer (qwen3-0.6b at full width, seq 1024 x batch
8, AdamW, the (4, 2) zone mesh), unprotected (mode none) and then
protected (mlpc, r = 1, window 1, depth 1).  After two warm steps, three
more are timed one by one with CUDA events around the step (device ms)
beside the host ms the step took, then one more runs under
`torch.profiler`.  Prints the card's name and power limit, then one JSON
line a trainer: the three (device ms, host ms) pairs, the profiled
step's kernel launches, its host self ms and device ms, its device ms by
kind of kernel (the names' first match in KINDS), and the twelve kernels
with the most device time.
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

# kinds of device work, by a substring of the kernel's name, first match
KINDS = (("gemm (f32 / tf32)", ("sgemm", "s1688", "f32f32", "tf32")),
         ("gemm (bf16)", ("gemm", "cutlass", "xmma", "nvjet")),
         ("copy", ("copy", "Memcpy", "memcpy", "Memset")),
         ("reduce", ("reduce", "Reduce")),
         ("protection kernels", ("fletcher", "commit_pages", "syndrome",
                                 "weight_words", "xor_words")),
         ("elementwise", ("elementwise", "vectorized", "unrolled",
                          "index", "scatter", "gather")))


def kind(name):
    for label, keys in KINDS:
        if any(k in name for k in keys):
            return label
    return "other"


def steps(t, n):
    out = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        a.record()
        t.step()
        b.record()
        host = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        out.append((a.elapsed_time(b), host))
    return out


def profiled(t):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t.step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    by_kind: dict = {}
    for e in kernels:
        k = kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {
        "launches": sum(e.count for e in kernels),
        "host_self_ms": sum(e.self_cpu_time_total for e in events) / 1e3,
        "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
        "device_ms_by_kind": by_kind,
        "top_device_ms": {e.key[:70]: [e.self_device_time_total / 1e3,
                                       e.count] for e in top}}


def main():
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import _build
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    cfg, mesh = smoke.tr_model()
    for mode in ("none", "mlpc"):
        t = smoke.tr_trainer(dev, cfg, mesh, mode=mode)
        steps(t, 2)
        timed = steps(t, 3)
        prof = profiled(t)
        print(json.dumps({"mode": mode, "steps_ms": timed, **prof}),
              flush=True)
        del t
        smoke.tr_free()


if __name__ == "__main__":
    main()
