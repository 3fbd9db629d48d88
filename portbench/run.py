"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (an entry of `workloads` in BENCHMARK.json) names a configuration
and a traffic mix; the mix names the driver that runs it.  Set-up builds
the program's kernels (the first run in a checkout compiles them into
`build/`), makes the state or weights on the device from the seed and
warms every shape the window uses.  The window then runs the traffic for
`--seconds`.  With `--trace 1` the cell's per-layer metrics are read
instead of its end-to-end ones: the device's from the profiler over the
window's first `TRACED_S` seconds, the host clocks' over the rest.  Once
the window has closed the run checks what the program produced against
the plain reference in `portbench/reference/` and prints each number
compared with its limit, on standard error and as the result line's last
key.  The last line of standard output is the result.

Exit codes: 0 with a result; 2 for bad arguments; 3 where the card or
cards the cell needs are missing; 4 where JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# seconds of the window a traced run profiles, from its start
TRACED_S = 10.0


def environment() -> None:
    """Caches inside the checkout at fixed paths; no Flax behind a
    library's back."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device=None, config_overrides: dict = None,
        mix_overrides: dict = None, fault: str = None,
        t_start: float = None) -> tuple:
    """One run of a cell: (result dict, checks).  `device` None means the
    card, which must be there; the tests pass the CPU and small
    `config_overrides` / `mix_overrides`.  `fault` plants one of the
    drivers' faults (tests and controls only)."""
    import torch
    from portbench import harness as H
    spec = H.load_spec()
    cell = H.find(spec["workloads"], workload, "workload")
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(3)
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(3)
        device = torch.device("cuda", 0)
    entry = H.find(spec["configs"], cell["config"], "config")
    cfg = H.load_json(H.ROOT / entry["file"])
    cfg.update(config_overrides or {})
    mix = H.load_json(H.traffic_path(cell["traffic"]))
    mix.update(mix_overrides or {})
    spans = H.Spans(traced=trace)
    drv = H.driver_module(mix["driver"]).Cell(cfg, mix, device, seed, spans)
    if fault is not None:
        drv.plant(fault)

    launches = H.Launches()
    drv.setup()
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tracer = H.DeviceTrace(trace, TRACED_S, cuda=on_card, launches=launches)
    try:
        tracer.start()
        rec = drv.window(seconds, tracer.tick if trace else None)
    finally:
        tracer.finish()
    tr = tracer.out
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    checks = drv.check(fault=fault)
    drv.free()

    run_rec = dict(rec, setup_s=setup_s, cfg=cfg, mix=mix,
                   launches=launches.records,
                   spans=spans.total,
                   trace=tr if (tr and on_card) else None, device=device)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in H.cell_metrics(spec, workload, kind):
        reader = H.load_module(H.metric_path(m["name"]),
                               "portbench_metric_" + m["name"]
                               .replace(".", "_").replace("-", "_"))
        value = reader.read(run_rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(0) if on_card
                    else device.type),
           "count": cell["chips"] if on_card else 1,
           "memory_peak_bytes": int(peak)}
    breakdown = None
    if tr:
        from portbench.reference import yardstick
        unknown = sorted({n for n, _, _ in launches.records
                          if n not in yardstick.BASE_OPS})
        print(f"trace: {tr['window_s']:.3f} s traced, {tr['device_events']} "
              f"device ops, {len(launches.records)} kernel launches"
              + (f" (no yardstick count for {', '.join(unknown)})"
                 if unknown else "")
              + f", read in {tr['reduce_s']:.1f} s", file=sys.stderr)
    if trace and on_card:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": dev,
              "breakdown": breakdown,
              "checks": {k: {"value": v, "limit": lim}
                         for k, (v, lim) in checks.items()},
              "readings": getattr(drv, "readings", {})}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    result, checks = run(args.workload, args.seed, args.seconds,
                         bool(args.trace))
    from portbench import harness as H
    if H.refuse_banned():
        return 4
    for name, v in result["readings"].items():
        print(f"reading {name}: {v}", file=sys.stderr)
    for name, (v, lim) in checks.items():
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    print(H.result_line(**{k: result[k] for k in (
        "correct", "attempted", "failed", "metrics", "device", "checks",
        "breakdown")}))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
