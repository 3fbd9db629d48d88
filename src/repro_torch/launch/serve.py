"""Serving launcher: `PYTHONPATH=src python -m repro_torch.launch.serve
--arch <id>`.

Batched greedy decode with Pangolin protection of the KV cache (the
paper's small-update case: incremental checksums and parity patches), on
the card unless `--device cpu`.  The zone mesh is virtual (one device
holds every zone rank), so `--data` x `--model` is any shape.
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--data", type=int, default=4)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--protect", default="mlpc")
    ap.add_argument("--redundancy", type=int, default=1,
                    choices=[1, 2, 3, 4],
                    help="syndrome stack height r = rank losses survived "
                         "per zone: 1 = XOR parity, 2 adds the GF(2^32) "
                         "Q row, 3-4 add higher Vandermonde rows "
                         "(requires r <= data-axis size - 1)")
    ap.add_argument("--scrub-period", type=int, default=16)
    ap.add_argument("--window", type=int, default=1,
                    help="deferred-epoch window W for the KV cache "
                         "(1 = synchronous per-commit protection)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="async commit ring depth: decode commits "
                         "dispatch up to this many verdicts ahead of "
                         "resolution (1 = resolve per token)")
    ap.add_argument("--device", default="cuda",
                    help="the device every zone rank lives on (cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--metrics-dir", default=None,
                    help="publish the pool's metric registry "
                         "(server.prom + server.stats.json) here every "
                         "--metrics-every decode steps")
    ap.add_argument("--metrics-every", type=int, default=100)
    ap.add_argument("--trace-dir", default=None,
                    help="append the pool's JSONL span trace "
                         "(server.trace.jsonl) here")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the live Prometheus scrape endpoint "
                         "(obs.serve_metrics) on this port for the run "
                         "(0 = OS-assigned; the bound port is printed)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import obs, utils
    from repro_torch.configs.base import ProtectConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.sharding import ZoneMesh
    from repro_torch.runtime.server import Server

    dev = utils.resolve_device(args.device)
    mesh = ZoneMesh((args.data, args.model), ("data", "model"))
    cfg = get_config(args.arch, reduced=args.reduced)
    srv = Server(cfg, ProtectConfig(mode=args.protect, block_words=256,
                                    scrub_period=args.scrub_period,
                                    redundancy=args.redundancy,
                                    window=args.window,
                                    pipeline_depth=args.pipeline_depth),
                 mesh, batch=args.batch,
                 max_len=args.prompt_len + args.new_tokens + 1,
                 metrics_dir=args.metrics_dir, trace_dir=args.trace_dir,
                 metrics_every=args.metrics_every, device=dev)
    srv.start(srv.model.init(torch.Generator(dev).manual_seed(0), dev))
    scrape = None
    if args.metrics_port is not None and srv.pool is not None:
        scrape = obs.serve_metrics(srv.pool.metrics, port=args.metrics_port)
        print("metrics endpoint: "
              f"http://127.0.0.1:{scrape.server_address[1]}/metrics")
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator(dev).manual_seed(1),
                           device=dev)
    t0 = time.time()
    out = srv.generate(prompt, n_new=args.new_tokens)
    dt = time.time() - t0
    print(f"arch={cfg.name} generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s)")
    if srv.pool is not None:
        print("cache protection overhead:",
              srv.pool.overhead_report()["protection_fraction"])
        health = srv.pool.health()
        print(f"health: {health.status}"
              + (f" ({'; '.join(health.reasons)})"
                 if health.reasons else ""))
        if args.metrics_dir:
            paths = obs.write_metrics(srv.pool.metrics, args.metrics_dir,
                                      prefix="server",
                                      stats=srv.pool.stats())
            print(f"metrics: {paths['prom']}")
    if scrape is not None:
        scrape.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
