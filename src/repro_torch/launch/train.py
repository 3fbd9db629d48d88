"""Training launcher: `PYTHONPATH=src python -m repro_torch.launch.train
--arch <id>`.

Runs the fault-tolerant training loop (runtime/trainer.py) for any
architecture of the families the port builds, on the card unless
`--device cpu`.  The zone mesh is virtual (one device holds every zone
rank), so `--data` x `--model` is any shape.  Reduced configs
(`--reduced`, the default) train on the CPU; `--no-reduced` trains the
published width.  Prints the loss of every tenth step, the final step,
tokens/s over the run, and the pool's health.
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--data", type=int, default=4, help="data-axis size")
    ap.add_argument("--model", type=int, default=2, help="model-axis size")
    ap.add_argument("--protect", default="mlpc",
                    choices=["none", "ml", "mlp", "mlpc", "replica",
                             "mlp2", "mlpc2"])
    ap.add_argument("--redundancy", type=int, default=1,
                    choices=[1, 2, 3, 4],
                    help="syndrome stack height r = rank losses survived "
                         "per zone: 1 = XOR parity, 2 adds the GF(2^32) "
                         "Q row, 3-4 add higher Vandermonde rows "
                         "(requires r <= data-axis size - 1)")
    ap.add_argument("--scrub-period", type=int, default=50)
    ap.add_argument("--window", type=int, default=1,
                    help="deferred-epoch window W (1 = synchronous "
                         "per-commit protection)")
    ap.add_argument("--overlap-commit", action="store_true",
                    help="dispatch step t+1 before awaiting commit t "
                         "(shorthand for --pipeline-depth 2)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="async commit ring depth: up to this many "
                         "steps stay dispatched with unresolved "
                         "verdicts (1 = resolve every step)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--host-devices", type=int, default=8,
                    help="accepted for the reference's command line and "
                         "ignored: the reference forces this many CPU "
                         "host devices for its mesh, and here one device "
                         "holds the whole zone")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device every zone rank lives on (cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--metrics-dir", default=None,
                    help="publish the pool's metric registry "
                         "(trainer.prom + trainer.stats.json) here "
                         "every --metrics-every resolved steps")
    ap.add_argument("--metrics-every", type=int, default=25)
    ap.add_argument("--trace-dir", default=None,
                    help="append the pool's JSONL span trace "
                         "(trainer.trace.jsonl) here")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the live Prometheus scrape endpoint "
                         "(obs.serve_metrics) on this port for the run "
                         "(0 = OS-assigned; the bound port is printed)")
    args = ap.parse_args(argv)

    import torch
    from repro_torch import obs, utils
    from repro_torch.configs.base import ProtectConfig, TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.trainer import Trainer

    dev = utils.resolve_device(args.device)
    mesh = make_test_mesh(args.data, args.model)
    cfg = get_config(args.arch, reduced=args.reduced)
    trainer = Trainer(
        cfg,
        TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                    microbatches=args.microbatches,
                    optimizer=args.optimizer),
        ProtectConfig(mode=args.protect, scrub_period=args.scrub_period,
                      redundancy=args.redundancy, window=args.window,
                      overlap_commit=args.overlap_commit,
                      pipeline_depth=args.pipeline_depth),
        mesh, seq_len=args.seq_len, global_batch=args.global_batch,
        checkpoint_dir=args.ckpt_dir, seed=args.seed,
        metrics_dir=args.metrics_dir, trace_dir=args.trace_dir,
        metrics_every=args.metrics_every, device=dev)
    trainer.initialize()
    scrape = None
    if args.metrics_port is not None:
        scrape = obs.serve_metrics(trainer.pool.metrics,
                                   port=args.metrics_port)
        print("metrics endpoint: "
              f"http://127.0.0.1:{scrape.server_address[1]}/metrics")
    print(f"arch={cfg.name} mesh={dict(zip(mesh.axis_names, mesh.shape))} "
          f"protect={args.protect} "
          f"overhead={trainer.pool.overhead_report()}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    outs = trainer.run(args.steps, checkpoint_every=args.ckpt_every)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    for o in outs[:: max(args.steps // 10, 1)]:
        print(f"step {o['step']:5d}  loss {o['loss']:.4f}")
    print(f"final: step {outs[-1]['step']} loss {outs[-1]['loss']:.4f}")
    print(f"{args.steps} steps in {dt:.2f}s "
          f"({args.global_batch * args.seq_len * args.steps / dt:.1f} "
          "tok/s)")
    health = trainer.pool.health()
    print(f"health: {health.status}"
          + (f" ({'; '.join(health.reasons)})" if health.reasons else ""))
    if args.metrics_dir:
        paths = obs.write_metrics(trainer.pool.metrics, args.metrics_dir,
                                  prefix="trainer",
                                  stats=trainer.pool.stats())
        print(f"metrics: {paths['prom']}")
    if scrape is not None:
        scrape.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
