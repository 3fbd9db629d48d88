"""End-to-end driver: train a ~100M-parameter qwen2-family model for a few
hundred steps with the full Pangolin protection stack, surviving injected
failures along the way.

    PYTHONPATH=src python examples/torch_train_fault_tolerant.py \\
        [--steps 300] [--mode mlpc] [--redundancy 1|2|3] [--d-model 512] \\
        [--no-faults] [--smoke] [--device cuda|cpu]

Timeline (default):
  step  60   silent scribble injected -> caught by the periodic scrub,
             repaired online, training unaffected
  step 120   rank loss (chip failure) -> SIGBUS-analog event -> freeze,
             parity reconstruction, resume — no checkpoint restore
  step 180   staged-buffer overrun -> canary aborts the commit; the step
             re-executes
  step 240   crash (process state dropped) -> restore newest checkpoint +
             replay the redo log; digests verify bit-exact replay

The (4, 2) zone mesh lives on one device: the GPU by default, the CPU
with `--device cpu`.
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch import ZoneMesh, utils
from repro_torch.configs.base import ModelConfig, ProtectConfig, TrainConfig
from repro_torch.runtime import failure
from repro_torch.runtime.trainer import Trainer


def build_cfg(d_model: int) -> ModelConfig:
    # qwen2-family block at ~100M scale (d=512: ~103M params with vocab 32k)
    return ModelConfig(
        name="qwen2-100m", family="dense", n_layers=8, d_model=d_model,
        n_heads=8, n_kv=2, d_ff=4 * d_model, vocab=32768, qkv_bias=True,
        param_dtype="float32", compute_dtype="float32")


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--mode", default="mlpc")
    ap.add_argument("--redundancy", type=int, default=1,
                    choices=[1, 2, 3],
                    help="syndrome stack height r (losses survived per "
                         "4-rank zone; r <= 3 here since G = 4)")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a fresh temp dir (stale checkpoints from "
                         "other configs must not be restored into this run)")
    ap.add_argument("--no-faults", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: a tiny model for a few dozen steps "
                         "through the same fault timeline")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps, args.d_model = 30, 64
        args.seq_len, args.batch = 64, 4
    return args


def make_trainer(args) -> Trainer:
    return Trainer(
        build_cfg(args.d_model),
        TrainConfig(learning_rate=1e-3, warmup_steps=20,
                    total_steps=args.steps),
        ProtectConfig(mode=args.mode, redundancy=args.redundancy,
                      scrub_period=50),
        ZoneMesh((4, 2), ("data", "model")), seq_len=args.seq_len,
        global_batch=args.batch, checkpoint_dir=args.ckpt_dir, seed=0,
        device=args.device)


def main(argv=None):
    """Returns the loss of every committed step."""
    args = parse(argv)
    utils.resolve_device(args.device)
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="pangolin_ckpt_")
    trainer = make_trainer(args)
    trainer.initialize()
    n_params = sum(x.numel() for x in
                   utils.tree_leaves(trainer.pool.state["params"]))
    print(f"model: {n_params / 1e6:.1f}M params | mode={args.mode} | "
          f"overhead: {trainer.pool.overhead_report()}")

    q = max(args.steps // 5, 1)
    faults = {} if args.no_faults else {
        q: "scribble", 2 * q: "rank_loss", 3 * q: "canary", 4 * q: "crash"}
    t0 = time.time()
    losses = []
    step = 0
    while step < args.steps:
        fault = faults.get(step)
        if fault == "scribble":
            trainer.prot, ev = failure.inject_scribble(
                trainer.protector, trainer.prot, rank=1,
                word_offsets=[1009, 4096])
            print(f"[{step}] injected silent scribble "
                  f"(will be caught by scrub at the period boundary)")
            # force an immediate scrub (as the periodic task would)
            rep = trainer.pool.scrub()
            print(f"[{step}] scrub: bad={rep.bad_locations} "
                  f"repaired={rep.repaired} verified={rep.repair_ok}")
        elif fault == "rank_loss":
            r = trainer.protector.redundancy
            if r >= 2:
                # a syndrome stack survives r simultaneous losses: take
                # down r ranks at once and solve them all
                dead = tuple(range(r))
                trainer.prot, ev = failure.inject_multi_rank_loss(
                    trainer.protector, trainer.prot, dead)
                rep = trainer.on_failure(ev)
                print(f"[{step}] ranks {list(dead)} lost -> online "
                      f"e={r}-erasure recovery verified={rep['verified']}")
            else:
                trainer.prot, ev = failure.inject_rank_loss(
                    trainer.protector, trainer.prot, rank=2)
                rep = trainer.on_failure(ev)
                print(f"[{step}] rank 2 lost -> online recovery "
                      f"verified={rep['verified']}")
        elif fault == "canary":
            out = trainer.step(canary_ok=False)
            print(f"[{step}] canary smash -> commit aborted "
                  f"(committed={out['committed']}); re-executing step")
        elif fault == "crash":
            trainer.save_checkpoint(wait=True)
            print(f"[{step}] simulated crash: restoring from checkpoint "
                  f"+ redo-log replay")
            info = trainer.restore_from_checkpoint()
            print(f"[{step}] restored step {info['restored_step']}, "
                  f"replayed {info['replayed']}")
        out = trainer.step()
        losses.append(out["loss"])
        step = out["step"]
        if step % 20 == 0:
            dt = time.time() - t0
            print(f"step {step:4d}  loss {out['loss']:.4f}  "
                  f"({step / dt:.2f} steps/s)")
        if step % 100 == 0:
            trainer.save_checkpoint()

    w = max(min(20, args.steps // 3), 1)
    first, last = np.mean(losses[:w]), np.mean(losses[-w:])
    print(f"\ndone: loss {first:.4f} -> {last:.4f} over {args.steps} steps "
          f"with {len(faults)} faults survived")
    if args.steps >= 60:
        assert last < first, "loss must decrease"
    return losses


if __name__ == "__main__":
    main()
