"""Elastic rescale demo: move a protected training job between meshes.

    PYTHONPATH=src python examples/torch_elastic_rescale.py \\
        [--smoke] [--device cuda|cpu]

A job training on a (4, 2) mesh loses nodes and continues on (2, 2); later
it scales back up to (4, 2).  The divisibility-fallback sharding rules keep
the same model valid on every mesh; protection (zone geometry depends on G)
is rebuilt after each move by `Pool.rescale` — flush any open window,
reshard the state bit-exactly, rebuild parity/checksums on the new
geometry, carry the step counter — exactly as Pangolin rebuilds parity
when row geometry changes.  Loss history continues seamlessly across both
moves.  The zone meshes live on one device: the GPU by default, the CPU
with `--device cpu`.
"""
import argparse

import numpy as np

from repro_torch import ZoneMesh, utils
from repro_torch.configs.base import ModelConfig, ProtectConfig, TrainConfig
from repro_torch.runtime import failure
from repro_torch.runtime.trainer import Trainer


def make_trainer(mesh, device, seed=0):
    cfg = ModelConfig(
        name="elastic-demo", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=512, param_dtype="float32",
        compute_dtype="float32")
    return Trainer(cfg, TrainConfig(learning_rate=1e-3, warmup_steps=5,
                                    total_steps=200),
                   ProtectConfig(mode="mlpc", block_words=64),
                   mesh, seq_len=64, global_batch=8, seed=seed,
                   device=device)


def move(trainer_old, new_mesh, device):
    """Move the protected job: one `Pool.rescale` call does the flush,
    the bit-exact reshard, the protection rebuild on the new zone
    geometry and the host-side step-counter carry."""
    t_new = make_trainer(new_mesh, device, seed=0)
    t_new.pool = trainer_old.pool.rescale(new_mesh, into=t_new.pool)
    t_new.cursor = trainer_old.cursor
    return t_new


def main(argv=None):
    """Returns the loss of every step, across the three meshes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (fewer steps per phase)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = utils.resolve_device(args.device)
    n = 4 if args.smoke else 10

    mesh_full = ZoneMesh((4, 2), ("data", "model"))
    mesh_small = ZoneMesh((2, 2), ("data", "model"))

    t = make_trainer(mesh_full, device)
    t.initialize()
    losses = [o["loss"] for o in t.run(n)]
    print(f"phase 1 (4x2, G=4):  steps 1-{n},  loss -> {losses[-1]:.4f}, "
          f"parity overhead "
          f"{t.pool.overhead_report()['parity_fraction']:.3f}")

    # nodes evicted: shrink to 2x2 (G=2), protection rebuilt
    t = move(t, mesh_small, device)
    losses += [o["loss"] for o in t.run(n)]
    print(f"phase 2 (2x2, G=2):  steps {n + 1}-{2 * n}, loss -> "
          f"{losses[-1]:.4f}, parity overhead "
          f"{t.pool.overhead_report()['parity_fraction']:.3f}")

    # capacity restored: scale back up, verify recovery still works
    t = move(t, mesh_full, device)
    losses += [o["loss"] for o in t.run(n)]
    print(f"phase 3 (4x2, G=4):  steps {2 * n + 1}-{3 * n}, loss -> "
          f"{losses[-1]:.4f}")

    t.prot, ev = failure.inject_rank_loss(t.protector, t.prot, rank=1)
    rep = t.on_failure(ev)
    print(f"post-rescale rank loss: recovered, verified={rep['verified']}")

    if not args.smoke:         # too few steps to demand descent in CI
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), \
            "loss must decrease"
    assert t.pool.step == 3 * n
    print(f"elastic rescale demo passed: {3 * n} contiguous steps across "
          "3 meshes")
    return losses


if __name__ == "__main__":
    main()
