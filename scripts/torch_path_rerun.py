"""One of chip_smoke.py's card paths alone, or a study of its xt cell, on
one GPU.

    python3 scripts/torch_path_rerun.py path hybrid_serving_path [--root DIR]
    python3 scripts/torch_path_rerun.py path chaos_procs_path
    python3 scripts/torch_path_rerun.py xt-f32-batch1
    python3 scripts/torch_path_rerun.py xt-lr
    python3 scripts/torch_path_rerun.py decode-bits
    python3 scripts/torch_path_rerun.py mv-h

`path FN [FN ...]` builds the kernels and runs chip_smoke's path
functions `FN` in turn (their phase lines as chip_smoke prints them; a
path that raises prints its error as a line and the next one runs; the
script then exits 1, naming the paths that failed).  `--root DIR` takes
chip_smoke.py and src/ from the checkout at DIR, e.g. an unpacked older
commit: run the two commits in turn, in one call, to compare them on one
card.  `path chaos_procs_path` is zc alone: ch's quick campaign over four
worker processes against one process, then its phases g (a PoolGroup
rescaled 4 -> 2 -> 4 processes), r (a snapshot restored onto another
mesh) and e (a run that ends on two processes).

`xt-f32-batch1`: xt's path (xlstm-1.3b at one group, seq 4096, (4, 2),
protected) at batch 1 with the config's f32 AdamW moments, in place of
chip_smoke's batch 2 with bf16 moments.  An out-of-memory error is printed
as a line of its own, with the memory held when it struck.

`xt-lr`: xt's model and batch unprotected, four steps from the same
weights at each (moment dtype, learning rate) in XT_LR_RUNS, warmup 2 as
chip_smoke's trainers: each run's losses.  At lr 0 the weights stay put,
so the losses move with the batches alone.

`decode-bits`: sv's decode step (qwen3-0.6b at full width, batch 16,
bf16) against the same step taken four rows at a time, as a server split
over four processes takes it: whether the logits and the new cache are
the same bits (chip_smoke's `by_blocks`), and which of the decode's ops
give other bits by rows (chip_smoke's `zs_op_bits`).

`mv-h`: chip_smoke's mv model (llama4-maverick at full width, one
("dense", "moe") group) served unprotected at mv's batch and prompt, its
tokens then held by mv h's check in both forms: the f32 forward routed
by its own router, then by the decode's choices (`moe_reference`'s
`follow`).  A form that fails prints its error as a line.

Prints the card's name and power limit first, then one JSON line a phase
or a run.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

XT_LR_RUNS = (("bfloat16", 0.0), ("bfloat16", 1e-4), ("bfloat16", 1e-3),
              ("float32", 1e-3))
XT_LR_STEPS = 4


def smoke_from(root):
    """chip_smoke of the checkout at `root` (it adds its src/ to the
    path)."""
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke
    return chip_smoke


def xt_cfg(cs, **over):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(cs.XS_ARCH, reduced=cs.XT_REDUCED),
                               n_layers=cs.XT_LAYERS, **over)


def xt_f32_batch1(cs, dev):
    cfg = xt_cfg(cs)
    try:
        cs.trained_path(dev, cs.TrainCell(
            "xt_f32_b1", cfg, cs.XT_MESH, cs.XT_SEQ, 1, cs.XT_STEPS,
            cs.XT_SCRUB, cs.XT_LOST, cs.XT_LOSS_AT,
            lambda: cs.xlstm_params(cfg, dev), cs.PATH_XT,
            {"mlstm_chunk": cs.XT_PLAIN_CHUNK}))
    except torch.OutOfMemoryError as e:
        cs.emit(path="xt_f32_b1", outcome="out of memory",
                memory_allocated=torch.cuda.memory_allocated(),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                error=str(e).splitlines()[0])


def xt_lr(cs, dev):
    from repro_torch import ProtectConfig, ZoneMesh
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime.trainer import Trainer
    mesh = ZoneMesh(cs.XT_MESH, ("data", "model"))
    for moments, lr in XT_LR_RUNS:
        cfg = xt_cfg(cs, moment_dtype=moments)
        t = Trainer(cfg, TrainConfig(learning_rate=lr,
                                     warmup_steps=cs.TR_WARMUP,
                                     total_steps=cs.TR_TOTAL),
                    ProtectConfig(mode="none"), mesh, seq_len=cs.XT_SEQ,
                    global_batch=cs.XT_BATCH, seed=cs.SEED, device=dev)
        t.initialize(params=cs.xlstm_params(cfg, dev))
        losses = [float(t.step()["loss"]) for _ in range(XT_LR_STEPS)]
        cs.emit(path="xt_lr", moment_dtype=moments, learning_rate=lr,
                warmup_steps=cs.TR_WARMUP, losses=losses,
                max_memory_allocated=torch.cuda.max_memory_allocated())
        del t
        cs.tr_free()
        torch.cuda.reset_peak_memory_stats()


def decode_bits(cs, dev):
    from repro_torch import utils
    from repro_torch.models import api
    from repro_torch.models.transformer import build_model
    cfg, mesh, params, prompt = cs.sv_model(dev)
    model = build_model(cfg, mesh)
    decode = api.make_decode_step(model)
    blocks = cs.by_blocks(decode, model.cache_specs(
        cs.SV_BATCH, cs.SV_MAX_LEN, mesh), cs.ZS_WORLD)
    p = model.compute_params(params)
    cache = model.init_cache(cs.SV_BATCH, cs.SV_MAX_LEN, dev)
    out = {"batch": cs.SV_BATCH, "rows_a_block": cs.SV_BATCH // cs.ZS_WORLD}
    for pos in range(4):
        tok, logits, new = decode(p, prompt[:, pos], cache, pos)
        btok, blogits, bnew = blocks(p, prompt[:, pos], cache, pos)
        out[f"pos_{pos}"] = {
            "logits_equal": bool(torch.equal(blogits, logits)),
            "logits_max_abs_diff": float((blogits - logits).abs().max()),
            "tokens_equal": bool(torch.equal(btok, tok)),
            "cache_equal": all(torch.equal(a, b) for a, b in zip(
                utils.tree_leaves(bnew), utils.tree_leaves(new),
                strict=True))}
        cache = new
    out["op_bits_equal_by_rows"] = cs.zs_op_bits(dev, cfg)
    cs.emit(path="decode_bits", **out)


def mv_h(cs, dev):
    from repro_torch import ProtectConfig, ZoneMesh
    from repro_torch.configs.registry import get_config
    from repro_torch.runtime.server import Server
    cfg = dataclasses.replace(get_config(cs.MV_ARCH, reduced=cs.MV_REDUCED),
                              n_layers=cs.MV_LAYERS)
    params = cs.hybrid_params(cfg, dev)
    srv = Server(cfg, ProtectConfig(), ZoneMesh(cs.MV_MESH, ("data", "model")),
                 batch=cs.MV_BATCH, max_len=cs.MV_MAX_LEN,
                 protect_cache=False, device=dev)
    srv.start(params)
    prompt = torch.randint(0, cfg.vocab, (cs.MV_BATCH, cs.MV_PROMPT),
                           generator=torch.Generator(dev).manual_seed(
                               cs.SEED + 1), device=dev)
    toks = srv.generate(prompt, cs.MV_NEW)
    del srv
    for follow in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            out = cs.moe_reference(cfg, params, prompt, toks, cs.MV_MAX_LEN,
                                   cs.MV_H_CHUNK, follow=follow)
        except AssertionError as err:
            out = {"error": str(err)[:4000]}
        cs.emit(path="mv_h", follow=follow,
                max_memory_reserved=torch.cuda.max_memory_reserved(dev),
                **out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("path", "xt-f32-batch1", "xt-lr",
                                     "decode-bits", "mv-h"))
    ap.add_argument("fn", nargs="*", help="chip_smoke's path functions")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_path_rerun: no CUDA device")
    cs = smoke_from(args.root)
    from repro_torch.kernels import _build
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    if args.what == "path":
        failed = []
        for fn in args.fn:
            try:
                launches = getattr(cs, fn)(dev)
                print(json.dumps({"path_fn": fn, "root": args.root,
                                  "launches": launches}), flush=True)
            except Exception as err:  # noqa: BLE001 - the next path runs
                failed.append(fn)
                print(json.dumps({"path_fn": fn, "error": repr(err)[:4000]}),
                      flush=True)
        if failed:
            sys.exit(f"torch_path_rerun: failed: {', '.join(failed)}")
    elif args.what == "decode-bits":
        decode_bits(cs, dev)
    elif args.what == "mv-h":
        mv_h(cs, dev)
    elif args.what == "xt-f32-batch1":
        xt_f32_batch1(cs, dev)
    else:
        xt_lr(cs, dev)


if __name__ == "__main__":
    main()
