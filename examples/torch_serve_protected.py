"""Serving demo: batched decode with Pangolin protection of the KV cache.

    PYTHONPATH=src python examples/torch_serve_protected.py \\
        [--tokens 48] [--batch 8] [--smoke] [--device cuda|cpu]

Decode is the paper's *atomic-style small update*: each step touches a tiny
known range of the cache, so the server's pool uses the incremental (patch)
side of the hybrid scheme — checksums refresh per dirty page, parity via
XOR patch.  Mid-stream, the demo corrupts the live cache and shows the
pool's scrub+repair keeping the generation identical to an uncorrupted
run.  The (4, 2) zone mesh lives on one device: the GPU by default, the
CPU with `--device cpu`.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import ZoneMesh, utils
from repro_torch.configs.base import ModelConfig, ProtectConfig
from repro_torch.models.transformer import build_model
from repro_torch.runtime import failure
from repro_torch.runtime.server import Server

CONFIG = ModelConfig(
    name="srv-demo", family="dense", n_layers=4, d_model=128, n_heads=8,
    n_kv=2, d_ff=256, vocab=1024, param_dtype="float32",
    compute_dtype="float32")


def main(argv=None):
    """Returns the generated tokens, the weights and the prompt."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (fewer tokens, smaller batch)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.tokens, args.batch = 16, 4
    device = utils.resolve_device(args.device)

    mesh = ZoneMesh((4, 2), ("data", "model"))
    cfg = CONFIG
    model = build_model(cfg, mesh)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    prompt = torch.randint(0, cfg.vocab, (args.batch, 8), device=device,
                           generator=torch.Generator(device).manual_seed(1))

    def server():
        srv = Server(cfg, ProtectConfig(mode="mlpc", block_words=256), mesh,
                     batch=args.batch, max_len=args.tokens + 16,
                     device=device)
        srv.start(params)
        return srv

    # reference: protected run with no faults
    ref_srv = server()
    t0 = time.time()
    ref = ref_srv.generate(prompt, n_new=args.tokens)
    dt = time.time() - t0
    print(f"reference generation: {args.batch}x{args.tokens} tokens "
          f"({args.batch * args.tokens / dt:.0f} tok/s) | cache overhead: "
          f"{ref_srv.pool.overhead_report()['protection_fraction']:.3f}")

    # faulted run: corrupt the live cache mid-generation, repair online
    srv = server()
    tok = srv.prefill(prompt)
    out = [tok.cpu().numpy()]
    for i in range(args.tokens - 1):
        if i == args.tokens // 2:
            srv.prot, _ = failure.inject_scribble(
                srv.protector, srv.prot, rank=2, word_offsets=[31, 77])
            rep = srv.pool.scrub()
            print(f"[token {i}] cache scribbled -> scrub found "
                  f"{rep.bad_locations}, repaired={rep.repair_ok}")
        tok = srv.step(tok)
        out.append(tok.cpu().numpy())
    got = np.stack(out, axis=1)
    assert np.array_equal(got, ref), "faulted run must match reference"
    print("faulted generation matches reference bit-for-bit — "
          "online cache repair is transparent to serving")
    return {"tokens": got, "params": params, "prompt": prompt}


if __name__ == "__main__":
    main()
