"""How far chip_smoke's tr i check sits from the port and from planted
faults, on the CPU at reduced widths.

    PYTHONPATH=src python3 scripts/torch_train_check_faults.py

tr i holds the bf16 train step's loss and gradients to a plain f32
forward and backward of the whole model (`chip_smoke.tr_grad_check`,
bounds TR_LOSS_RTOL and TR_GRAD_COS).  For qwen3-0.6b's reduced config
and a 4-layer, width-256 variant, both at bf16 compute, this prints one
JSON line a (model, fault): the loss's relative error, the smallest
gradient cosine of a leaf, and whether the check passes; the faults are
planted in the plain forward (every query head on the next KV head, no
causal mask, rope θ 1e4).
"""
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (adds src/ to the path)

FAULTS = (("none", {}), ("wrong_kv_head", {"kv_roll": 1}),
          ("no_causal_mask", {"causal": False}), ("theta_1e4", {"theta": 1e4}))


def main():
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import batch_for
    from repro_torch.models.transformer import build_model
    base = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                               compute_dtype="bfloat16")
    models = (("reduced", base),
              ("4 layers x 256", dataclasses.replace(
                  base, n_layers=4, d_model=256, n_heads=4, n_kv=2,
                  head_dim=64, d_ff=768, vocab=4096)))
    for label, cfg in models:
        params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                       "cpu")
        batch = batch_for(cfg, 128, 4, 0).device_batch(0, "cpu")
        for name, fault in FAULTS:
            got = smoke.tr_grad_check(cfg, params, batch, **fault)
            print(json.dumps({"model": label, "fault": name,
                              "loss_rel_err": got["loss_rel_err"],
                              "min_grad_cos": got["min_grad_cos"],
                              "passes": got["ok"]}), flush=True)


if __name__ == "__main__":
    main()
