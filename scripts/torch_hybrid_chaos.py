"""How far recurrentgemma-2b's decode and train step at init sit from a
plain f32 forward, by depth and compute dtype, on the CPU at full width
(the vocabulary cut to 512 so that it runs on the CPU).

    PYTHONPATH=src python3 scripts/torch_hybrid_chaos.py

The reference's init draws each (d, heads, head_dim) projection with std
1/sqrt(heads), and recurrentgemma has no qk-norm, so its attention is
one-hot at init.  This prints one JSON line a measurement: the first
attention layer's q and score std on an rmsnorm-scaled input; for each
depth and compute dtype, the port's decode (its own greedy tokens
teacher-forced, `chip_smoke.sv_reference`) against `sv_plain_logits` —
the largest error as a share of the largest logit, the median and 99th
percentile of each position's, the argmax agreement; and the train step
(`chip_smoke.tr_grad_check`, one group) at f32 and bf16 compute against
the plain f32 step.  These are why chip_smoke's rg and rt serve and
train weights whose attention `chip_smoke.soft_attention` has scaled.
"""
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402  (adds src/ to the path)

DEPTHS = (3, 5, 8, 14, 26)
B, PROMPT, NEW = 4, 16, 16


def emit(**kw):
    print(json.dumps(kw), flush=True)


def decode_check(cfg, params):
    """The port's greedy tokens from a random prompt, teacher-forced back
    through its decode against the plain f32 forward."""
    from repro_torch.models.transformer import build_model
    model = build_model(cfg)
    cp = model.compute_params(params)
    prompt = torch.randint(0, cfg.vocab, (B, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    cache, out, tok = model.init_cache(B, cfg.window, "cpu"), [], None
    with torch.no_grad():
        for t in range(PROMPT + NEW - 1):
            logits, cache = model.decode_step(
                cp, prompt[:, t] if t < PROMPT else tok, cache, t)
            tok = torch.argmax(logits, -1)
            if t >= PROMPT - 1:
                out.append(tok)
        toks = torch.stack(out, 1).numpy()
        return smoke.sv_reference(cfg, params, prompt, toks, cfg.window,
                                  bound=None)


def main():
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import batch_for
    from repro_torch.models import attention as A
    from repro_torch.models.transformer import build_model
    full = dataclasses.replace(get_config("recurrentgemma-2b"), vocab=512)
    params = build_model(dataclasses.replace(full, n_layers=3)).init(
        torch.Generator().manual_seed(0), "cpu")
    p = {k: v[0] for k, v in params["groups"]["b2_attn"]["attn"].items()}
    h = torch.randn(1, 64, full.d_model,
                    generator=torch.Generator().manual_seed(2))
    h = h / h.pow(2).mean(-1, keepdim=True).sqrt()
    q, k = A._heads(h, p["wq"]), A._heads(h, p["wk"])
    scores = torch.einsum("bshd,btkd->bsht", q, k) / full.hd ** 0.5
    emit(measure="attention_at_init", q_std=float(q.std()),
         score_std=float(scores.std()))
    for depth in DEPTHS:
        params = build_model(dataclasses.replace(full, n_layers=depth)).init(
            torch.Generator().manual_seed(0), "cpu")
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(full, n_layers=depth,
                                      compute_dtype=dtype)
            got = decode_check(cfg, params)
            emit(measure="decode", layers=depth, compute_dtype=dtype,
                 **{k: got[k] for k in (
                     "rel_err", "median_position_rel_err",
                     "p99_position_rel_err", "argmax_agree")})
    cfg = dataclasses.replace(full, n_layers=3)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    batch = batch_for(cfg, 128, 2, 0).device_batch(0, "cpu")
    for dtype in ("float32", "bfloat16"):
        got = smoke.tr_grad_check(dataclasses.replace(
            cfg, compute_dtype=dtype), params, batch)
        emit(measure="train_step", layers=3, compute_dtype=dtype,
             loss_rel_err=got["loss_rel_err"],
             min_grad_cos=got["min_grad_cos"])


if __name__ == "__main__":
    main()
