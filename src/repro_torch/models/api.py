"""Public model API (the reference's models/api.py, its serving half):
parameter counting and `make_decode_step`."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as prm
from repro_torch.models.transformer import Model, build_model


def count_params(cfg: ModelConfig) -> int:
    return prm.count(build_model(cfg).param_defs())


def make_decode_step(model: Model, sample: str = "greedy"):
    """serve_step: one new token against a full KV cache.  Returns
    (next tokens (B,) int32, logits (B, V) f32, new cache)."""
    if sample != "greedy":
        raise ValueError(sample)

    def decode_step(params, token, cache, pos):
        logits, cache = model.decode_step(params, token, cache, pos)
        # torch.argmax, as jnp.argmax, returns the first maximum
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return decode_step
