"""Block registry, the dense block (the reference's models/blocks.py):

  dense   — causal GQA attention + GLU MLP

Each type provides defs / train (`apply_train`, the full sequence) /
decode (`apply_decode`, one token against the cache) / cache-init.

The sliding-window, routed-expert, recurrent, xLSTM and encoder-decoder
types (attn, moe, rglru, mlstm, slstm, enc, dec_x) come with their
families' slice; asking for one raises NotImplementedError.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L

LATER = ("attn", "moe", "rglru", "mlstm", "slstm", "enc", "dec_x")


def _check(btype: str) -> None:
    if btype in LATER:
        raise NotImplementedError(
            f"block type {btype!r} is not ported yet: it comes with slice "
            "S8c (the moe, hybrid, ssm and encoder-decoder families)")
    if btype != "dense":
        raise ValueError(btype)


def block_defs(cfg, btype: str) -> dict:
    _check(btype)
    d = cfg.d_model
    return {
        "ln1": L.rmsnorm_defs(d, cfg),
        "attn": attn_mod.attn_defs(cfg),
        "ln2": L.rmsnorm_defs(d, cfg),
        "ffn": L.mlp_defs(d, cfg.d_ff, cfg),
    }


def init_cache(cfg, btype: str, batch: int, max_len: int,
               device=None) -> dict:
    _check(btype)
    cdt = L.cdt(cfg)
    K, hd, t = cfg.n_kv, cfg.hd, max_len
    return {
        "k": torch.zeros((batch, t, K, hd), dtype=cdt, device=device),
        "v": torch.zeros((batch, t, K, hd), dtype=cdt, device=device),
        "pos": torch.full((t,), -1, dtype=torch.int32, device=device),
    }


def cache_logical_axes(cfg, btype: str, tp: int = 1) -> dict:
    """Logical axes for cache leaves.

    Prefer sharding KV heads over the model axis; when the head count does
    not divide it, shard the cache's *sequence* dimension instead.
    """
    _check(btype)
    if tp > 1 and cfg.n_kv % tp == 0:
        kv, seq = "kv_heads", None
    else:
        kv, seq = None, "seq_shard"
    return {"k": ("batch", seq, kv, "head_dim"),
            "v": ("batch", seq, kv, "head_dim"),
            "pos": (None,)}


def apply_train(p: dict, btype: str, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, rope_table=None,
                causal: bool = True) -> tuple:
    """Full-sequence application.  Returns (x, aux losses dict).
    `rope_table`: the positions' `layers.rope_table`, when the caller has
    it (shared by every layer)."""
    _check(btype)
    h = L.apply_rmsnorm(p["ln1"], x)
    q = attn_mod.project_q(p["attn"], h, cfg, positions,
                           rope_table=rope_table)
    k, v = attn_mod.project_kv(p["attn"], h, cfg, positions,
                               rope_table=rope_table)
    o = attn_mod.attend(q, k, v, causal=causal)
    x = x + attn_mod.apply_out(p["attn"], o, cfg).to(x.dtype)
    h2 = L.apply_rmsnorm(p["ln2"], x)
    x = x + L.apply_mlp(p["ffn"], h2, cfg).to(x.dtype)
    return x, {}


def decode_positions(pos: int, cfg, device) -> tuple:
    """(positions, rope table) of a decode step at `pos`, shared by every
    layer of the step.  The positions are filled on the device: a copy
    from the host would synchronize."""
    positions = torch.full((1,), int(pos), device=device)
    return positions, L.rope_table(positions, cfg.hd, cfg.rope_theta,
                                   device)


def apply_decode(p: dict, btype: str, x: torch.Tensor, cache: dict, pos,
                 cfg, positions: tuple) -> tuple:
    """Single-token application.  x: (B, 1, D).  Returns (x, cache).

    The new slot is written into `cache` itself: the caller owns it (a
    fresh copy), never a staged or pool-held cache.  `positions`: the
    step's `decode_positions`, shared by every layer."""
    _check(btype)
    pos = int(pos)
    h = L.apply_rmsnorm(p["ln1"], x)
    positions, table = positions
    q = attn_mod.project_q(p["attn"], h, cfg, positions, rope_table=table)
    k, v = attn_mod.project_kv(p["attn"], h, cfg, positions,
                               rope_table=table)
    kc, vc, pc = attn_mod.cache_write(cache["k"], cache["v"], cache["pos"],
                                      k, v, pos)
    o = attn_mod.attend_decode(q, kc, vc, pc, pos)
    x = x + attn_mod.apply_out(p["attn"], o, cfg).to(x.dtype)
    h2 = L.apply_rmsnorm(p["ln2"], x)
    x = x + L.apply_mlp(p["ffn"], h2, cfg).to(x.dtype)
    return x, {"k": kc, "v": vc, "pos": pc}
