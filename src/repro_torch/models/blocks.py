"""Block registry (the reference's models/blocks.py), the types the port
builds:

  dense   — causal GQA attention + GLU MLP
  moe     — causal GQA attention + routed-expert FFN
  attn    — sliding-window attention + MLP (hybrid patterns)
  rglru   — RG-LRU recurrence + MLP (RecurrentGemma)
  mlstm   — xLSTM matrix-memory block (self-contained)
  slstm   — xLSTM scalar-memory block (self-contained)
  enc     — bidirectional attention + MLP (encoder stacks)
  dec_x   — causal self-attention + cross-attention + MLP (decoder stacks)

Each type provides defs / train (`apply_train`, the full sequence) /
decode (`apply_decode`, one token against the cache) / cache-init.  A moe
block routes a full sequence in the mesh's data-shard groups and a decode
step in one group, as the reference's.  A dec_x block's cross attention
reads the encoder's output in training and its projected K/V (the cross
cache, written once) in decode, with no rope and no mask.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod

ATTN_TYPES = ("dense", "moe", "attn", "enc", "dec_x")
XLSTM_TYPES = ("mlstm", "slstm")


def _check(btype: str) -> None:
    if btype not in ATTN_TYPES + XLSTM_TYPES + ("rglru",):
        raise ValueError(btype)


def block_defs(cfg, btype: str) -> dict:
    _check(btype)
    d = cfg.d_model
    if btype == "rglru":
        return {
            "ln1": L.rmsnorm_defs(d, cfg),
            "rec": rglru_mod.rglru_defs(cfg),
            "ln2": L.rmsnorm_defs(d, cfg),
            "ffn": L.mlp_defs(d, cfg.d_ff, cfg),
        }
    if btype == "mlstm":
        return {"cell": xlstm_mod.mlstm_defs(cfg)}
    if btype == "slstm":
        return {"cell": xlstm_mod.slstm_defs(cfg)}
    defs = {
        "ln1": L.rmsnorm_defs(d, cfg),
        "attn": attn_mod.attn_defs(cfg),
        "ln2": L.rmsnorm_defs(d, cfg),
        "ffn": (moe_mod.moe_defs(cfg) if btype == "moe"
                else L.mlp_defs(d, cfg.d_ff, cfg)),
    }
    if btype == "dec_x":
        defs["lnx"] = L.rmsnorm_defs(d, cfg)
        defs["xattn"] = attn_mod.attn_defs(cfg, cross=True)
    return defs


def _window_for(cfg, btype: str) -> Optional[int]:
    return cfg.window if btype == "attn" else None


def init_cache(cfg, btype: str, batch: int, max_len: int,
               device=None) -> dict:
    _check(btype)
    if btype == "rglru":
        return rglru_mod.init_cache(cfg, batch, device)
    if btype == "mlstm":
        return xlstm_mod.mlstm_init_state(cfg, batch, device)
    if btype == "slstm":
        return xlstm_mod.slstm_init_state(cfg, batch, device)
    cdt = L.cdt(cfg)
    K, hd, t = cfg.n_kv, cfg.hd, max_len
    w = _window_for(cfg, btype)
    if w is not None:
        t = min(t, w)
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
    if btype == "rglru":
        return {"conv": ("batch", None, "rnn"), "h": ("batch", "rnn")}
    if btype == "mlstm":
        return {"C": ("batch", "heads", None, None),
                "n": ("batch", "heads", None),
                "m": ("batch", "heads"),
                "conv": ("batch", None, "rnn")}
    if btype == "slstm":
        return {k: ("batch", "heads", "head_dim")
                for k in ("c", "n", "h", "m")}
    if tp > 1 and cfg.n_kv % tp == 0:
        kv, seq = "kv_heads", None
    else:
        kv, seq = None, "seq_shard"
    return {"k": ("batch", seq, kv, "head_dim"),
            "v": ("batch", seq, kv, "head_dim"),
            "pos": (None,)}


def _ffn(p: dict, x: torch.Tensor, cfg, btype: str = "dense",
         mesh=None) -> tuple:
    """The residual FFN every block ends with: (x + ffn(norm2(x)), aux
    losses).  A moe block routes in `mesh`'s groups (none: one group)."""
    h = L.apply_rmsnorm(p["ln2"], x)
    if btype == "moe":
        f, aux = moe_mod.apply_moe(p["ffn"], h, cfg, mesh)
    else:
        f, aux = L.apply_mlp(p["ffn"], h, cfg), {}
    return x + f.to(x.dtype), aux


def _cross_out(p: dict, x: torch.Tensor, o: torch.Tensor, cfg
               ) -> torch.Tensor:
    return x + attn_mod.apply_out(p["xattn"], o, cfg).to(x.dtype)


def _cross_q(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """A dec_x block's cross-attention query: norm `lnx`, no rope."""
    return attn_mod.project_q(p["xattn"], L.apply_rmsnorm(p["lnx"], x), cfg,
                              None, use_rope=False)


def apply_train(p: dict, btype: str, x: torch.Tensor, cfg, *,
                positions: torch.Tensor, rope_table=None, mesh=None,
                enc_out: Optional[torch.Tensor] = None,
                causal: bool = True) -> tuple:
    """Full-sequence application.  Returns (x, aux losses dict).
    `rope_table`: the positions' `layers.rope_table`, when the caller has
    it (shared by every layer).  `mesh`: the model's, whose data shards
    are a moe block's routing groups.  `enc_out`: the encoder's output
    (B, S_src, D) a dec_x block cross-attends to, unmasked; an enc block
    attends with no causal mask."""
    _check(btype)
    if btype == "rglru":
        h = L.apply_rmsnorm(p["ln1"], x)
        x = x + rglru_mod.apply_train(p["rec"], h, cfg).to(x.dtype)
        return _ffn(p, x, cfg)
    if btype == "mlstm":
        return x + xlstm_mod.mlstm_apply_train(p["cell"], x, cfg
                                               ).to(x.dtype), {}
    if btype == "slstm":
        return x + xlstm_mod.slstm_apply_train(p["cell"], x, cfg
                                               ).to(x.dtype), {}
    h = L.apply_rmsnorm(p["ln1"], x)
    q = attn_mod.project_q(p["attn"], h, cfg, positions,
                           rope_table=rope_table)
    k, v = attn_mod.project_kv(p["attn"], h, cfg, positions,
                               rope_table=rope_table)
    o = attn_mod.attend(q, k, v, causal=causal and btype != "enc",
                        window=_window_for(cfg, btype))
    x = x + attn_mod.apply_out(p["attn"], o, cfg).to(x.dtype)
    if btype == "dec_x":
        kx, vx = attn_mod.project_kv(p["xattn"], enc_out, cfg, None,
                                     use_rope=False)
        ox = attn_mod.attend(_cross_q(p, x, cfg), kx, vx, causal=False)
        x = _cross_out(p, x, ox, cfg)
    return _ffn(p, x, cfg, btype, mesh)


def decode_positions(pos: int, cfg, device) -> tuple:
    """(positions, rope table) of a decode step at `pos`, shared by every
    layer of the step.  The positions are filled on the device: a copy
    from the host would synchronize."""
    positions = torch.full((1,), int(pos), device=device)
    return positions, L.rope_table(positions, cfg.hd, cfg.rope_theta,
                                   device)


def apply_decode(p: dict, btype: str, x: torch.Tensor, cache: dict, pos,
                 cfg, positions: tuple, *,
                 cross_cache: Optional[dict] = None) -> tuple:
    """Single-token application.  x: (B, 1, D).  Returns (x, cache).

    The new slot is written into `cache` itself: the caller owns it (a
    fresh copy), never a staged or pool-held cache.  `positions`: the
    step's `decode_positions`, shared by every layer.  `cross_cache`: a
    dec_x block's {"k", "v"} (B, S_src, K, hd), read and never written;
    the query attends to all S_src slots (the reference's slot positions
    0..S_src-1 at position S_src)."""
    _check(btype)
    if btype == "rglru":
        h = L.apply_rmsnorm(p["ln1"], x)
        o, cache = rglru_mod.apply_decode(p["rec"], h, cache, cfg)
        return _ffn(p, x + o.to(x.dtype), cfg)[0], cache
    if btype in XLSTM_TYPES:
        step = (xlstm_mod.mlstm_apply_decode if btype == "mlstm"
                else xlstm_mod.slstm_apply_decode)
        o, cache = step(p["cell"], x, cache, cfg)
        return x + o.to(x.dtype), cache
    pos = int(pos)
    w = _window_for(cfg, btype)
    h = L.apply_rmsnorm(p["ln1"], x)
    positions, table = positions
    q = attn_mod.project_q(p["attn"], h, cfg, positions, rope_table=table)
    k, v = attn_mod.project_kv(p["attn"], h, cfg, positions,
                               rope_table=table)
    kc, vc, pc = attn_mod.cache_write(cache["k"], cache["v"], cache["pos"],
                                      k, v, pos, window=w)
    o = attn_mod.attend_decode(q, kc, vc, pc, pos, window=w)
    x = x + attn_mod.apply_out(p["attn"], o, cfg).to(x.dtype)
    if btype == "dec_x":
        kx, vx = cross_cache["k"], cross_cache["v"]
        src_len = kx.shape[1]
        ox = attn_mod.attend_decode(
            _cross_q(p, x, cfg), kx, vx,
            torch.arange(src_len, device=x.device), src_len)
        x = _cross_out(p, x, ox, cfg)
    # a moe block decodes in one group: capacity is the whole group
    return _ffn(p, x, cfg, btype)[0], {"k": kc, "v": vc, "pos": pc}
