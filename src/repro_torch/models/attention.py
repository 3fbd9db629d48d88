"""GQA attention, the decode half (the reference's models/attention.py).

Decode attends one query against a linear or ring (sliding-window) cache.
GQA: queries are grouped as (B, K, g, hd) with g = H // K, so scores are
computed against un-broadcast KV heads.  The scores and `p·v` are kept in
f32, as the reference keeps them.  The chunked training attention and its
backward are not here: they belong to the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef

NEG_INF = -1e30


def attn_defs(cfg, cross: bool = False) -> dict:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    defs = {
        "wq": ParamDef((d, H, hd), cfg.param_dtype,
                       ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, K, hd), cfg.param_dtype,
                       ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, K, hd), cfg.param_dtype,
                       ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, d), cfg.param_dtype,
                       ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        defs["bq"] = ParamDef((H, hd), cfg.param_dtype,
                              ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((K, hd), cfg.param_dtype,
                              ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef((K, hd), cfg.param_dtype,
                              ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        defs["qnorm"] = ParamDef((hd,), cfg.param_dtype, ("head_dim",),
                                 init="ones")
        defs["knorm"] = ParamDef((hd,), cfg.param_dtype, ("head_dim",),
                                 init="ones")
    return defs


def _headnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) x (d, n, hd) -> (..., n, hd) in the compute dtype."""
    d, n, hd = w.shape
    return torch.matmul(x, w.reshape(d, n * hd)).reshape(
        *x.shape[:-1], n, hd)


def project_q(p: dict, x: torch.Tensor, cfg, positions, *,
              use_rope: bool = True, rope_table=None) -> torch.Tensor:
    dt = L.cdt(cfg)
    q = _heads(x.to(dt), p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    if "qnorm" in p:
        q = _headnorm(q, p["qnorm"])
    if use_rope:
        q = L.rope(q, positions, cfg.rope_theta, table=rope_table)
    return q


def project_kv(p: dict, x: torch.Tensor, cfg, positions, *,
               use_rope: bool = True, rope_table=None) -> tuple:
    dt = L.cdt(cfg)
    xd = x.to(dt)
    k = _heads(xd, p["wk"].to(dt))
    v = _heads(xd, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if "knorm" in p:
        k = _headnorm(k, p["knorm"])
    if use_rope:
        k = L.rope(k, positions, cfg.rope_theta, table=rope_table)
    return k, v


def apply_out(p: dict, attn: torch.Tensor, cfg) -> torch.Tensor:
    dt = L.cdt(cfg)
    wo = p["wo"].to(dt)
    H, hd, d = wo.shape
    a = attn.to(dt)
    return torch.matmul(a.reshape(*a.shape[:-2], H * hd),
                        wo.reshape(H * hd, d))


# ---------------------------------------------------------------------------
# decode (single query against a cache)
# ---------------------------------------------------------------------------

def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, slot_positions: torch.Tensor, pos,
                  *, window: Optional[int] = None) -> torch.Tensor:
    """q: (B,1,H,hd); caches: (B,T,K,hd); slot_positions: (T,) true position
    stored in each slot (-1 = empty).  Returns (B,1,H,hd)."""
    B, _, H, hd = q.shape
    T, K = k_cache.shape[1], k_cache.shape[2]
    g = H // K
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(B, K, g, hd).float()
    # each cache widened to f32 and laid out for the batched product in one
    # copy: (B, K, hd, T) for the scores, (B, K, T, hd) for p·v
    kt = k_cache.permute(0, 2, 3, 1).to(torch.float32,
                                        memory_format=torch.contiguous_format)
    s = torch.matmul(qr, kt) * scale
    valid = (slot_positions >= 0) & (slot_positions <= pos)
    if window is not None:
        valid &= slot_positions > pos - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vt = v_cache.permute(0, 2, 1, 3).to(torch.float32,
                                        memory_format=torch.contiguous_format)
    out = torch.matmul(p.to(q.dtype).float(), vt)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                slot_positions: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, pos: int, *,
                window: Optional[int] = None) -> tuple:
    """Write one step's k/v and position into the given caches in place,
    at `pos`'s slot (a ring slot under a window; clamped into the cache as
    the reference's dynamic_update_slice clamps it).  Only for caches the
    caller owns (a fresh copy): a staged or pool-held cache must never be
    written."""
    T = k_cache.shape[1]
    slot = min(max(pos % T if window is not None else pos, 0), T - 1)
    k_cache[:, slot] = k_new[:, 0]
    v_cache[:, slot] = v_new[:, 0]
    slot_positions[slot].fill_(pos)       # a fill: assigning would sync
    return k_cache, v_cache, slot_positions


def cache_update(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 slot_positions: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: int, *,
                 window: Optional[int] = None) -> tuple:
    """Insert one step's k/v at the (possibly ring-buffer) slot for `pos`,
    into new leaves: the given caches are not modified."""
    return cache_write(k_cache.clone(), v_cache.clone(),
                       slot_positions.clone(), k_new, v_new, int(pos),
                       window=window)
