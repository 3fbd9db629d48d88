"""GQA attention (the reference's models/attention.py): chunked
(online-softmax) training path, KV-cache decode.

The training / prefill path `attend` is blockwise "flash"-style attention
in plain PyTorch: a loop over query tiles and, inside it, over KV tiles
with an online-softmax carry, so the score working set is one
(q_chunk x kv_chunk) tile instead of S^2.  Its backward (a
`torch.autograd.Function`, the reference's custom VJP) recomputes the
score tiles from (q, k, v, out, lse) and saves nothing else: autograd
through the loops would keep every tile.  Tiles whose mask is all False
(above the causal diagonal, before a window) are skipped: their softmax
weights are exactly 0 once a row has seen a live tile, as every causal
row has by its first tile.  Decode attends one query against a linear or
ring (sliding-window) cache.

GQA: queries are grouped as (B, K, g, ·) with g = H // K, so scores are
computed against un-broadcast KV heads.  The scores, `p·v` and every
gradient product are kept in f32, as the reference keeps them
(`preferred_element_type=float32` of compute-dtype operands: the port
widens the operands, exact per product), with the reference's casts: p
to q's dtype before `p·v`, ds to k's (q's) dtype before `ds·k` (`ds·q`).
The reference's `_tile_specs` / `_hint` are sharding hints for a mesh of
devices and have no counterpart on one device.
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
# chunked online-softmax attention (training / prefill)
# ---------------------------------------------------------------------------

def _pick_chunk(s: int, target: int) -> int:
    """The largest divisor of s that is at most `target`."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _tile_mask(causal: bool, window: Optional[int], qp: int, kp: int,
               qc: int, kc: int, device) -> Optional[torch.Tensor]:
    """(qc, kc) bool mask for a tile at query offset qp, key offset kp; None
    when every entry is live (the host's arithmetic on the offsets)."""
    lo, hi = qp - (kp + kc - 1), (qp + qc - 1) - kp    # range of q - k
    if (not causal or lo >= 0) and (window is None or hi < window):
        return None
    qpos = qp + torch.arange(qc, device=device)[:, None]
    kpos = kp + torch.arange(kc, device=device)[None, :]
    mask = torch.ones((qc, kc), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def _tile_live(causal: bool, window: Optional[int], qp: int, kp: int,
               qc: int, kc: int) -> bool:
    """Whether a tile has any unmasked entry."""
    lo, hi = qp - (kp + kc - 1), (qp + qc - 1) - kp
    return (not causal or hi >= 0) and (window is None or lo < window)


def _tiles(x: torch.Tensor, n: int, c: int, K: int, g: int) -> torch.Tensor:
    """(B, S, K*g, hd) -> (n, B, K, g*c, hd): query-tile i's rows grouped
    by KV head, head-group-major within a tile."""
    B, _, _, hd = x.shape
    return x.reshape(B, n, c, K, g, hd).permute(1, 0, 3, 4, 2, 5).reshape(
        n, B, K, g * c, hd)


def _untile(x: torch.Tensor, B: int, c: int, K: int, g: int
            ) -> torch.Tensor:
    """(n, B, K, g*c, hd) -> (B, n*c, K*g, hd)."""
    n, hd = x.shape[0], x.shape[-1]
    return x.reshape(n, B, K, g, c, hd).permute(1, 0, 4, 2, 3, 5).reshape(
        B, n * c, K * g, hd)


def _masked(s: torch.Tensor, mask: Optional[torch.Tensor], g: int
            ) -> torch.Tensor:
    """Scores (B, K, g*qc, kc) with the tile mask applied."""
    if mask is None:
        return s
    B, K, gq, kc = s.shape
    return torch.where(mask, s.reshape(B, K, g, gq // g, kc),
                       NEG_INF).reshape(B, K, gq, kc)


def _attend_fwd(q, k, v, causal, window, chunk) -> tuple:
    """Returns (out (B,S,H,hd) in q's dtype, lse (B,K,g,S) f32)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    scale = 1.0 / math.sqrt(hd)
    qc, kc = _pick_chunk(S, chunk), _pick_chunk(T, chunk)
    nq, nk = S // qc, T // kc
    qt = _tiles(q, nq, qc, K, g).float()
    kt = k.permute(0, 2, 3, 1).float()                 # (B, K, hd, T)
    vt = v.permute(0, 2, 1, 3).float()                 # (B, K, T, hd)
    outs, lses = [], []
    for i in range(nq):
        qi = qt[i]                                     # (B, K, g*qc, hd)
        m = torch.full((B, K, g * qc), NEG_INF, device=q.device)
        l = torch.zeros((B, K, g * qc), device=q.device)
        acc = torch.zeros((B, K, g * qc, hd), device=q.device)
        for j in range(nk):
            if not _tile_live(causal, window, i * qc, j * kc, qc, kc):
                continue
            s = torch.matmul(qi, kt[..., j * kc:(j + 1) * kc]) * scale
            s = _masked(s, _tile_mask(causal, window, i * qc, j * kc, qc, kc,
                                      q.device), g)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.matmul(p.to(q.dtype).float(),
                              vt[:, :, j * kc:(j + 1) * kc])
            acc = acc * corr[..., None] + pv
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        outs.append(acc / l_safe[..., None])
        lses.append(m + torch.log(l_safe))
    out = _untile(torch.stack(outs), B, qc, K, g).to(q.dtype)
    lse = torch.stack(lses).reshape(nq, B, K, g, qc).permute(
        1, 2, 3, 0, 4).reshape(B, K, g, S)
    return out, lse


def _attend_bwd(q, k, v, out, lse, dout, causal, window, chunk) -> tuple:
    """Flash backward: recompute score tiles; only lse was saved."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    g = H // K
    scale = 1.0 / math.sqrt(hd)
    qc, kc = _pick_chunk(S, chunk), _pick_chunk(T, chunk)
    nq, nk = S // qc, T // kc
    qt = _tiles(q, nq, qc, K, g).float()
    dot = _tiles(dout, nq, qc, K, g)
    kt = k.permute(0, 2, 3, 1).float()                 # (B, K, hd, T)
    kr = k.permute(0, 2, 1, 3).float()                 # (B, K, T, hd)
    vt = v.permute(0, 2, 3, 1).float()                 # (B, K, hd, T)
    # lse and D = rowsum(dout * out) as (nq, B, K, g*qc)
    lser = lse.reshape(B, K, g, nq, qc).permute(3, 0, 1, 2, 4).reshape(
        nq, B, K, g * qc)
    d_row = torch.sum(dout.float() * out.float(), dim=-1)  # (B, S, H)
    d_row = d_row.reshape(B, nq, qc, K, g).permute(1, 0, 3, 4, 2).reshape(
        nq, B, K, g * qc)
    dk = torch.zeros((B, K, T, hd), device=q.device)
    dv = torch.zeros((B, K, T, hd), device=q.device)
    dqs = []
    for i in range(nq):
        qi, doi = qt[i], dot[i].float()
        dq_i = torch.zeros((B, K, g * qc, hd), device=q.device)
        for j in range(nk):
            if not _tile_live(causal, window, i * qc, j * kc, qc, kc):
                continue
            ks = slice(j * kc, (j + 1) * kc)
            s = torch.matmul(qi, kt[..., ks]) * scale
            s = _masked(s, _tile_mask(causal, window, i * qc, j * kc, qc, kc,
                                      q.device), g)
            p = torch.exp(s - lser[i][..., None])      # (B, K, g*qc, kc)
            dp = torch.matmul(doi, vt[..., ks])
            ds = p * (dp - d_row[i][..., None]) * scale
            dq_i = dq_i + torch.matmul(ds.to(k.dtype).float(), kr[:, :, ks])
            dk[:, :, ks] += torch.matmul(
                ds.to(q.dtype).float().transpose(-1, -2), qi)
            dv[:, :, ks] += torch.matmul(
                p.to(dout.dtype).float().transpose(-1, -2), doi)
        dqs.append(dq_i)
    dq = _untile(torch.stack(dqs), B, qc, K, g).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _Attend(torch.autograd.Function):
    """`attend` with the reference's custom VJP: forward saves
    (q, k, v, out, lse) and the backward recomputes the score tiles."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        out, lse = _attend_fwd(q, k, v, causal, window, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attend_bwd(q, k, v, out, lse, dout.contiguous(),
                                 *ctx.cfg)
        return dq, dk, dv, None, None, None


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int] = None,
           chunk: int = 256) -> torch.Tensor:
    """Blockwise attention.  q: (B,S,H,hd); k,v: (B,T,K,hd) -> (B,S,H,hd).

    Query position i attends key position j under `causal` (j <= i) and
    `window` (i - j < window); positions are block-index-derived (both
    sequences start at position 0)."""
    return _Attend.apply(q, k, v, bool(causal), window, int(chunk))


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
