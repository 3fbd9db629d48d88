"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) (the
reference's models/xlstm.py).

mLSTM trains with the chunkwise algorithm: within a chunk an
attention-like product weighted by the gates' decay matrix, across chunks
a recurrent (C, n, m) state carried by a loop over the chunks.  Decode is
an O(1) update of the same state.  Exponential gating is stabilized by the
running max term m, which starts at -1e30.

sLSTM's gates read h_{t-1}, so its training path is a loop over time, a
step a position (the reference's `lax.scan`).

Every product runs in the dtype the reference gives it: the projections
in the compute dtype, the gates, the recurrence and the state in f32.
Training casts q, k, v to the compute dtype before the scan widens them;
decoding keeps them in f32 (the reference does both).  The leaves the
reference reads in f32 whatever the compute dtype (`b_if`, `outnorm`,
`r_h`, `bias`) are read straight from the parameters.  The reference's
`gather_fsdp` is a no-op on one device and has no counterpart.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef

CONV_WIDTH = 4
CHUNK = 256

F = torch.nn.functional


class _Sigmoid(torch.autograd.Function):
    """`jax.nn.sigmoid` in its formula, 1 / (1 + exp(-x)), each step
    rounded to x's dtype (torch's sigmoid rounds once, a unit of bf16
    apart from it in a third of the values); its gradient s (1 - s), which
    stays finite where exp(-x) overflows."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * s * (1 - s)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Sigmoid.apply(x)


def _silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu`: x * sigmoid(x), each step in x's dtype."""
    return x * _sigmoid(x)


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.log_sigmoid`: -softplus(-x), softplus as logaddexp(x, 0)."""
    return -(torch.clamp(-x, min=0.0) + torch.log1p(torch.exp(-x.abs())))


def _norm_out(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The output norm over the last axis, in f32."""
    return (h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + 1e-6)
            * scale.float())


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_defs(cfg) -> dict:
    d = cfg.d_model
    di = 2 * d                       # projection factor 2
    h = cfg.n_heads
    dh = di // h
    return {
        "norm": L.rmsnorm_defs(d, cfg),
        "w_up": ParamDef((d, 2 * di), cfg.param_dtype, ("embed", "rnn")),
        "w_down": ParamDef((di, d), cfg.param_dtype, ("rnn", "embed")),
        "conv_w": ParamDef((CONV_WIDTH, di), cfg.param_dtype,
                           ("conv", "rnn"), init="scaled", scale=0.1),
        "conv_b": ParamDef((di,), cfg.param_dtype, ("rnn",), init="zeros"),
        # block-diagonal per-head q/k/v; v's output dim carries the
        # "mlstm_dh" logical axis, as in the reference
        "wq": ParamDef((h, dh, dh), cfg.param_dtype,
                       ("heads", "head_dim", None)),
        "wk": ParamDef((h, dh, dh), cfg.param_dtype,
                       ("heads", "head_dim", None)),
        "wv": ParamDef((h, dh, dh), cfg.param_dtype,
                       ("heads", "head_dim", "mlstm_dh")),
        "w_if": ParamDef((di, 2 * h), cfg.param_dtype, ("rnn", None),
                         init="scaled", scale=0.02),
        "b_if": ParamDef((2 * h,), "float32", (None,), init="zeros"),
        "outnorm": ParamDef((di,), cfg.param_dtype, ("rnn",), init="ones"),
    }


def _conv_train(xin: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv, width 4, in xin's dtype: the reference's
    four elementwise steps in its order.  xin: (B, S, di)."""
    S = xin.shape[1]
    conv = xin * w[CONV_WIDTH - 1]
    for i in range(1, CONV_WIDTH):
        shifted = F.pad(xin, (0, 0, i, 0))[:, :S]
        conv = conv + shifted * w[CONV_WIDTH - 1 - i]
    return conv


def _mlstm_qkvif(p: dict, x: torch.Tensor, cfg) -> tuple:
    """x: (B, S, D) -> q, k, v (B, S, H, dh) in the compute dtype, the
    i, f gate logits (B, S, H) f32, the z gate (B, S, di)."""
    dt = L.cdt(cfg)
    di = 2 * cfg.d_model
    h = cfg.n_heads
    dh = di // h
    xn = L.apply_rmsnorm(p["norm"], x)
    up = torch.matmul(xn.to(dt), p["w_up"].to(dt))
    xin, z = up[..., :di], up[..., di:]
    conv = _silu(_conv_train(xin, p["conv_w"].to(dt)) + p["conv_b"].to(dt))
    ch = conv.reshape(*conv.shape[:-1], h, dh)
    vh = xin.reshape(*xin.shape[:-1], h, dh)
    q = torch.einsum("bshe,hef->bshf", ch, p["wq"].to(dt))
    k = torch.einsum("bshe,hef->bshf", ch, p["wk"].to(dt))
    v = torch.einsum("bshe,hef->bshf", vh, p["wv"].to(dt))
    i_f = L.matmul_f32(conv, p["w_if"].to(dt)) + p["b_if"]
    return q, k, v, i_f[..., :h], i_f[..., h:], z


def _mlstm_chunk(carry: tuple, qc, kc, vc, il, fl, scale: float) -> tuple:
    """One chunk of the chunkwise mLSTM.  qc, kc, vc: (B, c, H, dh);
    il, fl: (B, c, H) f32; carry: C (B, H, dh, dh), n (B, H, dh),
    m (B, H) f32.  Returns (the state at the chunk's end, h (B, c, H, dh))."""
    C_in, n_in, m_in = carry
    c = qc.shape[1]
    logf = _log_sigmoid(fl)
    lc = torch.cumsum(logf, dim=1)                       # inclusive
    bmax = torch.cummax(il - lc, dim=1).values           # running max
    m_j = lc + torch.maximum(m_in[:, None, :], bmax)     # (B, c, H)
    # intra-chunk decay: D_js = lc_j - lc_s + i_s - m_j for s <= j
    djs = (lc[:, :, None, :] - lc[:, None, :, :]
           + il[:, None, :, :] - m_j[:, :, None, :])     # (B, c, c, H)
    # masked before the exp: above the diagonal D_js grows with s - j
    # (about 0.7 a position at init) and overflows past ~128 positions.
    # The reference masks after it, the same values, but the where's
    # gradient then meets exp's as 0 * inf: NaN at chunk 256.
    tri = torch.ones((c, c), dtype=torch.bool, device=qc.device).tril()
    dmat = torch.exp(torch.where(tri[None, :, :, None], djs, -math.inf))
    qf, kf, vf = qc.float(), kc.float(), vc.float()
    s = torch.einsum("bjhd,bshd->bjsh", qf, kf) * scale
    w = s * dmat
    num_intra = torch.einsum("bjsh,bshd->bjhd", w, vf)
    den_intra = torch.sum(w, dim=2)                      # (B, c, H)
    # inter-chunk: the carried state decayed by exp(lc_j + m_in - m_j)
    inter = torch.exp(lc + m_in[:, None, :] - m_j)
    qs = qf * scale
    num_inter = torch.einsum("bjhd,bhde->bjhe", qs, C_in) * inter[..., None]
    den_inter = torch.einsum("bjhd,bhd->bjh", qs, n_in) * inter
    num = num_intra + num_inter
    den = den_intra + den_inter
    h_out = num / torch.maximum(torch.abs(den), torch.exp(-m_j))[..., None]
    # the state at the chunk's end
    lc_end = lc[:, -1, :]                                # (B, H)
    m_out = lc_end + torch.maximum(m_in, bmax[:, -1, :])
    carry_f = torch.exp(lc_end + m_in - m_out)
    wgt = torch.exp(lc_end[:, None, :] - lc + il - m_out[:, None, :])
    C_out = (C_in * carry_f[..., None, None]
             + torch.einsum("bshd,bshe->bhde", wgt[..., None] * kf, vf))
    n_out = (n_in * carry_f[..., None]
             + torch.einsum("bsh,bshd->bhd", wgt, kf))
    return (C_out, n_out, m_out), h_out


def _mlstm_chunk_scan(q, k, v, i_log, f_log, state: tuple) -> tuple:
    """The chunkwise mLSTM over (B, nc, c, ...) chunks, a loop carrying
    (C, n, m) (the reference's `lax.scan`).  Returns the outputs
    (B, nc, c, H, dh) f32 and the final state."""
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    outs = []
    for j in range(q.shape[1]):
        state, h = _mlstm_chunk(state, q[:, j], k[:, j], v[:, j],
                                i_log[:, j], f_log[:, j], scale)
        outs.append(h)
    return torch.stack(outs, dim=1), state


def chunk_len(S: int) -> int:
    """The chunk length of a sequence of S: CHUNK, or S if shorter,
    shrunk until it divides S (a prime S gives 1)."""
    c = min(CHUNK, S)
    while S % c:
        c -= 1
    return c


def mlstm_init_state(cfg, batch: int, device=None) -> dict:
    di = 2 * cfg.d_model
    h = cfg.n_heads
    dh = di // h
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=f32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, di), dtype=L.cdt(cfg),
                            device=device),
    }


def mlstm_apply_train(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D) in x's dtype."""
    B, S, D = x.shape
    di = 2 * D
    q, k, v, il, fl, z = _mlstm_qkvif(p, x, cfg)
    c = chunk_len(S)
    nc = S // c

    def rs(t):
        return t.reshape(B, nc, c, *t.shape[2:])
    st = mlstm_init_state(cfg, B, x.device)
    outs, _ = _mlstm_chunk_scan(rs(q), rs(k), rs(v), rs(il), rs(fl),
                                (st["C"], st["n"], st["m"]))
    dt = L.cdt(cfg)
    hn = _norm_out(outs.reshape(B, S, di), p["outnorm"])
    gated = hn.to(dt) * _silu(z)
    out = torch.matmul(gated, p["w_down"].to(dt))
    return out.to(x.dtype)


def mlstm_apply_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> tuple:
    """x: (B, 1, D); the exact recurrent step.  Returns (out (B, 1, D),
    cache): the new state is written into `cache` itself, which the
    caller owns (a fresh copy), never a staged or pool-held cache."""
    B, _, D = x.shape
    di = 2 * D
    h = cfg.n_heads
    dh = di // h
    dt = L.cdt(cfg)
    xn = L.apply_rmsnorm(p["norm"], x)
    up = torch.matmul(xn.to(dt), p["w_up"].to(dt))
    xin, z = up[..., :di], up[..., di:]
    hist = torch.cat([cache["conv"], xin], dim=1)          # (B, 4, di)
    w = p["conv_w"].to(dt)
    # the 4-tap product summed in f32, rounded once
    conv = _silu((hist.float() * w.float()).sum(dim=1).to(dt)
                 + p["conv_b"].to(dt))
    ch = conv.reshape(B, h, dh).float()
    vh = xin[:, 0].reshape(B, h, dh).float()
    q = torch.einsum("bhe,hef->bhf", ch, p["wq"].to(dt).float())
    k = torch.einsum("bhe,hef->bhf", ch, p["wk"].to(dt).float())
    v = torch.einsum("bhe,hef->bhf", vh, p["wv"].to(dt).float())
    i_f = L.matmul_f32(conv, p["w_if"].to(dt)) + p["b_if"]
    il, fl = i_f[..., :h], i_f[..., h:]                   # (B, h)
    logf = _log_sigmoid(fl)
    m_new = torch.maximum(logf + cache["m"], il)
    i_p = torch.exp(il - m_new)
    f_p = torch.exp(logf + cache["m"] - m_new)
    C = (cache["C"] * f_p[..., None, None]
         + i_p[..., None, None] * k[..., :, None] * v[..., None, :])
    n = cache["n"] * f_p[..., None] + i_p[..., None] * k
    qf = q * (1.0 / math.sqrt(dh))
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.einsum("bhd,bhd->bh", qf, n)
    hout = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    hn = _norm_out(hout.reshape(B, di), p["outnorm"])
    gated = hn.to(dt) * _silu(z[:, 0])
    out = torch.matmul(gated, p["w_down"].to(dt))[:, None]
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    cache["m"].copy_(m_new)
    cache["conv"].copy_(hist[:, 1:])
    return out.to(x.dtype), cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_defs(cfg) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {
        "norm": L.rmsnorm_defs(d, cfg),
        "w_in": ParamDef((d, 4, h, dh), cfg.param_dtype,
                         ("embed", None, "heads", "head_dim")),
        "r_h": ParamDef((h, dh, 4, dh), cfg.param_dtype,
                        ("heads", "head_dim", None, "head_dim"),
                        init="scaled", scale=0.02),
        "bias": ParamDef((4, h, dh), "float32", (None, "heads", "head_dim"),
                         init="zeros"),
        "w_out": ParamDef((d, d), cfg.param_dtype, ("embed", "ffn")),
        "outnorm": ParamDef((d,), cfg.param_dtype, ("embed_nofsdp",),
                            init="ones"),
    }


def slstm_init_state(cfg, batch: int, device=None) -> dict:
    h = cfg.n_heads
    dh = cfg.d_model // h

    def full(v):
        return torch.full((batch, h, dh), v, dtype=torch.float32,
                          device=device)
    return {"c": full(0.0), "n": full(1e-6), "h": full(0.0),
            "m": full(-1e30)}


def _slstm_cell(p: dict, gates_x: torch.Tensor, state: dict) -> dict:
    """gates_x: (B, 4, h, dh) f32 input contribution; the state mixes in
    through r_h."""
    c, n, hs, m = state["c"], state["n"], state["h"], state["m"]
    rec = torch.einsum("bhd,hdge->bghe", hs, p["r_h"].float())
    g = gates_x + rec + p["bias"]
    zt = torch.tanh(g[:, 0])
    il = g[:, 1]
    fl = _log_sigmoid(g[:, 2])
    ot = _sigmoid(g[:, 3])
    m_new = torch.maximum(fl + m, il)
    i_p = torch.exp(il - m_new)
    f_p = torch.exp(fl + m - m_new)
    c_new = f_p * c + i_p * zt
    n_new = f_p * n + i_p
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_gates_x(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The input's gate contributions, (B, S, 4, h, dh) f32."""
    dt = L.cdt(cfg)
    xn = L.apply_rmsnorm(p["norm"], x)
    w_in = p["w_in"].to(dt)
    gx = L.matmul_f32(xn.to(dt), w_in.reshape(w_in.shape[0], -1))
    return gx.reshape(*x.shape[:2], *w_in.shape[1:])


def _slstm_out(p: dict, hs: torch.Tensor, x: torch.Tensor, cfg
               ) -> torch.Tensor:
    dt = L.cdt(cfg)
    hn = _norm_out(hs, p["outnorm"])
    return torch.matmul(hn.to(dt), p["w_out"].to(dt)).to(x.dtype)


def slstm_apply_train(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); the cell run a position at a time."""
    B, S, D = x.shape
    gx = _slstm_gates_x(p, x, cfg)
    state = slstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, gx[:, t], state)
        hs.append(state["h"])
    return _slstm_out(p, torch.stack(hs, dim=1).reshape(B, S, D), x, cfg)


def slstm_apply_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> tuple:
    """x: (B, 1, D) -> (out (B, 1, D), cache), the new state written into
    `cache` itself (the caller's fresh copy)."""
    B, _, D = x.shape
    state = _slstm_cell(p, _slstm_gates_x(p, x, cfg)[:, 0], cache)
    out = _slstm_out(p, state["h"].reshape(B, 1, D), x, cfg)
    for k, v in state.items():
        cache[k].copy_(v)
    return out, cache
