"""RecurrentGemma / Griffin recurrent block: causal conv + RG-LRU (the
reference's models/rglru.py).

The RG-LRU is a gated diagonal linear recurrence
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t),
which trains with a parallel associative scan and decodes with an O(1)
state update.

The training scan (`_scan`) is the odd/even recursion of
`jax.lax.associative_scan`, the one the reference runs: combine adjacent
pairs, recurse on the result, fill in the even positions, interleave.
So the f32 products and sums run in the reference's order, each level is
a few whole-tensor operations (log2 S levels, no loop over time), and
autograd goes through the recursion's slices.  The gates read `wa`, `ba`,
`wx`, `bx` and `lam` in f32 straight from the parameters, as the
reference does; the projections run in the compute dtype.  The reference's
`gather_fsdp` is a no-op on one device and has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef

C_FACTOR = 8.0
CONV_WIDTH = 4


def rglru_defs(cfg) -> dict:
    d = cfg.d_model
    dr = d  # recurrent width = d_model (Griffin-2B choice)
    return {
        "wg": ParamDef((d, dr), cfg.param_dtype, ("embed", "rnn")),
        "wr": ParamDef((d, dr), cfg.param_dtype, ("embed", "rnn")),
        "wo": ParamDef((dr, d), cfg.param_dtype, ("rnn", "embed")),
        "conv_w": ParamDef((CONV_WIDTH, dr), cfg.param_dtype,
                           ("conv", "rnn"), init="scaled", scale=0.1),
        "conv_b": ParamDef((dr,), cfg.param_dtype, ("rnn",), init="zeros"),
        # per-channel gate projections (diagonal+bias, Griffin block-diag
        # simplified to channelwise)
        "wa": ParamDef((dr,), cfg.param_dtype, ("rnn",), init="scaled",
                       scale=0.5),
        "ba": ParamDef((dr,), cfg.param_dtype, ("rnn",), init="zeros"),
        "wx": ParamDef((dr,), cfg.param_dtype, ("rnn",), init="scaled",
                       scale=0.5),
        "bx": ParamDef((dr,), cfg.param_dtype, ("rnn",), init="zeros"),
        "lam": ParamDef((dr,), "float32", ("rnn",), init="scaled",
                        scale=0.2),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, logaddexp(x, 0) in its formula: max(x, 0) +
    log1p(exp(-|x|)).  (torch's softplus returns x above a threshold.)"""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def _gates(p: dict, u: torch.Tensor) -> tuple:
    """u: (..., dr) conv output -> (a, gated input) in f32."""
    uf = u.float()
    r = torch.sigmoid(uf * p["wa"].float() + p["ba"].float())
    i = torch.sigmoid(uf * p["wx"].float() + p["bx"].float())
    # softplus(lam - 4): initialized near 0.018 => a ~= exp(-0.14 r) in
    # [0.87, 1.0), the paper's "slow decay at init" regime
    decay = C_FACTOR * _softplus(p["lam"].float() - 4.0)
    a = torch.exp(-decay * r)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def _conv_train(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv, width 4, in x's dtype: the reference's four
    elementwise steps in its order.  x: (B, S, dr)."""
    dt = x.dtype
    w = p["conv_w"].to(dt)
    S = x.shape[1]
    out = x * w[CONV_WIDTH - 1]
    for i in range(1, CONV_WIDTH):
        shifted = torch.nn.functional.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[CONV_WIDTH - 1 - i]
    return out + p["conv_b"].to(dt)


def _combine(a1, b1, a2, b2) -> tuple:
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """(B, ne, ·), (B, no, ·) with ne in {no, no + 1} -> (B, ne + no, ·),
    even first."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n else out


def _scan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The inclusive scan of `_combine` over axis 1 by
    `jax.lax.associative_scan`'s recursion."""
    n = a.shape[1]
    if n < 2:
        return a, b
    # combine adjacent pairs, recurse on the reduced elements
    ra, rb = _combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2], a[:, 1::2],
                      b[:, 1::2])
    oa, ob = _scan(ra, rb)
    # the even positions after the first
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def apply_train(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = L.cdt(cfg)
    xd = x.to(dt)
    gate = L._gelu(L.matmul_f32(xd, p["wg"].to(dt))).to(dt)
    u = torch.matmul(xd, p["wr"].to(dt))
    u = _conv_train(p, u)
    a, b = _gates(p, u)
    _, h = _scan(a, b)
    out = torch.matmul(gate * h.to(dt), p["wo"].to(dt))
    return out.to(x.dtype)


def init_cache(cfg, batch: int, device=None) -> dict:
    dr = cfg.d_model
    return {
        "conv": torch.zeros((batch, CONV_WIDTH - 1, dr), dtype=L.cdt(cfg),
                            device=device),
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
    }


def apply_decode(p: dict, x: torch.Tensor, cache: dict, cfg) -> tuple:
    """x: (B, 1, D) -> (out (B, 1, D), cache).  O(1) a step.

    The new state is written into `cache` itself: the caller owns it (a
    fresh copy), never a staged or pool-held cache."""
    dt = L.cdt(cfg)
    xd = x.to(dt)
    gate = L._gelu(L.matmul_f32(xd, p["wg"].to(dt))).to(dt)[:, 0]
    u = torch.matmul(xd, p["wr"].to(dt))[:, 0]
    # conv over [cache, u]: the 4-tap product summed in f32, rounded once
    w = p["conv_w"].to(dt)
    hist = torch.cat([cache["conv"], u[:, None]], dim=1)     # (B, 4, dr)
    u_conv = (hist.float() * w.float()).sum(dim=1).to(dt) \
        + p["conv_b"].to(dt)
    a, b = _gates(p, u_conv)
    h = a * cache["h"] + b
    out = torch.matmul((gate * h.to(dt))[:, None], p["wo"].to(dt))
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    return out.to(x.dtype), cache
