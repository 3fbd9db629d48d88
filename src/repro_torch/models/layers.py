"""Shared neural building blocks: norms, RoPE, GLU MLPs, embeddings (the
reference's models/layers.py).

`*_defs(cfg)` declares parameters, `apply_*` consumes them.  Every product
takes its operands in `cfg.compute_dtype`.  Where the reference keeps a
product in f32 (`preferred_element_type=float32` and no cast back: the
MLP's gate and up projections, the logits) the port multiplies the
compute-dtype values in f32, which is exact per product and accumulates
in f32; where the reference casts the product back to the compute dtype,
a compute-dtype matmul (f32 accumulation) is the same function up to
summation order.  Norms and softmax run in f32.  The reference's
`gather_fsdp` is a no-op on one device and has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import ParamDef, torch_dtype


def cdt(cfg) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def pdt(cfg) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b kept in f32, as the reference's einsum with
    `preferred_element_type=float32`: the compute-dtype operands widened
    (exactly) and multiplied in f32."""
    return torch.matmul(a.float(), b.float())


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_defs(d: int, cfg) -> dict:
    return {"scale": ParamDef((d,), cfg.param_dtype, ("embed_nofsdp",),
                              init="ones")}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_table(positions, hd: int, theta: float, device) -> tuple:
    """(cos, sin) of the rotary angles, `(..., S, 1, hd // 2)` f32 for
    positions broadcastable to `(..., S)`: what `rope` rotates by, shared
    by every projection at the same positions."""
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    freq = torch.pow(float(theta), exps)         # no host-to-device copy
    positions = torch.as_tensor(positions, device=device)
    ang = positions[..., None].float() * freq            # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x: torch.Tensor, positions, theta: float, *, table=None
         ) -> torch.Tensor:
    """x: (..., S, n, hd); positions: broadcastable to (..., S).  `table`:
    the positions' `rope_table`, when the caller has it."""
    hd = x.shape[-1]
    half = hd // 2
    cos, sin = (table if table is not None
                else rope_table(positions, hd, theta, x.device))
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GLU MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_defs(d: int, ff: int, cfg) -> dict:
    return {
        "wi": ParamDef((d, ff), cfg.param_dtype, ("embed", "ffn")),
        "wg": ParamDef((d, ff), cfg.param_dtype, ("embed", "ffn")),
        "wo": ParamDef((ff, d), cfg.param_dtype, ("ffn", "embed")),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


_ACTS = {"silu": torch.nn.functional.silu, "gelu": _gelu,
         "relu": torch.relu}


def apply_mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    dt = cdt(cfg)
    xd = x.to(dt)
    h = matmul_f32(xd, p["wi"].to(dt))
    g = matmul_f32(xd, p["wg"].to(dt))
    h = (_ACTS[cfg.act](g) * h).to(dt)
    out = torch.matmul(h, p["wo"].to(dt))
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed_defs(cfg) -> dict:
    d = {"tok": ParamDef((cfg.vocab, cfg.d_model), cfg.param_dtype,
                         ("vocab", "embed"), init="scaled", scale=0.02)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab), cfg.param_dtype,
                                ("embed", "vocab"), init="scaled",
                                scale=0.02)
    return d


def row_sums(g: torch.Tensor, idx: torch.Tensor, rows: int
             ) -> torch.Tensor:
    """`(rows, D)` sums of the rows of `g` `(..., D)` by `idx` `(...)`, in
    the same order on every run: the rows sorted stably by index, an f64
    prefix sum down them, each index's sum read at its run's end and
    written to its own row (the other rows write a spare row, dropped).
    `index_add_` and the backward of indexing add with atomics on the
    card, whose order, and so whose float sum, changes between runs."""
    D = g.shape[-1]
    i = idx.reshape(-1).long()
    order = torch.argsort(i, stable=True)
    si = i[order]
    csum = torch.cumsum(g.reshape(-1, D)[order].double(), dim=0)
    n = si.shape[0]
    brk = si[1:] != si[:-1]
    at = torch.arange(n, device=g.device)
    start = torch.where(torch.cat([brk.new_ones(1), brk]), at, 0).cummax(
        0).values
    before = torch.where((start > 0)[:, None], csum[(start - 1).clamp(min=0)],
                         0.0)
    dest = torch.where(torch.cat([brk, brk.new_ones(1)]), si, rows)
    out = torch.zeros((rows + 1, D), dtype=g.dtype, device=g.device)
    out[dest] = (csum - before).to(g.dtype)
    return out[:rows]


class _RowGather(torch.autograd.Function):
    """`table[idx]` whose backward sums the rows with `row_sums`: a train
    step gives the same bits on every run."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return row_sums(g, idx, ctx.rows), None


def apply_embed(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """The rows of `tokens`, cast to the compute dtype (the reference casts
    the table, then gathers: the same values)."""
    return _RowGather.apply(p["tok"], tokens.long()).to(cdt(cfg))


def apply_unembed(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits in f32."""
    dt = cdt(cfg)
    if "unembed" in p:
        w = p["unembed"].to(dt)
    else:
        w = p["tok"].to(dt).T
    return matmul_f32(x.to(dt), w)
