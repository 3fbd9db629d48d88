"""Mixture-of-Experts FFN with sort-based capacity dispatch (the
reference's models/moe.py).

Top-k routing -> the token copies sorted stably by expert ->
capacity-bucketed (G, E, C, d) products -> unsort + gate-weighted combine.
Copies past an expert's capacity go to a trash slot and contribute zeros,
Switch-style.  Routing runs in G groups, the mesh's data shards (as the
reference's, so every index stays group-local): the groups are a leading
batch axis here, where the reference vmaps over them.  A decode step
(S = 1) routes in one group and its capacity is the whole group, so it
never drops a token.

The top k are the first k of a stable descending sort, so equal
probabilities go to the lower expert as in `lax.top_k`, and the copies
are sorted by `argsort(stable=True)` as `jnp.argsort` sorts them: the
expert choices, slots and kept mask equal the reference's bit for bit on
equal inputs.  The reference's `inv.at[slot].set(mode="drop")` writes its
duplicates only into the trash slot, which is cut off: a scatter here
does the same.

Both sums whose order `index_add_` would leave to the card's atomics run
in a fixed order, so that a step gives the same bits on every run: the
dispatch gather's gradient (a token's k copies) sums through
`layers._RowGather`, and the combine adds each token's k contributions in
the order the reference's scatter-add meets them (the sorted order:
expert index ascending) through a (T, k, D) view.

The expert stacks are widened to f32 for the gate and up products a block
of experts at a time, each block's copy under `EXPERT_BLOCK_BYTES`:
maverick's stacks are 21.47 GB each in f32, moonshot's 0.74 GB (one
block).  Each expert's product is the same in any block.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef


def moe_defs(cfg) -> dict:
    m, d = cfg.moe, cfg.d_model
    E, f = m.num_experts, m.d_expert
    defs = {
        "router": ParamDef((d, E), "float32", ("embed_nofsdp", "experts"),
                           init="scaled", scale=0.02),
        "wi": ParamDef((E, d, f), cfg.param_dtype,
                       ("experts", "expert_in", "ffn")),
        "wg": ParamDef((E, d, f), cfg.param_dtype,
                       ("experts", "expert_in", "ffn")),
        "wo": ParamDef((E, f, d), cfg.param_dtype,
                       ("experts", "ffn", "expert_in")),
    }
    if m.shared_expert:
        defs["shared"] = L.mlp_defs(d, f, cfg)
    return defs


def _n_groups(mesh, T: int) -> int:
    """Routing groups: the mesh's data shards (pod x data), or 1 when
    they do not divide the T tokens or there is no mesh."""
    if mesh is None:
        return 1
    sizes = shd.axis_sizes(mesh)
    g = sizes.get("data", 1) * sizes.get("pod", 1)
    return g if T % g == 0 else 1


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest along the last axis, largest
    first, ties to the lower index (`lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_group(xt: torch.Tensor, router: torch.Tensor, E: int, k: int,
                 capacity: int, dt) -> tuple:
    """Routing of G groups at once: xt (G, Tg, D) -> the dispatch buffer
    (G, E, C, D) and the combine's indices, the reference's tuple with a
    leading group axis."""
    G, Tg, D = xt.shape
    logits = torch.matmul(xt.float(), router.float())      # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                 # (G, Tg, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    flat_expert = expert_idx.reshape(G, Tg * k)
    flat_gate = gate_vals.reshape(G, Tg * k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    src_token = order // k

    seg_start = torch.searchsorted(
        sorted_expert, torch.arange(E, device=xt.device).expand(G, E)
        .contiguous())
    at = torch.arange(Tg * k, device=xt.device)
    pos_in_seg = at - torch.gather(seg_start, 1, sorted_expert)
    keep = pos_in_seg < capacity
    slot = sorted_expert * capacity + torch.clamp(pos_in_seg,
                                                  max=capacity - 1)
    slot = torch.where(keep, slot, E * capacity)           # trash slot

    # dispatch: the token of every slot (the pad row Tg where none), then
    # a row gather; its gradient sums a token's copies in a fixed order
    inv = torch.full((G, E * capacity + 1), Tg, dtype=torch.long,
                     device=xt.device)
    inv.scatter_(1, slot, src_token)
    xt_ext = torch.cat([xt.to(dt), xt.new_zeros((G, 1, D), dtype=dt)], 1)
    rows = (inv[:, :-1] + torch.arange(G, device=xt.device)[:, None]
            * (Tg + 1))
    h = L._RowGather.apply(xt_ext.reshape(G * (Tg + 1), D), rows)
    return (h.reshape(G, E, capacity, D), slot, src_token, flat_gate, order,
            keep, probs, flat_expert, logits)


def _combine_group(y: torch.Tensor, slot: torch.Tensor, order: torch.Tensor,
                   flat_gate: torch.Tensor, k: int, dt) -> torch.Tensor:
    """y (G, E, C, D) -> (G, Tg, D) f32: each token's k expert outputs,
    gate-weighted, summed in the order of the sorted copies."""
    G, E, cap, D = y.shape
    n = slot.shape[1]                                       # Tg * k
    y_flat = torch.cat([y.reshape(G, E * cap, D),
                        y.new_zeros((G, 1, D))], 1)
    gathered = torch.gather(y_flat, 1, slot[..., None].expand(G, n, D))
    gate = torch.gather(flat_gate, 1, order)
    weighted = (gathered * gate[..., None].to(dt)).float()  # sorted order
    # token t's copies sit at ranks rank[t*k + j] of the sorted order; in
    # ascending rank they come in the reference's scatter-add order
    at = torch.arange(n, device=y.device).expand(G, n)
    rank = torch.empty_like(order).scatter_(1, order, at)
    pos = torch.sort(rank.reshape(G, n // k, k), dim=2).values
    parts = torch.gather(weighted, 1, pos.reshape(G, n, 1).expand(G, n, D))
    parts = parts.reshape(G, n // k, k, D)
    out = torch.zeros((G, n // k, D), dtype=torch.float32, device=y.device)
    for j in range(k):
        out = out + parts[:, :, j]
    return out


# the most bytes of expert weights one product widens to f32 at once
EXPERT_BLOCK_BYTES = 2 << 30


def _expert_mm(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, E, C, X) @ (E, X, Y) -> (G, E, C, Y), one product an expert
    (no copy of the weights a group)."""
    G, E, C, X = h.shape
    out = torch.bmm(h.transpose(0, 1).reshape(E, G * C, X), w)
    return out.reshape(E, G, C, -1).transpose(0, 1)


def _expert_blocks(w: torch.Tensor) -> list:
    """Slices of a stack's expert axis, each block's f32 copy at most
    EXPERT_BLOCK_BYTES (one expert at least)."""
    E = w.shape[0]
    n = max(1, EXPERT_BLOCK_BYTES // (4 * math.prod(w.shape[1:])))
    return [slice(lo, min(lo + n, E)) for lo in range(0, E, n)]


def _experts(p: dict, h: torch.Tensor, dt) -> torch.Tensor:
    """Every expert's MLP on its dispatch rows, h (G, E, C, D) -> (G, E,
    C, D): the gate and up products kept in f32, the down product's
    rounded to the compute dtype, as the reference's."""
    out = []
    for sl in _expert_blocks(p["wi"]):
        hb = h[:, sl]
        a = _expert_mm(hb.float(), p["wi"][sl].to(dt).float())
        gt = _expert_mm(hb.float(), p["wg"][sl].to(dt).float())
        out.append(_expert_mm((torch.nn.functional.silu(gt) * a).to(dt),
                              p["wo"][sl].to(dt)))
    return out[0] if len(out) == 1 else torch.cat(out, 1)


def apply_moe(p: dict, x: torch.Tensor, cfg, mesh=None) -> tuple:
    """x: (B, S, D) -> (out (B, S, D), aux losses dict)."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    B, S, D = x.shape
    T = B * S
    dt = L.cdt(cfg)
    G = _n_groups(mesh, T)
    Tg = T // G
    capacity = max(int(math.ceil(Tg * k / E * m.capacity_factor)), 1)
    if S == 1:
        # decode: never drop a token (worst case: a whole group on one
        # expert)
        capacity = Tg

    (h, slot, _, flat_gate, order, keep, probs, flat_expert,
     logits) = _route_group(x.reshape(G, Tg, D), p["router"], E, k,
                            capacity, dt)
    y = _experts(p, h, dt)
    out = _combine_group(y, slot, order, flat_gate, k, dt)
    out = out.to(x.dtype).reshape(B, S, D)
    if m.shared_expert:
        out = out + L.apply_mlp(p["shared"], x, cfg)

    # aux: Switch-style load balance + router z-loss, over every group
    me = probs.reshape(T, E).mean(dim=0)
    # the experts' counts (bincount's, whose length a meta trace cannot
    # know: the ids are below E, so E counts)
    ids = flat_expert.reshape(-1)
    assign = torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64)).float() \
        / (T * k)
    aux = {
        "load_balance": E * torch.sum(me * assign),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "dropped_fraction": 1.0 - keep.float().mean(),
    }
    return out, aux
