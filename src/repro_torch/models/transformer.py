"""Model assembly: the decoder-only LM over the block registry (the
reference's models/transformer.py).

Parameters of each pattern position are stacked over a leading "layers"
axis (`groups`), as in the reference, so the parameter tree, the train
state and the KV cache have the reference's leaves and layouts word for
word: a pool's row over them is the reference's.  The full-sequence
forward runs the layer groups in order over the stacked leaves, each
group under `torch.utils.checkpoint` when there is more than one (the
reference's `jax.checkpoint` of its scan body): the backward recomputes a
group's activations from its input.  The stacked leaves are unbound once
a call, so every layer's gradient lands in its slice of the stacked leaf.
A multi-block pattern that does not divide the depth leaves a tail of
`n_layers % len(pattern)` blocks (`ModelConfig.tail_pattern`), run after
the groups, unrolled and not checkpointed, whose parameters and cache
leaves are not stacked (`tail{i}_{type}`), as in the reference.

Entry points:
    init(gen)                        -> params
    hidden(params, batch)            -> (x (B,S,D), aux)  backbone output
    forward(params, batch)           -> (logits, aux)     (train fwd & prefill)
    loss(params, batch)              -> (scalar, metrics)
    init_cache(batch, max_len)       -> cache tree
    cache_specs(batch, max_len)      -> partition specs of the cache
    decode_step(params, tok, cache, pos) -> (logits, new cache)

Routed-expert blocks add their auxiliary losses (load balance and router
z) to `hidden`'s aux, summed over the groups and the tail, and `loss`
weighs that aux by 0.01 when the config has experts, as the reference.

`build_model` builds the dense, vlm (dense blocks behind a prefix of
multimodal stub embeddings), hybrid (RG-LRU and sliding-window attention
blocks), ssm (mLSTM and sLSTM blocks) and moe (routed-expert blocks,
interleaved with dense ones or not) families; the encoder-decoder audio
family raises NotImplementedError, naming its slice.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import utils
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import params as prm

PyTree = Any

# the parameter leaves the model reads in f32 whatever the compute dtype:
# the norms' scales, the RG-LRU's gate weights and decay (`rglru._gates`),
# the mLSTM's gate bias and output norm, the sLSTM's recurrent weights,
# bias and output norm (`xlstm`), and the experts' router (`moe`); every
# other leaf it casts to the compute dtype
F32_LEAVES = ("scale", "qnorm", "knorm", "wa", "ba", "wx", "bx", "lam",
              "b_if", "outnorm", "r_h", "bias", "router")
AUX_LOSSES = ("load_balance", "router_z")
MOE_AUX_WEIGHT = 0.01

PORTED_FAMILIES = ("dense", "vlm", "hybrid", "ssm", "moe")


class Model(torch.nn.Module):
    """Decoder-only LM.  A parameter tree is passed to each call, as in
    the reference."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.pattern = cfg.pattern
        self.n_groups = cfg.n_groups
        self.tail = cfg.tail_pattern

    # -- parameter definitions -------------------------------------------------

    def param_defs(self) -> PyTree:
        cfg = self.cfg
        group = {f"b{j}_{t}": B.block_defs(cfg, t)
                 for j, t in enumerate(self.pattern)}
        defs = {
            "embed": L.embed_defs(cfg),
            "groups": prm.stacked(group, self.n_groups),
            "final_norm": L.rmsnorm_defs(cfg.d_model, cfg),
        }
        for i, t in enumerate(self.tail):
            defs[f"tail{i}_{t}"] = B.block_defs(cfg, t)
        return defs

    def param_specs(self, mesh=None) -> PyTree:
        return prm.spec_tree(self.param_defs(), mesh or self.mesh,
                             self.cfg.logical_overrides)

    def init(self, gen: torch.Generator, device=None) -> PyTree:
        """Random parameters from `gen` (a generator on `device`)."""
        return prm.init_params(self.param_defs(), gen, device)

    def compute_params(self, params: PyTree) -> PyTree:
        """`params` with every leaf the model casts to the compute dtype
        cast once: the same bits each step's cast gives."""
        dt = L.cdt(self.cfg)

        def cast(tree):
            return {k: (cast(v) if isinstance(v, dict)
                        else v if k in F32_LEAVES else v.to(dt))
                    for k, v in tree.items()}
        return cast(params)

    # -- embedding of (tokens, optional multimodal stub embeds) ---------------

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        x = L.apply_embed(params["embed"], batch["tokens"], cfg)
        if cfg.mm_positions:
            mm = batch["mm_embeds"].to(x.dtype)
            x = torch.cat([mm, x], dim=1)
        return x

    # -- full-sequence forward (training fwd / serving prefill) ----------------

    def hidden(self, params, batch) -> tuple:
        """Backbone output before unembedding: (x (B,S,D), aux_total)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)
        table = L.rope_table(positions, cfg.hd, cfg.rope_theta, x.device)
        leaves, treedef = utils.tree_flatten(params["groups"])
        layers = [w.unbind(0) for w in leaves]

        zero = torch.zeros((), dtype=torch.float32, device=x.device)

        def block(p, t, x, aux):
            x, terms = B.apply_train(p, t, x, cfg, positions=positions,
                                     rope_table=table, mesh=self.mesh)
            for k in AUX_LOSSES:
                if k in terms:
                    aux = aux + terms[k]
            return x, aux

        def group_body(x, *gleaves):
            gp = utils.tree_unflatten(treedef, gleaves)
            aux = zero
            for j, t in enumerate(self.pattern):
                x, aux = block(gp[f"b{j}_{t}"], t, x, aux)
            return x, aux

        remat = self.n_groups > 1 and torch.is_grad_enabled()
        auxs = []
        for i in range(self.n_groups):
            gleaves = [layer[i] for layer in layers]
            if remat:
                x, aux = checkpoint(group_body, x, *gleaves,
                                    use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = group_body(x, *gleaves)
            auxs.append(aux)
        aux_total = sum(auxs, zero)
        for i, t in enumerate(self.tail):
            x, aux_total = block(params[f"tail{i}_{t}"], t, x, aux_total)
        x = L.apply_rmsnorm(params["final_norm"], x)
        return x, aux_total

    def forward(self, params, batch) -> tuple:
        """(logits (B, S, V) f32, aux)."""
        x, aux_total = self.hidden(params, batch)
        return L.apply_unembed(params["embed"], x, self.cfg), aux_total

    def _chunked_ce(self, params, x, targets, valid) -> tuple:
        """CE over sequence chunks, so the full-vocab logits never
        materialize: each chunk's logits are recomputed in the backward
        (`checkpoint`), and only the chunk's input is kept.  Returns (mean
        CE, mean lse²) over the valid positions.

        x: (B, S, D) hidden; targets: (B, S) ids; valid: (B, S) bool."""
        cfg = self.cfg
        S = x.shape[1]
        c = min(512, S)
        while S % c:
            c -= 1

        def chunk_terms(xc, embed, tc, vf):
            lg = L.apply_unembed(embed, xc, cfg).float()
            lse = torch.logsumexp(lg, dim=-1)
            ll = torch.gather(lg, -1, tc[..., None].long())[..., 0]
            return torch.stack([torch.sum((lse - ll) * vf),
                                torch.sum((lse ** 2) * vf)])

        remat = torch.is_grad_enabled()
        sums = torch.zeros(2, device=x.device)
        n = torch.zeros((), device=x.device)
        for i in range(S // c):
            sl = slice(i * c, (i + 1) * c)
            vf = valid[:, sl].float()
            args = (x[:, sl], params["embed"], targets[:, sl], vf)
            sums = sums + (checkpoint(chunk_terms, *args, use_reentrant=False,
                                      preserve_rng_state=False)
                           if remat else chunk_terms(*args))
            n = n + torch.sum(vf)
        n = torch.clamp(n, min=1.0)
        return sums[0] / n, sums[1] / n

    def loss(self, params, batch) -> tuple:
        cfg = self.cfg
        x, aux = self.hidden(params, batch)
        # next-token CE on token positions (skip the mm stub prefix)
        x = x[:, cfg.mm_positions:, :]
        tokens = batch["tokens"]
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                            dim=1)
        valid = torch.ones(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
        valid[:, -1] = False
        ce, zterm = self._chunked_ce(params, x, targets, valid)
        z_loss = 1e-4 * zterm
        total = ce + z_loss
        # without routed experts the aux is 0 and weighs 0 (the
        # reference's moe_coef), so the total is ce + z_loss
        if cfg.moe is not None:
            total = total + MOE_AUX_WEIGHT * aux
        return total, {"ce": ce, "z_loss": z_loss, "aux": aux}

    # -- decode -----------------------------------------------------------------

    def _cache_defs(self, batch: int, max_len: int, device=None) -> PyTree:
        cfg = self.cfg
        groups = {}
        for j, t in enumerate(self.pattern):
            one = B.init_cache(cfg, t, batch, max_len, device)
            groups[f"b{j}_{t}"] = {
                n: x.expand(self.n_groups, *x.shape).contiguous()
                for n, x in one.items()}
        tail = {f"tail{i}_{t}": B.init_cache(cfg, t, batch, max_len, device)
                for i, t in enumerate(self.tail)}
        return {"groups": groups, **tail}

    def init_cache(self, batch: int, max_len: int, device=None) -> PyTree:
        """An empty cache on `device` (the card unless the caller asks for
        the CPU; "meta" gives the shapes only)."""
        return self._cache_defs(batch, max_len,
                                utils.resolve_device(device))

    def cache_specs(self, batch: int, max_len: int, mesh=None) -> PyTree:
        cfg = self.cfg
        mesh = mesh or self.mesh
        rules = cfg.logical_overrides
        tp = shd.axis_sizes(mesh).get("model", 1)

        def spec_of(btype, leafname, arr, stacked):
            axes = tuple(B.cache_logical_axes(cfg, btype, tp)[leafname])
            if stacked:
                axes = ("layers",) + axes
            return shd.spec_for(mesh, axes, arr.shape, rules)

        def specs_of(key, leaves, stacked):
            bt = key.split("_", 1)[1]
            return {ln: spec_of(bt, ln, arr, stacked)
                    for ln, arr in leaves.items()}

        cache = self._cache_defs(batch, max_len, "meta")
        specs = {"groups": {bk: specs_of(bk, leaves, True)
                            for bk, leaves in cache["groups"].items()}}
        for key, leaves in cache.items():
            if key != "groups":
                specs[key] = specs_of(key, leaves, False)
        return specs

    def decode_step(self, params, token, cache, pos) -> tuple:
        """token: (B,) ints; pos: an int.  Returns (logits (B, V) f32, new
        cache).  The new cache is a fresh copy: `cache` is not modified."""
        cfg = self.cfg
        pos = int(pos)
        x = L.apply_embed(params["embed"], token[:, None], cfg)
        at = B.decode_positions(pos, cfg, x.device)
        new_cache = utils.tree_map(torch.clone, cache)
        new_groups = new_cache["groups"]
        for i in range(self.n_groups):
            for j, t in enumerate(self.pattern):
                key = f"b{j}_{t}"
                gp = utils.tree_map(lambda w: w[i], params["groups"][key])
                gc = {n: leaf[i] for n, leaf in new_groups[key].items()}
                x, _ = B.apply_decode(gp, t, x, gc, pos, cfg, at)
        for i, t in enumerate(self.tail):
            key = f"tail{i}_{t}"
            x, _ = B.apply_decode(params[key], t, x, new_cache[key], pos,
                                  cfg, at)
        x = L.apply_rmsnorm(params["final_norm"], x)
        logits = L.apply_unembed(params["embed"], x, cfg)[:, 0]
        return logits, new_cache


def build_model(cfg: ModelConfig, mesh=None) -> Model:
    """The model of `cfg`'s family; a family whose blocks are not ported
    raises NotImplementedError and never falls back to another."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; it "
            "comes with slice S8c (the port builds "
            f"{', '.join(PORTED_FAMILIES)} models)")
    return Model(cfg, mesh)
