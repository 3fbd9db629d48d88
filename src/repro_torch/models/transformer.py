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
interleaved with dense ones or not) families as a `Model`, and the audio
family (a config with `enc_layers > 0`) as an `EncDecModel`: a
bidirectional encoder over stub source embeddings and a causal decoder
that cross-attends to it, whose decode cache holds each decoder layer's
self-attention K/V and its cross K/V (`cross`, written once from the
encoder's output by `build_cross_cache`).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import utils
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import attention as attn_mod
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

PORTED_FAMILIES = ("dense", "vlm", "hybrid", "ssm", "moe", "audio")


def _run_groups(body, x, stacked, n: int, *args) -> tuple:
    """`body(x, *args, *group leaves) -> (x, aux)` over `n` stacked groups
    in order, each under `checkpoint` when there is more than one and
    gradients are on (the reference's `jax.checkpoint` of its scan body).
    `args` (tensors) and the leaves go in as inputs, so their gradients
    flow through the recomputation.  Returns (x, each group's aux)."""
    leaves, _ = utils.tree_flatten(stacked)
    layers = [w.unbind(0) for w in leaves]
    remat = n > 1 and torch.is_grad_enabled()
    auxs = []
    for i in range(n):
        gleaves = [layer[i] for layer in layers]
        if remat:
            x, aux = checkpoint(body, x, *args, *gleaves,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = body(x, *args, *gleaves)
        auxs.append(aux)
    return x, auxs


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
        _, treedef = utils.tree_flatten(params["groups"])
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

        x, auxs = _run_groups(group_body, x, params["groups"],
                              self.n_groups)
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
            if key.startswith("tail"):
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


class EncDecModel(Model):
    """Encoder-decoder (the seamless-m4t backbone): stub-embedded source
    -> bidirectional encoder; token target -> causal decoder with cross
    attention to the encoder's output.  `loss` is the decoder-only
    model's (next-token CE and the z-term; no aux, no stub prefix)."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__(cfg, mesh)
        self.enc_pattern = ("enc",)
        self.n_enc_groups = cfg.enc_layers
        self.pattern = ("dec_x",)
        self.n_groups = cfg.n_layers
        self.tail = ()

    def param_defs(self) -> PyTree:
        cfg = self.cfg
        return {
            "embed": L.embed_defs(cfg),
            "enc_groups": prm.stacked({"b0_enc": B.block_defs(cfg, "enc")},
                                      self.n_enc_groups),
            "enc_norm": L.rmsnorm_defs(cfg.d_model, cfg),
            "groups": prm.stacked({"b0_dec_x": B.block_defs(cfg, "dec_x")},
                                  self.n_groups),
            "final_norm": L.rmsnorm_defs(cfg.d_model, cfg),
        }

    def _stack(self, params, key, btype, x, n, enc_out=None):
        """`n` stacked groups of one `btype` block over x, rope from the
        positions 0..S-1; dec_x blocks cross-attend to `enc_out`."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)
        table = L.rope_table(positions, cfg.hd, cfg.rope_theta, x.device)
        _, treedef = utils.tree_flatten(params)
        cross = () if enc_out is None else (enc_out,)

        def body(x, *rest):
            gp = utils.tree_unflatten(treedef, rest[len(cross):])
            x, _ = B.apply_train(gp[key], btype, x, cfg,
                                 positions=positions, rope_table=table,
                                 enc_out=rest[0] if cross else None)
            return x, None
        return _run_groups(body, x, params, n, *cross)[0]

    def encode(self, params, src_embeds) -> torch.Tensor:
        """The source (B, S_src, D), cast to the compute dtype, through
        the encoder stack and `enc_norm`."""
        x = src_embeds.to(L.cdt(self.cfg))
        x = self._stack(params["enc_groups"], "b0_enc", "enc", x,
                        self.n_enc_groups)
        return L.apply_rmsnorm(params["enc_norm"], x)

    def hidden(self, params, batch) -> tuple:
        enc_out = self.encode(params, batch["src_embeds"])
        x = L.apply_embed(params["embed"], batch["tokens"], self.cfg)
        x = self._stack(params["groups"], "b0_dec_x", "dec_x", x,
                        self.n_groups, enc_out)
        x = L.apply_rmsnorm(params["final_norm"], x)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def _cache_defs(self, batch: int, max_len: int, device=None) -> PyTree:
        """The stacked self-attention cache and the cross K/V, (n_layers,
        batch, max_len, n_kv, hd) in the compute dtype, zeros until a
        prefill writes them."""
        cfg = self.cfg
        cache = super()._cache_defs(batch, max_len, device)
        shape = (self.n_groups, batch, max_len, cfg.n_kv, cfg.hd)
        cache["cross"] = {
            n: torch.zeros(shape, dtype=L.cdt(cfg), device=device)
            for n in ("k", "v")}
        return cache

    def cache_specs(self, batch: int, max_len: int, mesh=None) -> PyTree:
        """The self cache's specs, and the cross K/V's: KV heads on
        `model` when they divide it, else the source sequence."""
        mesh = mesh or self.mesh
        specs = super().cache_specs(batch, max_len, mesh)
        tp = shd.axis_sizes(mesh).get("model", 1)
        axes = ("layers",) + tuple(B.cache_logical_axes(self.cfg, "dec_x",
                                                        tp)["k"])
        shape = (self.n_groups, batch, max_len, self.cfg.n_kv, self.cfg.hd)
        specs["cross"] = {n: shd.spec_for(mesh, axes, shape,
                                          self.cfg.logical_overrides)
                          for n in ("k", "v")}
        return specs

    def build_cross_cache(self, params, enc_out) -> dict:
        """Each decoder layer's cross K/V of the encoder's output (the
        prefill step): {"k", "v"} (n_layers, B, S_src, n_kv, hd), projected
        a layer at a time into one buffer."""
        xattn = params["groups"]["b0_dec_x"]["xattn"]
        out = None
        for i in range(self.n_groups):
            k, v = attn_mod.project_kv(
                utils.tree_map(lambda w: w[i], xattn), enc_out, self.cfg,
                None, use_rope=False)
            if out is None:
                out = {n: t.new_empty((self.n_groups,) + tuple(t.shape))
                       for n, t in (("k", k), ("v", v))}
            out["k"][i], out["v"][i] = k, v
        return out

    def decode_step(self, params, token, cache, pos) -> tuple:
        """token: (B,) ints; pos: an int.  Returns (logits (B, V) f32, new
        cache).  The self cache is a fresh copy; the cross leaves are
        returned as given, as the reference returns them: a step never
        writes them, and no consumer writes a returned cache in place."""
        cfg = self.cfg
        pos = int(pos)
        x = L.apply_embed(params["embed"], token[:, None], cfg)
        at = B.decode_positions(pos, cfg, x.device)
        groups = utils.tree_map(torch.clone, cache["groups"])
        self_c, cross = groups["b0_dec_x"], cache["cross"]
        for i in range(self.n_groups):
            gp = utils.tree_map(lambda w: w[i],
                                params["groups"]["b0_dec_x"])
            x, _ = B.apply_decode(
                gp, "dec_x", x, {n: leaf[i] for n, leaf in self_c.items()},
                pos, cfg, at,
                cross_cache={n: leaf[i] for n, leaf in cross.items()})
        x = L.apply_rmsnorm(params["final_norm"], x)
        logits = L.apply_unembed(params["embed"], x, cfg)[:, 0]
        return logits, {"groups": groups, "cross": cross}


def build_model(cfg: ModelConfig, mesh=None) -> Model:
    """The model of `cfg`'s family: an `EncDecModel` when the config has
    an encoder (`enc_layers > 0`), else the decoder-only `Model`; a family
    the port does not know raises NotImplementedError and never falls
    back to another."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported (the "
            f"port builds {', '.join(PORTED_FAMILIES)} models)")
    if cfg.enc_layers > 0:
        return EncDecModel(cfg, mesh)
    return Model(cfg, mesh)
