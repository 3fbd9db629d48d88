"""Model assembly: the decoder-only LM over the block registry (the
reference's models/transformer.py, its decode half).

Parameters of each pattern position are stacked over a leading "layers"
axis (`groups`), as in the reference, so the parameter tree and the KV
cache have the reference's leaves and layouts word for word: a pool's row
over the cache is the reference's.  (The reference's unstacked tail
blocks, `n_layers % len(pattern)`, exist only for the multi-block
patterns of the families this slice does not build.)

Entry points:
    init(gen)                        -> params
    init_cache(batch, max_len)       -> cache tree
    cache_specs(batch, max_len)      -> partition specs of the cache
    decode_step(params, tok, cache, pos) -> (logits, new cache)

`build_model` builds the dense family; the others (moe, hybrid, ssm,
encoder-decoder, vlm, audio) raise NotImplementedError, naming their
slice.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import utils
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import params as prm

PyTree = Any

# the parameter leaves the model reads in f32 whatever the compute dtype
# (the norms' scales); every other leaf it casts to the compute dtype
F32_LEAVES = ("scale", "qnorm", "knorm")

PORTED_FAMILIES = ("dense",)


class Model(torch.nn.Module):
    """Decoder-only LM.  A parameter tree is passed to each call, as in
    the reference; `forward` is `decode_step`."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.pattern = cfg.pattern
        self.n_groups = cfg.n_groups

    # -- parameter definitions -------------------------------------------------

    def param_defs(self) -> PyTree:
        cfg = self.cfg
        group = {f"b{j}_{t}": B.block_defs(cfg, t)
                 for j, t in enumerate(self.pattern)}
        return {
            "embed": L.embed_defs(cfg),
            "groups": prm.stacked(group, self.n_groups),
            "final_norm": L.rmsnorm_defs(cfg.d_model, cfg),
        }

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

    # -- decode -----------------------------------------------------------------

    def _cache_defs(self, batch: int, max_len: int, device=None) -> PyTree:
        cfg = self.cfg
        groups = {}
        for j, t in enumerate(self.pattern):
            one = B.init_cache(cfg, t, batch, max_len, device)
            groups[f"b{j}_{t}"] = {
                n: x.expand(self.n_groups, *x.shape).contiguous()
                for n, x in one.items()}
        return {"groups": groups}

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

        def spec_of(btype, leafname, arr):
            axes = ("layers",) + tuple(
                B.cache_logical_axes(cfg, btype, tp)[leafname])
            return shd.spec_for(mesh, axes, arr.shape, rules)

        groups = self._cache_defs(batch, max_len, "meta")["groups"]
        return {"groups": {
            bk: {ln: spec_of(bk.split("_", 1)[1], ln, arr)
                 for ln, arr in leaves.items()}
            for bk, leaves in groups.items()}}

    def decode_step(self, params, token, cache, pos) -> tuple:
        """token: (B,) ints; pos: an int.  Returns (logits (B, V) f32, new
        cache).  The new cache is a fresh copy: `cache` is not modified."""
        cfg = self.cfg
        pos = int(pos)
        x = L.apply_embed(params["embed"], token[:, None], cfg)
        at = B.decode_positions(pos, cfg, x.device)
        new_groups = utils.tree_map(torch.clone, cache["groups"])
        for i in range(self.n_groups):
            for j, t in enumerate(self.pattern):
                key = f"b{j}_{t}"
                gp = utils.tree_map(lambda w: w[i], params["groups"][key])
                gc = {n: leaf[i] for n, leaf in new_groups[key].items()}
                x, _ = B.apply_decode(gp, t, x, gc, pos, cfg, at)
        x = L.apply_rmsnorm(params["final_norm"], x)
        logits = L.apply_unembed(params["embed"], x, cfg)[:, 0]
        return logits, {"groups": new_groups}

    forward = decode_step


def build_model(cfg: ModelConfig, mesh=None) -> Model:
    """The model of `cfg`'s family; a family whose blocks are not ported
    raises NotImplementedError and never falls back to another."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; it "
            "comes with slice S8c (the port builds "
            f"{', '.join(PORTED_FAMILIES)} models)")
    return Model(cfg, mesh)
