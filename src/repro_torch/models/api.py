"""Public model API (the reference's models/api.py): parameter counting,
the train state and its specs, and the step builders the trainer and the
server run (`make_train_step`, `make_forward`, `make_prefill`,
`make_decode_step`).

A train state is {"params", "opt", "step"}: f32 parameters (cast to the
compute dtype inside each step, so gradients reach the f32 leaves through
the casts), the optimizer's moments, and the step counter as a 0-d int32
tensor.  A train step reads nothing back to the host: loss, gradient
norm, learning rate and step stay on the device.  The dry run's inputs
of a workload cell (`batch_abstract`, `decode_abstract`) are
`device="meta"` tensors, the port's stand-in for the reference's
ShapeDtypeStructs: shapes and dtypes, no bytes.

`make_train_step(..., mesh=, state_specs=)` on a mesh split over W
processes (dist/procs.py) builds the data-parallel step
(`split_train_step`), byte-equal to the one-process step at the same
`microbatches`, which W must divide: each process computes its
microbatches' gradients against the whole parameters, the per-microbatch
partials are exchanged so that each process folds its 1/W slice of every
gradient in microbatch order from zeros (an all-to-all, then an
all-gather of the folded slices), and each process updates its block of
the parameters and moments.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from repro_torch import utils
from repro_torch.configs.base import ModelConfig, Workload
from repro_torch.dist import procs
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import P
from repro_torch.models import layers as L
from repro_torch.models import params as prm
from repro_torch.models.transformer import Model, build_model
from repro_torch.optim import Optimizer, clip_by_global_norm

PyTree = Any


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count; `active_only`: an expert stack counted at the
    top_k of num_experts that a token runs through."""
    total = 0
    for d in prm.leaves(build_model(cfg).param_defs()):
        n = math.prod(d.shape)
        if active_only and cfg.moe is not None and "experts" in d.logical:
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        total += n
    return total


# ---------------------------------------------------------------------------
# input specs per workload (dry-run stand-ins)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=prm.torch_dtype(dtype),
                       device="meta")


def batch_abstract(cfg: ModelConfig, wl: Workload) -> dict:
    """The batch of a train or prefill workload, as meta tensors."""
    B, S = wl.global_batch, wl.seq_len
    batch = {"tokens": _meta((B, S - cfg.mm_positions), "int32")}
    if cfg.mm_positions:
        batch["mm_embeds"] = _meta((B, cfg.mm_positions, cfg.d_model),
                                   cfg.compute_dtype)
    if cfg.enc_layers:
        batch["src_embeds"] = _meta((B, S, cfg.d_model), cfg.compute_dtype)
    return batch


def batch_specs(cfg: ModelConfig, mesh, global_batch: int = 1 << 30) -> dict:
    rules = cfg.logical_overrides
    B = global_batch
    specs = {"tokens": shd.spec_for(mesh, ("batch", None), (B, 1), rules)}
    if cfg.mm_positions:
        specs["mm_embeds"] = shd.spec_for(
            mesh, ("batch", None, None), (B, 1, 1), rules)
    if cfg.enc_layers:
        specs["src_embeds"] = shd.spec_for(
            mesh, ("batch", None, None), (B, 1, 1), rules)
    return specs


def decode_abstract(cfg: ModelConfig, wl: Workload, model: Model) -> dict:
    """(token, cache, pos) of a decode workload, as meta tensors.  The
    port's decode step takes `pos` on the host (a Python int, as the
    server passes it): the meta `pos` gives its shape and dtype only."""
    B, T = wl.global_batch, wl.seq_len
    return {"token": _meta((B,), "int32"),
            "cache": model._cache_defs(B, T, device="meta"),
            "pos": _meta((), "int32")}


def decode_specs(cfg: ModelConfig, wl: Workload, model: Model, mesh) -> dict:
    return {
        "token": shd.spec_for(mesh, ("batch",), (wl.global_batch,),
                              cfg.logical_overrides),
        "cache": model.cache_specs(wl.global_batch, wl.seq_len, mesh),
        "pos": P(),
    }


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------

def init_train_state(model: Model, optimizer: Optimizer,
                     gen: Optional[torch.Generator], device=None,
                     params: Optional[dict] = None) -> dict:
    """`params` (taken as they are), else random parameters from `gen` (a
    generator on `device`, the card unless the caller asks for the CPU);
    zero moments, step 0."""
    device = utils.resolve_device(device)
    if params is None:
        params = model.init(gen, device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_train_state(model: Model, optimizer: Optimizer) -> dict:
    """The train state's shapes and dtypes as `device="meta"` tensors."""
    params = prm.abstract_params(model.param_defs())
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def train_state_specs(model: Model, optimizer: Optimizer, mesh) -> dict:
    pspecs = model.param_specs(mesh)
    return {"params": pspecs, "opt": optimizer.state_specs(pspecs),
            "step": P()}


# ---------------------------------------------------------------------------
# train / serve step builders
# ---------------------------------------------------------------------------

def make_loss_and_grads(model: Model):
    """Returns loss_and_grads(params, batch) -> (loss, metrics, grads): the
    loss (re-weighted by the batch's `loss_mask`, as the reference does)
    and its gradients with respect to the parameters, all detached."""

    def loss_fn(params, batch):
        loss, metrics = model.loss(params, batch)
        if "loss_mask" in batch:
            # the reference re-weights the scalar: loss * w / max(w, 1e-9)
            # is the loss itself for any w > 1e-9, so a dropped replica
            # changes no gradient (a reference fault, kept on purpose)
            w = torch.mean(batch["loss_mask"].float())
            loss = loss * w / torch.clamp(w, min=1e-9)
        return loss, metrics

    def loss_and_grads(params, batch):
        leaves, treedef = utils.tree_flatten(params)
        xs = [p.detach().requires_grad_() for p in leaves]
        with torch.enable_grad():
            loss, metrics = loss_fn(utils.tree_unflatten(treedef, xs), batch)
            grads = torch.autograd.grad(loss, xs)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                utils.tree_unflatten(treedef, list(grads)))

    return loss_and_grads


def make_train_step(model: Model, optimizer: Optimizer, train_cfg,
                    mesh=None, state_specs=None):
    """Returns train_step(state, batch) -> (new_state, metrics).

    Supports microbatch gradient accumulation (f32 gradients; the metrics
    are then only `loss` and `grad_norm`, as the reference's) and
    per-example loss masks (straggler mitigation drops slow replicas'
    examples via the mask).  Clip, then the optimizer update, then step + 1.
    On a mesh split over processes it is `split_train_step`'s, which
    takes and returns the state as this process's block of zone-stacked
    leaves (`state_specs` places them)."""
    nmb = train_cfg.microbatches
    if mesh is not None and mesh.group is not None:
        return split_train_step(model, optimizer, train_cfg, mesh,
                                state_specs)
    single = make_loss_and_grads(model)

    def train_step(state, batch):
        params = state["params"]
        if nmb > 1:
            grads = utils.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss = torch.zeros((), device=state["step"].device)
            for i in range(nmb):
                mb_loss, _, mb_grads = single(params,
                                              microbatch(batch, nmb, i))
                grads = utils.tree_map(torch.add, grads, mb_grads)
                loss = loss + mb_loss
            grads = utils.tree_map(lambda g: g / nmb, grads)
            loss = loss / nmb
            metrics = {}
        else:
            loss, metrics, grads = single(params, batch)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        new_params, new_opt = optimizer.update(grads, state["opt"], params,
                                               state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return new_state, metrics

    return train_step


def microbatch(batch: dict, nmb: int, i: int) -> dict:
    """Rows `[i·B/nmb, (i+1)·B/nmb)` of every batch leaf: microbatch i."""
    return {k: x.reshape((nmb, x.shape[0] // nmb) + x.shape[1:])[i]
            for k, x in batch.items()}


def own_microbatches(nmb: int, world: int, rank: int) -> range:
    """The microbatches process `rank` of `world` computes: those whose
    rows lie in its block of the data-sharded batch."""
    k = nmb // world
    return range(rank * k, (rank + 1) * k)


def fold(parts, nmb: int) -> torch.Tensor:
    """The one-process accumulation of the `nmb` partials `parts[i]`, in
    microbatch order from zeros, then / nmb (an elementwise fold: on a
    slice it gives the whole's bits)."""
    acc = torch.zeros(parts[0].shape, dtype=torch.float32,
                      device=parts[0].device)
    for i in range(nmb):
        acc = acc + parts[i]
    return acc / nmb


def fold_split(partials: list, nmb: int, group) -> torch.Tensor:
    """One gradient's fold across the processes: `partials` are this
    process's microbatches' gradients of one leaf, in order.  Each process
    receives every process's partials of its 1/W slice (an all-to-all),
    folds them in global microbatch order and all-gathers the folded
    slices: every process ends with the one-process fold, bit for bit.
    The exchanges go in pieces (`procs.in_pieces`)."""
    w = group.world
    shape, n = partials[0].shape, partials[0].numel()
    c = -(-n // w)
    flat = torch.stack([g.reshape(-1) for g in partials])   # (k, n)
    if c * w != n:
        flat = torch.nn.functional.pad(flat, (0, c * w - n))
    k = flat.shape[0]
    send = flat.reshape(k, w, c).transpose(0, 1).reshape(w, k * c)
    got = procs.in_pieces(group.all_to_all, send.contiguous())
    # process p's k partials arrive in block p: global microbatch order
    mine = fold(got.reshape(w * k, c), nmb)
    whole = procs.in_pieces(group.all_gather, mine)        # (w, c)
    return whole.reshape(-1)[:n].reshape(shape)


def split_train_step(model: Model, optimizer: Optimizer, train_cfg, mesh,
                     state_specs):
    """The data-parallel train step of a mesh split over W processes:
    train_step(zone_state, batch) -> (new block state, metrics), with
    `zone_state` this process's zone-stacked leaves (`pool.prot.state`),
    `batch` the global batch and the new state this process's block view
    (`Pool.commit(..., block=True)`).  Byte-equal to the one-process step
    at the same `microbatches`:

      * the parameters are gathered whole (the data-sharded leaves only,
        the one copy `unshard` keeps; the moments never are);
      * process p computes the gradients of microbatches
        `own_microbatches(nmb, W, p)`, each of the one-process
        microbatch's shapes;
      * `fold_split` folds every gradient in microbatch order;
      * clip by the global norm of the whole gradients (equal everywhere),
        then the optimizer's update of this process's block (AdamW is
        elementwise);
      * the loss: the per-microbatch losses gathered and folded in order.
    """
    nmb, group = train_cfg.microbatches, mesh.group
    w = group.world
    if nmb % w:
        raise ValueError(
            f"a trainer split over {w} processes takes whole microbatches "
            f"a process: microbatches % W = {nmb} % {w} = {nmb % w}; the "
            "one-process step's summation order is its microbatches'")
    single = make_loss_and_grads(model)
    spec_leaves = utils.tree_leaves(state_specs)
    pspecs = state_specs["params"]

    def train_step(zone_state, batch):
        params = utils.tree_map(
            lambda x, sp: shd.unshard(x, sp, mesh, local_copy=True),
            zone_state["params"], pspecs)
        mine = own_microbatches(nmb, w, group.rank)
        losses, partials = [], []
        for i in mine:
            loss_i, _, g_i = single(params, microbatch(batch, nmb, i))
            leaves, gdef = utils.tree_flatten(g_i)
            losses.append(loss_i)
            partials.append(leaves)
            del g_i, leaves
        del params
        grads = utils.tree_unflatten(gdef, [
            fold_split([p[j] for p in partials], nmb, group)
            for j in range(len(partials[0]))])
        del partials
        all_losses = group.all_gather(torch.stack(losses)).reshape(-1)
        loss = torch.zeros((), device=zone_state["step"].device)
        for i in range(nmb):
            loss = loss + all_losses[i]
        loss = loss / nmb
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        grads = utils.tree_map(lambda g, sp: shd.block_of(g, sp, mesh),
                               grads, pspecs)
        # the block view is read only now: the whole parameters, the
        # partials and the activations are gone
        leaves, treedef = utils.tree_flatten(zone_state)
        block = utils.tree_unflatten(treedef, [
            shd.block_view(x, sp, mesh)
            for x, sp in zip(leaves, spec_leaves)])
        del leaves
        new_params, new_opt = optimizer.update(
            grads, block["opt"], block["params"], block["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": block["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_forward(model: Model):
    """Full-sequence forward: batch -> (B, S, V) logits (eval/scoring)."""
    def forward(params, batch):
        logits, _ = model.forward(params, batch)
        return logits
    return forward


def make_prefill(model: Model):
    """Serving prefill: batch -> next-token logits (B, V).

    Slices the hidden state to the last position BEFORE the unembedding so
    the (B, S, vocab) logits tensor never materializes."""
    def prefill(params, batch):
        x, _ = model.hidden(params, batch)
        logits = L.apply_unembed(params["embed"], x[:, -1:, :], model.cfg)
        return logits[:, 0]
    return prefill


def make_decode_step(model: Model, sample: str = "greedy"):
    """serve_step: one new token against a full KV cache.  Returns
    (next tokens (B,) int32, logits (B, V) f32, new cache)."""
    if sample != "greedy":
        raise ValueError(sample)

    def decode_step(params, token, cache, pos):
        logits, cache = model.decode_step(params, token, cache, pos)
        # torch.argmax, as jnp.argmax, returns the first maximum
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return decode_step
