"""Functional optimizers: AdamW and Adafactor (the reference's
optim/optimizers.py).

Moments have the parameter's layout (the pool protects them as ordinary
zone objects).  `moment_dtype` lets very large models hold m / v in bf16;
the update math always runs in f32 and casts back to the parameter's and
the moment's dtypes.  The step counter, the learning rate, the bias
corrections and the clip scale stay on the device as tensors: a train
step reads nothing back to the host.  The reference's cross-pod
compressed mean (optim/compress.py) belongs to the multi-process zone
backend and is not here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import utils
from repro_torch.dist.sharding import P
from repro_torch.models.params import torch_dtype

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple]      # (grads, opt_state, params, step) -> (new_params, new_opt_state)
    state_specs: Callable[[PyTree], PyTree]  # param specs -> opt-state specs


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple:
    """(grads scaled to a global norm of at most `max_norm`, the norm as a
    0-d f32 tensor)."""
    leaves = utils.tree_leaves(grads)
    gsq = sum(torch.sum(g.float() ** 2) for g in leaves)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return utils.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                          grads), gnorm


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          moment_dtype: Optional[str] = None) -> Optimizer:
    def init(params):
        def zeros_like_m(p):
            dt = torch_dtype(moment_dtype) if moment_dtype else p.dtype
            return torch.zeros(p.shape, dtype=dt, device=p.device)
        return {"m": utils.tree_map(zeros_like_m, params),
                "v": utils.tree_map(zeros_like_m, params)}

    def update(grads, state, params, step):
        stepf = step.float() + 1.0
        lr = lr_fn(stepf)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)

        def upd(g, m, v, p):
            gf = g.float()
            mf = b1 * m.float() + (1 - b1) * gf
            vf = b2 * v.float() + (1 - b2) * gf * gf
            mhat = mf / bc1
            vhat = vf / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * \
                p.float()
            newp = p.float() - lr * delta
            return newp.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

        g_leaves, treedef = utils.tree_flatten(grads)
        out = [upd(*xs) for xs in zip(
            g_leaves, utils.tree_leaves(state["m"]),
            utils.tree_leaves(state["v"]), utils.tree_leaves(params))]
        new_params, new_m, new_v = (
            utils.tree_unflatten(treedef, [o[i] for o in out])
            for i in range(3))
        return new_params, {"m": new_m, "v": new_v}

    def state_specs(param_specs):
        return {"m": param_specs, "v": param_specs}

    return Optimizer(init=init, update=update, state_specs=state_specs)


def adafactor(lr_fn, eps: float = 1e-30, decay: float = 0.8,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second moments: O(n+m) state for an (n, m) matrix — the
    memory-efficient option for the 400B-class configs."""

    def _factored(p):
        return p.dim() >= 2

    def init(params):
        def mk(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return utils.tree_map(mk, params)

    def update(grads, state, params, step):
        stepf = step.float() + 1.0
        lr = lr_fn(stepf)
        beta = 1.0 - torch.pow(stepf, -decay)

        def upd(g, p, s):
            gf = g.float()
            g2 = gf * gf + eps
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                       min=eps))
                upd_ = gf * torch.rsqrt(torch.clamp(denom, min=eps))
                news = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                upd_ = gf * torch.rsqrt(torch.clamp(v, min=eps))
                news = {"v": v}
            # update clipping (RMS <= 1), Adafactor-style
            rms = torch.sqrt(torch.mean(upd_ ** 2))
            upd_ = upd_ / torch.clamp(rms, min=1.0)
            newp = (p.float() - lr * (upd_ + weight_decay * p.float()))
            return newp.to(p.dtype), news

        # the state's per-parameter dicts are leaves of the walk
        g_leaves, treedef = utils.tree_flatten(grads)
        p_leaves = utils.tree_leaves(params)
        s_leaves = _moment_dicts(state, treedef)
        out = [upd(g, p, s) for g, p, s in zip(g_leaves, p_leaves, s_leaves)]
        return (utils.tree_unflatten(treedef, [o[0] for o in out]),
                utils.tree_unflatten(treedef, [o[1] for o in out]))

    def state_specs(param_specs):
        # factored moments drop the last / second-to-last axis of the spec
        def mk(spec):
            parts = tuple(spec)
            if len(parts) >= 2:
                return {"vr": P(*parts[:-1]),
                        "vc": P(*(parts[:-2] + parts[-1:]))}
            return {"v": spec}
        return utils.tree_map(mk, param_specs)

    return Optimizer(init=init, update=update, state_specs=state_specs)


def _moment_dicts(state: PyTree, treedef) -> list:
    """Adafactor's state, one {"v"} or {"vr", "vc"} dict a parameter, in
    the parameters' leaf order (`treedef` their structure)."""
    out = []

    def walk(node, d):
        if d.kind == "leaf":
            out.append(node)
        elif d.kind == "dict":
            for k, c in zip(d.keys, d.children):
                walk(node[k], c)
        elif d.kind in ("list", "tuple"):
            for n, c in zip(node, d.children):
                walk(n, c)
    walk(state, treedef)
    return out


def build_optimizer(train_cfg, model_cfg) -> Optimizer:
    lr_fn = cosine_schedule(train_cfg.learning_rate, train_cfg.warmup_steps,
                            train_cfg.total_steps)
    if train_cfg.optimizer == "adafactor":
        return adafactor(lr_fn, weight_decay=train_cfg.weight_decay)
    return adamw(lr_fn, b1=train_cfg.b1, b2=train_cfg.b2, eps=train_cfg.eps,
                 weight_decay=train_cfg.weight_decay,
                 moment_dtype=model_cfg.moment_dtype)
