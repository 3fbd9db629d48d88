"""Declarative parameter definitions (the reference's models/params.py).

Each module declares its parameters as `ParamDef`s (shape, dtype, logical
axes, initializer).  From one definition tree come the initialized
parameter tree (`init_params`, from an explicit `torch.Generator`), its
shapes alone (`abstract_params`, meta tensors), the partition specs
through the logical-axis rules (`spec_tree`) and the parameter count
(`count`).  Layer stacks are declared once and `stacked`
over a leading "layers" axis, so the tree, and every leaf's layout, is the
reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch import utils
from repro_torch.dist import sharding as shd

PyTree = Any

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    dtype: Any
    logical: tuple                      # logical axis names, len == ndim
    init: str = "normal"                # normal | zeros | ones | scaled
    scale: float = 1.0

    def with_stack(self, n: int) -> "ParamDef":
        return ParamDef(shape=(n,) + self.shape, dtype=self.dtype,
                        logical=("layers",) + self.logical, init=self.init,
                        scale=self.scale)


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _map(fn, defs: PyTree) -> PyTree:
    """`fn` over the ParamDef leaves of a nested dict."""
    if _is_def(defs):
        return fn(defs)
    return {k: _map(fn, defs[k]) for k in sorted(defs)}


def leaves(defs: PyTree) -> list:
    """The ParamDefs of a tree, in the reference's (sorted-key) order."""
    return utils.tree_leaves(defs)


def stacked(defs: PyTree, n: int) -> PyTree:
    """Add a leading layer axis of size n to every ParamDef in the tree."""
    return _map(lambda d: d.with_stack(n), defs)


def abstract_params(defs: PyTree) -> PyTree:
    """The parameter tree's shapes and dtypes as `device="meta"` tensors
    (the reference's ShapeDtypeStruct tree), holding no bytes."""
    return _map(lambda d: torch.empty(d.shape, dtype=torch_dtype(d.dtype),
                                      device="meta"), defs)


def _init_one(d: ParamDef, gen: torch.Generator, device) -> torch.Tensor:
    dt = torch_dtype(d.dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init == "normal":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = d.scale / math.sqrt(fan_in)
    elif d.init == "scaled":
        std = d.scale
    else:
        raise ValueError(d.init)
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    # scaled in place: the bits of `(x * std).to(dt)` without a second
    # f32 copy of the leaf (21.47 GB for one of maverick's expert stacks)
    return x.mul_(std).to(dt)


def init_params(defs: PyTree, gen: torch.Generator, device=None) -> PyTree:
    """Initialize every leaf from `gen` (a generator on `device`, the card
    unless the caller asks for the CPU), leaves drawn in sorted-key
    order."""
    device = utils.resolve_device(device)
    return _map(lambda d: _init_one(d, gen, device), defs)


def spec_tree(defs: PyTree, mesh, rules: Optional[dict] = None) -> PyTree:
    return _map(lambda d: shd.spec_for(mesh, d.logical, d.shape, rules), defs)


def count(defs: PyTree) -> int:
    return sum(math.prod(d.shape) for d in leaves(defs))
