"""Elastic rescale: move protected state between meshes.

Zone geometry is a function of the data-axis size G (row padding, parity
segment length, page->owner mapping and every syndrome's coefficients
g^(k·i)), so protection cannot move with the state, exactly as Pangolin
rebuilds parity when chunk-row geometry changes.  The flow is:

    state' = reshard_state(prot.state, specs, old_mesh, new_mesh)  # bit-exact
    prot'  = new_protector.init(state')                            # rebuild

One device holds every zone stacked `(*mesh_dims, *local)`
(dist/sharding.py), so the reshard is `unshard` on the old mesh followed by
`shard` on the new one, on the device: the same function as the
reference's trip through host memory, without the trip.

The public entry point is `Pool.rescale(new_mesh)` (repro_torch/pool.py),
which adds flush-before-rescale and the host step-counter carry on top of
`reshard_state`; `rescale` / `rescale_windowed` below are the engine
forms it mirrors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import utils
from repro_torch.dist import sharding

PyTree = Any


def reshard_state(state: PyTree, specs: PyTree, old_mesh, new_mesh) -> PyTree:
    """Zone-stacked leaves on `old_mesh` -> zone-stacked on `new_mesh`
    (bit-exact; along replicated axes the copy at coordinate 0 moves)."""
    leaves, treedef = utils.tree_flatten(state)
    return utils.tree_unflatten(treedef, [
        sharding.shard(sharding.unshard(x, spec, old_mesh), spec, new_mesh)
        for x, spec in zip(leaves, utils.tree_leaves(specs))])


def rescale(protector, prot, make_protector: Callable, new_mesh):
    """Move a protected job to `new_mesh`; returns (protector', prot').

    `make_protector(new_mesh)` builds the Protector for the new geometry
    (same abstract state and mode, new mesh).  Parity, checksums, digest
    and the cached row are rebuilt from the resharded state; the step
    counter carries over as a host value."""
    p_new = make_protector(new_mesh)
    state = reshard_state(prot.state, protector.state_specs, protector.mesh,
                          new_mesh)
    prot_new = p_new.init(state)
    step = int(prot.step)
    return p_new, dataclasses.replace(prot_new, step=torch.full(
        (), step, dtype=utils.WORD, device=prot_new.step.device))


def rescale_windowed(engine, est, make_protector: Callable, new_mesh):
    """`rescale` for a deferred-epoch engine: flush-before-rescale.

    A pending window means the stack and checksums describe the
    epoch-start state; the flush lands the window first, then the move
    rebuilds every plane with the new zone's coefficients.  Returns
    (protector', prot')."""
    est = engine.flush_if_pending(est)
    return rescale(engine.p, est.prot, make_protector, new_mesh)
