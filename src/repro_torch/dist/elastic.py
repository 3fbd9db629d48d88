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

On a zone split over processes, every process of the world calls it,
and only the rows that change owner move (`move_blocks`): under
P("data") process p of W holds the contiguous ranks [p·n/W, (p+1)·n/W)
of each data-sharded leaf's global dim of n, whatever G is, so the move
is a set of interval intersections, each sent point to point from its
old owner to its new one, and each process re-stacks its own block for
the new block mesh.  Over one group (W divides both G) no row of a
data-sharded leaf leaves its process and no process gathers the global
state; between two subgroups of one world (a change of the process
count, W -> W') a leaf replicated along `data` goes from the old mesh's
first process (its copy at data coordinate 0) to each newcomer, and a
process of both meshes keeps its own copy.  A leaf whose spec puts
`data` after another axis of its dim holds no contiguous block and is
refused (`_data_dim`).  No state that a split rescale moves has one:
zg's tenants, the chaos workload, the Server's cache and the Trainer's
state all lie on (data, model) meshes, where `spec_for` puts `data`
alone on a dim (its ("pod", "data") rule needs a pod axis).  A process
outside the old mesh (a spare) passes no state; one outside the new mesh
gets none back.  The same plan moves host blocks (`move_views`): a
snapshot restored onto another mesh, a golden run's final blocks.  A
move with no common parent group (a one-process zone and a split one)
is refused (`procs.refuse_regroup`).

The public entry point is `Pool.rescale(new_mesh)` (repro_torch/pool.py),
which adds flush-before-rescale and the host step-counter carry on top of
`reshard_state`; `rescale` / `rescale_windowed` below are the engine
forms it mirrors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import utils
from repro_torch.dist import procs, sharding

PyTree = Any


def reshard_state(state: PyTree, specs: PyTree, old_mesh, new_mesh,
                  abstract: PyTree = None, device=None) -> PyTree:
    """Zone-stacked leaves on `old_mesh` -> zone-stacked on `new_mesh`
    (bit-exact; along replicated axes the copy at coordinate 0 moves).  On
    a split zone every process calls it, over one group or between two
    subgroups of one world, and only the rows that change owner move
    (`move_blocks`, which takes `abstract`, the global shapes and dtypes,
    and on a process that holds no old block `device`, where its new
    block goes)."""
    procs.refuse_regroup(old_mesh, new_mesh)
    if old_mesh.group is None and new_mesh.group is None:
        leaves, treedef = utils.tree_flatten(state)
        return utils.tree_unflatten(treedef, [
            sharding.shard(sharding.unshard(x, spec, old_mesh), spec,
                           new_mesh)
            for x, spec in zip(leaves, utils.tree_leaves(specs))])
    return move_blocks(state, specs, old_mesh, new_mesh, abstract, device)


def _data_dim(spec, ndim: int, mesh) -> int:
    """The dim a leaf's spec puts on the data axis (-1: replicated along
    it); the data axis must lead that dim's axes, so that a process's
    block is one contiguous range of it."""
    for d, axes in enumerate(sharding._entries(spec, ndim)):
        if mesh.data_axis in axes:
            if axes[0] != mesh.data_axis:
                raise NotImplementedError(
                    f"spec {spec}: a move between split meshes needs the "
                    f"data axis first in its dim's axes {axes}")
            return d
    return -1


def move_plan(shapes: list, specs: list, old_mesh, new_mesh) -> list:
    """The pieces of a move between meshes over two process sets of one
    world: [(src, dst, leaf, dim, lo, hi)], ranks of the world's group;
    rows [lo, hi) of the leaf's global dim `dim` go from src's old block
    to dst's new one (dim -1: the whole leaf, replicated along `data`,
    which a newcomer gets from the old mesh's first process and a member
    of both meshes keeps).
    In leaf order, then old block order, so each new block's pieces come
    in data order."""
    olds, news = old_mesh.members, new_mesh.members
    out = []
    for i, (shape, spec) in enumerate(zip(shapes, specs)):
        d = _data_dim(spec, len(shape), new_mesh)
        if d < 0:                   # a member keeps its own copy
            out += [(q if q in olds else olds[0], q, i, -1, 0, 0)
                    for q in news]
            continue
        n = shape[d]
        wo, wn = len(olds), len(news)
        for k, src in enumerate(olds):
            a, b = k * n // wo, (k + 1) * n // wo
            for j, dst in enumerate(news):
                lo, hi = max(a, j * n // wn), min(b, (j + 1) * n // wn)
                if lo < hi:
                    out.append((src, dst, i, d, lo, hi))
    return out


def _piece(shape, d, lo, hi) -> tuple:
    return shape if d < 0 else (*shape[:d], hi - lo, *shape[d + 1:])


def _global_abstract(views: list, specs: list, mesh) -> list:
    """The global shapes and dtypes of a member's block views (meta
    tensors): the data-sharded dim times the mesh's process count."""
    out = []
    for v, spec in zip(views, specs):
        shape = list(v.shape)
        d = _data_dim(spec, len(shape), mesh)
        if d >= 0:
            shape[d] *= mesh.world
        out.append(torch.empty(shape, dtype=v.dtype, device="meta"))
    return out


def move_views(views: PyTree, specs: PyTree, old_mesh, new_mesh,
               abstract: PyTree = None, device=None) -> PyTree:
    """This process's block views on `old_mesh` (None on a spare of it)
    -> its block views on `new_mesh` (None on a spare of it), both meshes
    split over processes of one world.  Every process that holds a block
    of either mesh calls it (a spare of both may: it sends and gets
    nothing), with `abstract` the global shapes and dtypes (a member of
    the old mesh may leave it None) and `device` where the new block goes
    (by default the old block's).  Only the rows that change owner move,
    point to point (`ZoneGroup.send_recv`, counted in the world group's
    stats); the views may lie on the host (a snapshot's)."""
    root = procs.root_of(old_mesh.group) or procs.root_of(new_mesh.group)
    spec_leaves = utils.tree_leaves(specs)
    mine = None if old_mesh.is_spare else utils.tree_leaves(views)
    if abstract is None:
        if mine is None:
            raise ValueError("a move across process sets needs the global "
                             "state's shapes and dtypes (abstract)")
        abstract = _global_abstract(mine, spec_leaves, old_mesh)
    leaves, treedef = utils.tree_flatten(abstract)
    shapes = [tuple(x.shape) for x in leaves]
    dtypes = [x.dtype for x in leaves]
    me = root.rank
    plan = move_plan(shapes, spec_leaves, old_mesh, new_mesh)
    firsts = {}
    if mine is not None:
        k = old_mesh.proc_rank
        for i, v in enumerate(mine):
            if device is None:
                device = v.device
            d = _data_dim(spec_leaves[i], len(shapes[i]), old_mesh)
            firsts[i] = 0 if d < 0 else k * shapes[i][d] // old_mesh.world
    if device is None:
        raise ValueError("a spare of the old mesh names the device of its "
                         "new block")

    def cut(i, d, lo, hi):
        return mine[i] if d < 0 else mine[i].narrow(d, lo - firsts[i],
                                                    hi - lo)
    sends: dict = {}
    recvs: dict = {}
    for src, dst, i, d, lo, hi in plan:
        if src == me and dst != me:
            sends.setdefault(dst, []).append(
                cut(i, d, lo, hi).contiguous().reshape(-1).view(torch.uint8))
        elif dst == me and src != me:
            recvs[src] = recvs.get(src, 0) + math.prod(
                _piece(shapes[i], d, lo, hi)) * dtypes[i].itemsize
    got = {}
    if sends or recvs:
        got = root.send_recv({q: torch.cat(ps) for q, ps in sends.items()},
                             recvs, device)
    if new_mesh.is_spare:
        return None
    parts: dict = {}
    at = {src: 0 for src in got}
    for src, dst, i, d, lo, hi in plan:
        if dst != me:
            continue
        if src == me:
            piece = cut(i, d, lo, hi).to(device, copy=True)
        else:
            shape = _piece(shapes[i], d, lo, hi)
            nb = math.prod(shape) * dtypes[i].itemsize
            piece = got[src][at[src]:at[src] + nb].clone().view(
                dtypes[i]).reshape(shape)
            at[src] += nb
        parts.setdefault(i, []).append((d, piece))
    out = []
    for i in range(len(spec_leaves)):
        d = parts[i][0][0]
        out.append(parts[i][0][1] if d < 0 or len(parts[i]) == 1 else
                   torch.cat([p for _, p in parts[i]], dim=d))
    return utils.tree_unflatten(treedef, out)


def move_blocks(state: PyTree, specs: PyTree, old_mesh, new_mesh,
                abstract: PyTree = None, device=None) -> PyTree:
    """`reshard_state` between meshes split over processes of one world:
    every process of the world calls it, with `abstract` the global
    state's shapes and dtypes (a member of the old mesh may leave it None;
    a spare of `old_mesh` has `state` None and names `device`, its new
    block's device); returns this process's zone-stacked block on
    `new_mesh`, or None on a spare of it.  The block views move by
    `move_views`, and each member re-stacks its block for the new block
    mesh."""
    spec_leaves = utils.tree_leaves(specs)
    views = None
    if not old_mesh.is_spare:
        views = [sharding.block_view(x, spec, old_mesh) for x, spec in
                 zip(utils.tree_leaves(state), spec_leaves)]
        device = views[0].device if device is None else device
    treedef = utils.tree_flatten(abstract if state is None else state)[1]
    blocks = move_views(views, spec_leaves, old_mesh, new_mesh,
                        None if abstract is None
                        else utils.tree_leaves(abstract), device)
    if blocks is None:
        return None
    return utils.tree_unflatten(treedef, [
        sharding.shard(b, spec, new_mesh.block_mesh)
        for b, spec in zip(blocks, spec_leaves)])


def move(prot, specs: PyTree, old_mesh, new_mesh, make_protector: Callable,
         abstract: PyTree = None, device=None):
    """Move a protected job to `new_mesh`; returns (protector', prot'), or
    (None, None) on a spare of `new_mesh`.  `prot` is None on a spare of
    `old_mesh` (which names `abstract` and `device`, as `move_blocks`
    takes them).  The state reshards bit-exactly (`reshard_state`);
    parity, checksums, digest and the cached row are rebuilt from it by
    `make_protector(new_mesh).init`; the step counter carries over as a
    host value, sent from the old mesh's first process to every process
    when the process set changes."""
    state = None if prot is None else prot.state
    step = None if prot is None else int(prot.step)
    same = procs.same_group(old_mesh.group, new_mesh.group)
    if same and new_mesh.is_spare:          # a spare of both: nothing moves
        return None, None
    state = reshard_state(state, specs, old_mesh, new_mesh, abstract, device)
    if not same:
        root = procs.root_of(old_mesh.group) or procs.root_of(new_mesh.group)
        step = root.broadcast_host(step or 0, old_mesh.members[0])
    if new_mesh.is_spare:
        return None, None
    p_new = make_protector(new_mesh)
    prot_new = p_new.init(state)
    return p_new, dataclasses.replace(prot_new, step=torch.full(
        (), step, dtype=utils.WORD, device=prot_new.step.device))


def rescale(protector, prot, make_protector: Callable, new_mesh):
    """Move a protected job to `new_mesh`; returns (protector', prot').

    `make_protector(new_mesh)` builds the Protector for the new geometry
    (same abstract state and mode, new mesh); see `move` (a move across
    process sets: `Pool.rescale`)."""
    return move(prot, protector.state_specs, protector.mesh, new_mesh,
                make_protector)


def rescale_windowed(engine, est, make_protector: Callable, new_mesh):
    """`rescale` for a deferred-epoch engine: flush-before-rescale.

    A pending window means the stack and checksums describe the
    epoch-start state; the flush lands the window first, then the move
    rebuilds every plane with the new zone's coefficients.  Returns
    (protector', prot')."""
    est = engine.flush_if_pending(est)
    return rescale(engine.p, est.prot, make_protector, new_mesh)
