"""The zone model on one device: a mesh descriptor and zone-stacked tensors.

The reference places each state leaf on a `jax.sharding.Mesh` with a
`PartitionSpec`; every device holds one local shard.  Here the whole zone
lives on one device, so a leaf is held **zone-stacked**:
`(*mesh_dims, *local_shape)` — entry `[i, j, ...]` is what device
`(i, j, ...)` of the mesh would hold.  Replicated axes are materialized as
real copies, because copies can diverge (a rank loss garbles only the lost
rank's copy of a data-replicated leaf) and the protection engine must see
exactly what each device holds.

`shard` / `unshard` move between a global tensor and its stacked form;
`local_shape` is the spec-to-shard rule (`NamedSharding.shard_shape`).

A mesh given a process group (`ZoneMesh(..., group=)`, dist/procs.py) is
split over its W processes along the data axis: process p holds data
coordinates `[p·G/W, (p+1)·G/W)` and every coordinate of the other axes,
so its stacked leaves are `(*local_dims, *local_shape)`, the reference's
layout with G/W in the data dim.  `shard` keeps the process's block;
`unshard` gathers the blocks (of the one copy it keeps along replicated
axes) first.  Without a group (or with one process) one device holds the
whole zone, as above.

A process's block is itself a one-process zone of G/W data ranks with
the other axes unchanged: `ZoneMesh.block_mesh`, a mesh of `local_dims`
with no group.  The **block view** of a leaf is its global form on that
mesh (`block_view`, `block_of`): for a leaf sharded over `data` the
process's slice (the batch rows of a cache, the `embed` slice of an FSDP
parameter), for a leaf replicated along `data` the whole leaf (this
process's copy).  Reading and writing the block view makes no exchange;
`gather_global` puts the data-sharded leaves of the global tensor back
together from the processes' blocks.  At W = 1 the block mesh is the
mesh, and the block view the global tensor.

A mesh may be split over a subgroup of the processes (`split_mesh`): a
process outside it is a spare of that mesh (`ZoneMesh.is_spare`), holds
no block, and refuses to read its rank, offset or block mesh.

Model and cache code names tensor dimensions logically ("embed", "heads",
"batch", ...); `spec_for` maps the names onto mesh axes with the
reference's divisibility fallback (dist/sharding.py there): each name has
an ordered list of candidate axis tuples, and a candidate is taken only if
all its axes exist, the dimension divides by their total size, and no axis
is already used by an earlier dimension; with none left the dimension
replicates.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.dist import procs


class P(tuple):
    """A partition spec: one entry per tensor dim — None (replicated), a
    mesh axis name, or a tuple of names (major to minor).  Trailing dims
    beyond the spec are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)                # pickled as P(*entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class ZoneMesh:
    """Stands in for `jax.sharding.Mesh`: named axes and their sizes.

    The zone (parity group) runs along `data_axis`; every other mesh
    coordinate holds an independent zone of G = size(data_axis) ranks.
    `group` (a `procs.ZoneGroup`, or a gloo process group) splits the data
    axis over its processes in contiguous blocks; W must divide G.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 data_axis: str = "data", group=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axis "
                             f"names {self.axis_names}")
        if data_axis not in self.axis_names:
            raise ValueError(f"data axis {data_axis!r} not in mesh axes "
                             f"{self.axis_names}")
        self.data_axis = data_axis
        if group is not None:
            if not isinstance(group, (procs.ZoneGroup, procs.Spare)):
                group = procs.ZoneGroup(group)
            if self.group_size % group.world:
                raise ValueError(
                    f"{group.world} processes do not split a zone of "
                    f"{self.group_size} data ranks into equal blocks")
            if group.world == 1 and group.parent is None:
                group = None
        self.group = group

    @property
    def world(self) -> int:
        """Processes the zone is split over (1 without a group)."""
        return 1 if self.group is None else self.group.world

    @property
    def is_spare(self) -> bool:
        """This process is outside the mesh's group: it holds no block
        (`procs.Spare`)."""
        return isinstance(self.group, procs.Spare)

    @property
    def members(self) -> Optional[tuple]:
        """The ranks, in the world's group, of the processes holding the
        zone's blocks in order (None on one process)."""
        return None if self.group is None else self.group.members

    @property
    def proc_rank(self) -> int:
        """This process's block, in data order (raises on a spare)."""
        return 0 if self.group is None else self.group.rank

    @property
    def local_group_size(self) -> int:
        """Data ranks this process holds, G / W."""
        return self.group_size // self.world

    @property
    def data_offset(self) -> int:
        """The global data coordinate of this process's first rank."""
        return self.proc_rank * self.local_group_size

    @property
    def block_mesh(self) -> "ZoneMesh":
        """This process's block as a mesh of its own: `local_dims`, the same
        axes, no group (the mesh itself on one process)."""
        if self.group is None:
            return self
        if self.is_spare:
            raise self.group._refuse("its block")
        return ZoneMesh(self.local_dims, self.axis_names, self.data_axis)

    @property
    def local_dims(self) -> tuple:
        """The leading dims of this process's stacked tensors: the mesh
        shape with G / W in the data dim."""
        dims = list(self.shape)
        dims[self.data_dim] = self.local_group_size
        return tuple(dims)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    @property
    def data_dim(self) -> int:
        """Position of the zone axis among the stacked leading dims."""
        return self.axis_names.index(self.data_axis)

    @property
    def group_size(self) -> int:
        return self.axis_size(self.data_axis)

    def __repr__(self) -> str:
        split = "" if self.group is None else f", group={self.group!r}"
        return (f"ZoneMesh({self.shape}, {self.axis_names}, "
                f"data_axis={self.data_axis!r}{split})")


def split_mesh(shape: Sequence[int], axis_names: Sequence[str], parent,
               members=None, data_axis: str = "data") -> ZoneMesh:
    """A mesh split over `members` (ranks of the world's group `parent`;
    all of them by default) in rank order: on a member the mesh over their
    subgroup, on any other process a spare mesh (`ZoneMesh.is_spare`).  A
    collective the first time a set of members is named (`ZoneGroup.sub`):
    every process of `parent` calls it alike."""
    members = (tuple(range(parent.world)) if members is None
               else tuple(sorted(int(m) for m in members)))
    group = parent.sub(members)
    if group is None:
        group = procs.Spare(parent, members)
    return ZoneMesh(shape, axis_names, data_axis, group=group)


def _entries(spec, ndim: int) -> list:
    """Spec -> one tuple of mesh axis names per tensor dim."""
    spec = tuple(spec) if spec is not None else ()
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = []
    for e in spec + (None,) * (ndim - len(spec)):
        out.append(() if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e)))
    return out


def local_shape(global_shape: Sequence[int], spec, mesh: ZoneMesh) -> tuple:
    """Per-device shard shape of a leaf (`NamedSharding.shard_shape`)."""
    out = []
    for n, axes in zip(global_shape, _entries(spec, len(global_shape))):
        k = math.prod(mesh.axis_size(a) for a in axes)
        if n % k:
            raise ValueError(f"dim of size {n} does not divide over mesh "
                             f"axes {axes} of total size {k}")
        out.append(n // k)
    return tuple(out)


def shard(x: torch.Tensor, spec, mesh: ZoneMesh) -> torch.Tensor:
    """Global tensor -> zone-stacked `(*mesh.local_dims, *local_shape)`:
    on a split mesh only this process's block of data ranks is copied."""
    entries = _entries(spec, x.dim())
    dims, axis_pos, local_pos = [], {}, []
    for n, axes in zip(x.shape, entries):
        for a in axes:
            axis_pos[a] = len(dims)
            dims.append(mesh.axis_size(a))
        local_pos.append(len(dims))
        dims.append(n // math.prod(mesh.axis_size(a) for a in axes))
    y = x.reshape(dims)
    perm = []
    for a in mesh.axis_names:
        if a not in axis_pos:                 # replicated: a copy per coord
            y = y.unsqueeze(-1)
            axis_pos[a] = y.dim() - 1
        perm.append(axis_pos[a])
    y = y.permute(perm + local_pos)
    y = y.expand(*mesh.shape, *y.shape[len(mesh.shape):])
    if mesh.group is not None:
        y = y.narrow(mesh.data_dim, mesh.data_offset, mesh.local_group_size)
    return y.contiguous()


def unshard(y: torch.Tensor, spec, mesh: ZoneMesh, *,
            local_copy: bool = False) -> torch.Tensor:
    """Zone-stacked -> global tensor.  Along replicated axes the copy at
    coordinate 0 is taken — the one `np.asarray` of a jax.Array shows.  On
    a split mesh the processes' blocks of that copy are gathered first (a
    collective: every process calls it); a leaf replicated along `data`
    takes process 0's copy, or with `local_copy` this process's own (no
    exchange)."""
    n_mesh = len(mesh.shape)
    local = tuple(y.shape[n_mesh:])
    entries = _entries(spec, len(local))
    used = {a for axes in entries for a in axes}
    split = mesh.group is not None
    idx = tuple(slice(None) if a in used or (split and a == mesh.data_axis)
                else 0 for a in mesh.axis_names)
    y = y[idx]
    if split:
        dd = sum(1 for a in mesh.axis_names[:mesh.data_dim] if a in used)
        if mesh.data_axis in used:
            y = mesh.group.gather_dim(y.contiguous(), dd)
        elif local_copy:
            y = y.select(dd, 0)
        else:
            y = mesh.group.all_gather(y.select(dd, 0).contiguous())[0]
    kept = [a for a in mesh.axis_names if a in used]
    order, gshape = [], []
    for i, axes in enumerate(entries):
        order += [kept.index(a) for a in axes] + [len(kept) + i]
        gshape.append(local[i] * math.prod(mesh.axis_size(a) for a in axes))
    return y.permute(order).reshape(gshape)


def block_view(y: torch.Tensor, spec, mesh: ZoneMesh) -> torch.Tensor:
    """Zone-stacked `(*mesh.local_dims, ...)` -> this process's block view
    (no exchange)."""
    return unshard(y, spec, mesh.block_mesh)


def block_of(x: torch.Tensor, spec, mesh: ZoneMesh) -> torch.Tensor:
    """Global tensor -> this process's block view of it (no exchange)."""
    if mesh.group is None:
        return x
    return block_view(shard(x, spec, mesh), spec, mesh)


def gather_global(x: torch.Tensor, spec, mesh: ZoneMesh) -> torch.Tensor:
    """A block view -> the global tensor: the data-sharded dims gathered
    from every process (a collective when the spec uses `data`); a leaf
    replicated along `data` is this process's copy, unchanged."""
    if mesh.group is None or mesh.data_axis not in {
            a for axes in _entries(spec, x.dim()) for a in axes}:
        return x
    return unshard(shard(x, spec, mesh.block_mesh), spec, mesh)


# FSDP + TP defaults: batch/embed spread over the data dimension(s), the
# contraction-heavy weight dims over the tensor-parallel model axis.
DEFAULT_RULES = {
    "batch": (("pod", "data"), ("data",)),
    "embed": (("data",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "vocab": (("model",),),
    "ffn": (("model",),),
    "experts": (("model",),),
    "seq_shard": (("model",),),
}


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh ({} for None)."""
    return {} if mesh is None else dict(zip(mesh.axis_names, mesh.shape))


def _candidates(rule) -> list:
    """Normalize a rule value into a list of mesh-axis tuples."""
    if rule is None:
        return []
    if isinstance(rule, str):
        return [(rule,)]
    out = []
    for cand in rule:
        out.append((cand,) if isinstance(cand, str) else tuple(cand))
    return out


def spec_for(mesh: ZoneMesh, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None,
             rules: Optional[dict] = None) -> P:
    """Partition spec for a tensor with the given logical axes.

    `shape` enables the divisibility check (omit it to trust the caller);
    `rules` are per-call overrides merged over DEFAULT_RULES.
    """
    mesh_shape = axis_sizes(mesh)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    used: set = set()
    entries = []
    for i, name in enumerate(logical):
        dim = None if shape is None else int(shape[i])
        chosen = None
        if name is not None:
            for cand in _candidates(merged.get(name)):
                if not all(a in mesh_shape for a in cand):
                    continue
                if any(a in used for a in cand):
                    continue
                size = math.prod(mesh_shape[a] for a in cand)
                if dim is not None and (size == 0 or dim % size != 0):
                    continue
                chosen = cand
                break
        if chosen is None:
            entries.append(None)
        else:
            used.update(chosen)
            entries.append(chosen if len(chosen) > 1 else chosen[0])
    while entries and entries[-1] is None:   # trailing dims replicate anyway
        entries.pop()
    return P(*entries)
