"""XOR collectives over the zone (data) dim of zone-stacked tensors.

The reference runs these inside a shard_map, one device per rank, built
from all-to-all / all-gather plus local folds (XOR is not a native
collective reduction in XLA or NCCL).  With the whole zone on one device
(dist/sharding.py), a collective over the zone axis is a fold over the
data dim of the stacked tensor; `dim` names that dim
(`ZoneMesh.data_dim`).  Every operand is an int32 word tensor.

Each collective reports its wire bytes to the active cost counter
(kernels/cost.py) as the reference's would move them if each zone rank
were its own card, by launch/hlo_analysis.py's volume conventions with G
the folded dim's length, summed over the ranks of the operand:

    all-gather          (G-1)/G * result bytes
    all-reduce          (G-1)/G * operand bytes, twice (the reference's
                        XOR all-reduce: an all-to-all, then an all-gather)
    all-to-all          (G-1)/G * operand bytes (the XOR reduce-scatter)
    collective-permute  operand bytes a round

On a zone split over processes (dist/procs.py) each collective takes the
mesh's `group`: the operand holds this process's G / W ranks, the fold
runs over them first, and one exchange between the processes finishes
it — the reduce-scatter sends each process its block of the G partial
segments (an all-to-all of one row's words), the all-gather and the XOR
all-reduce gather one block or one partial from each process.  The wire
counts above stay the reference's, over the ranks this process holds,
with G the whole zone's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import utils
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops as kops


def _wire(kind: str, x: torch.Tensor, g: int, scale: int = 1) -> None:
    """Report `(G-1)/G` of `scale` times x's bytes (every rank's)."""
    kcost.wire(kind, (g - 1) / g * scale * x.numel() * x.element_size())


def note_all_reduce(x: torch.Tensor, g: int, itemsize: int = 0) -> None:
    """Report the reference's all-reduce of x over groups of g ranks (x
    holds every rank's payload, each element `itemsize` bytes on the wire:
    a bool verdict is the reference's int32).  The value itself is formed
    where it is used."""
    size = itemsize or x.element_size()
    kcost.wire("all-reduce", 2 * (g - 1) / g * x.numel() * size)


def xor_fold(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """XOR reduction along one dim (pairwise halving: log2(n) passes)."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        top = x[:h] ^ x[h:2 * h]
        if x.shape[0] % 2:
            top[0] ^= x[2 * h]
        x = top
    return x[0]


def _zone_size(x: torch.Tensor, dim: int, group=None) -> int:
    """G, the whole zone's ranks, of an operand holding this process's
    block along `dim`."""
    return x.shape[dim] * (1 if group is None else group.world)


def _scatter_partial(partial: torch.Tensor, dim: int,
                     group=None) -> torch.Tensor:
    """`partial` holds along `dim` this process's XOR partial of each of
    the G segments; each process receives its block of G / W segments
    from every process and folds them (the one-process fold's bits)."""
    if group is None:
        return partial
    blocks = partial.unflatten(dim, (group.world, -1)).movedim(dim, 0)
    return xor_fold(group.all_to_all(blocks.contiguous()), 0)


def xor_reduce_scatter(row: torch.Tensor, dim: int,
                       group=None) -> torch.Tensor:
    """`(*M, n)` rows -> `(*M, n // G)`: rank i along `dim` keeps segment
    i of the XOR of the G rows of its zone."""
    g, n = _zone_size(row, dim, group), row.shape[-1]
    if n % g:
        raise ValueError(f"row of {n} words does not split into {g} segments")
    _wire("all-to-all", row, g)
    segs = row.reshape(*row.shape[:-1], g, n // g)
    return _scatter_partial(xor_fold(segs, dim).movedim(-2, dim), dim, group)


def all_gather_row(seg: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """`(*M, s)` segments -> `(*M, G * s)`: every rank of a zone receives
    the concatenation of its zone's segments in rank order."""
    g = _zone_size(seg, dim, group)
    _wire("all-gather", seg, g, g)
    whole = seg if group is None else group.gather_dim(seg, dim)
    full = whole.movedim(dim, -2)
    full = full.reshape(*full.shape[:-2], -1).unsqueeze(dim)
    return full.expand(*seg.shape[:-1], full.shape[-1])


def xor_reduce(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """XOR of x across each zone, once a zone (the dim folded away): the
    value the reference's XOR all-reduce delivers to every rank, reported
    as that all-reduce (its payload unpadded)."""
    g = _zone_size(x, dim, group)
    _wire("all-to-all", x, g)
    _wire("all-gather", x, g)
    out = xor_fold(x, dim)
    return out if group is None else xor_fold(group.all_gather(out), 0)


def xor_all_reduce(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """XOR of x across each zone, delivered to every rank (same shape).
    Returns a broadcast view: read it, do not write into it."""
    return xor_reduce(x, dim, group).unsqueeze(dim).expand_as(x)


# The weighted planes of a row take r times its bytes, and their fold half
# as much again.  Past this many bytes of planes they are built and folded
# one zone segment at a time, G launches of sdelta_stack instead of one.
WEIGHTED_BYTES = 1 << 32


def syndrome_reduce_scatter(row: torch.Tensor, dim: int,
                            coeffs: Optional[torch.Tensor] = None,
                            group=None) -> torch.Tensor:
    """`(*M, n)` rows -> the `(*M, r, n // G)` syndrome stack: rank i keeps
    segment i of every S_k = XOR_j g^(k·j)·row_j.  `coeffs` is the
    `(*M, r)` table of each rank's g^(k·j) (`gf.rank_syndrome_coeffs`), or
    None for r = 1, whose only plane is the XOR parity.  The `sdelta_stack`
    kernel weights each row into its r planes from one read; each plane
    then folds as `xor_reduce_scatter` does.  The weighting is per word,
    so a large row is weighted and folded a segment at a time, to the
    same bytes."""
    r = 1 if coeffs is None else coeffs.shape[-1]
    if r * row.numel() * row.element_size() <= WEIGHTED_BYTES:
        return xor_reduce_scatter(kops.syndrome_scale(row, coeffs), dim,
                                  group)
    g, n = _zone_size(row, dim, group), row.shape[-1]
    if n % g:
        raise ValueError(f"row of {n} words does not split into {g} segments")
    _wire("all-to-all", row, g, r)
    segs = row.reshape(*row.shape[:-1], g, n // g)
    return _scatter_partial(torch.stack([
        xor_fold(kops.syndrome_scale(segs[..., i, :].contiguous(), coeffs),
                 dim) for i in range(g)], dim=dim), dim, group)


def syndrome_apply_delta(synd: torch.Tensor, sdelta: torch.Tensor,
                         dim: int, group=None) -> torch.Tensor:
    """Bulk stack delta: `synd ^ reduce-scatter(sdelta)`, plane by plane.
    `synd`: `(*M, r, s)`; `sdelta`: `(*M, r, n)` pre-weighted delta rows."""
    return synd ^ xor_reduce_scatter(sdelta, dim, group)


def meta_all_gather(x: torch.Tensor, dim: int, n_axes: int,
                    group=None) -> torch.Tensor:
    """Replicate small per-rank metadata across the zone: `(*M, *s)` ->
    `(*M, G, *s)`, where every device of a zone holds the stacked table of
    its zone's G values in rank order (out[..., i, ...] is rank i's).
    `n_axes` is the number of leading mesh dims.  On a split zone `x`
    holds this process's block and the table is gathered from every
    process (one all-gather)."""
    g = _zone_size(x, dim, group)
    _wire("all-gather", x, g, g)
    whole = x if group is None else group.gather_dim(x, dim)
    return whole.movedim(dim, n_axes - 1).unsqueeze(dim).expand(
        *x.shape[:n_axes], g, *x.shape[n_axes:])


def make_meta_mirror(dim: int = 0, group=None):
    """The window-meta mirror: a function that takes a tuple of tensors
    (None entries pass through) and returns detached copies.  The reference
    reshards its tuple to every device so that a lost rank's copy survives
    on the others; with the zone on one device a copy is that mirror — it
    must be a copy, not a view, because the window's tensors are replaced
    every commit.  The copies are queued on the device's stream: no host
    sync.  On a split zone a zone-stacked entry (one with dims) is
    gathered along the data dim `dim` from every process, so each holds
    the whole zone's table and a lost process's rows survive on the
    others; a 0-d entry (a step, a count) is the same everywhere and is
    copied."""
    def mirror(t):
        t = t.detach()
        if group is None or t.dim() == 0:
            return t.clone()
        return group.gather_dim(t, dim)
    return lambda tree: utils.tree_map(mirror, tree)


def xor_tree_reduce(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The reference's recursive-doubling XOR all-reduce (power-of-two
    zones only, as there): on one device it is the XOR fold over the data
    dim, delivered to every rank (a broadcast view, as `xor_all_reduce`).
    On a split zone the block folds locally, then one all-gather of the
    processes' partials finishes it."""
    g = _zone_size(x, dim, group)
    if g & (g - 1):
        raise ValueError(f"tree reduce needs a power-of-two zone, got {g}")
    kcost.wire("collective-permute",
               (g.bit_length() - 1) * x.numel() * x.element_size())
    out = xor_fold(x, dim)
    if group is not None:
        out = xor_fold(group.all_gather(out), 0)
    return out.unsqueeze(dim).expand_as(x)
