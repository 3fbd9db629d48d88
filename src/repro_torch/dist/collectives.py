"""XOR collectives over the zone (data) dim of zone-stacked tensors.

The reference runs these inside a shard_map, one device per rank, built
from all-to-all / all-gather plus local folds (XOR is not a native
collective reduction in XLA or NCCL).  With the whole zone on one device
(dist/sharding.py), a collective over the zone axis is a fold over the
data dim of the stacked tensor; `dim` names that dim
(`ZoneMesh.data_dim`).  Every operand is an int32 word tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import utils
from repro_torch.kernels import ops as kops


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


def xor_reduce_scatter(row: torch.Tensor, dim: int) -> torch.Tensor:
    """`(*M, n)` rows -> `(*M, n // G)`: rank i along `dim` keeps segment
    i of the XOR of the G rows of its zone."""
    g, n = row.shape[dim], row.shape[-1]
    if n % g:
        raise ValueError(f"row of {n} words does not split into {g} segments")
    segs = row.reshape(*row.shape[:-1], g, n // g)
    return xor_fold(segs, dim).movedim(-2, dim)


def all_gather_row(seg: torch.Tensor, dim: int) -> torch.Tensor:
    """`(*M, s)` segments -> `(*M, G * s)`: every rank of a zone receives
    the concatenation of its zone's segments in rank order."""
    full = seg.movedim(dim, -2)
    full = full.reshape(*full.shape[:-2], -1).unsqueeze(dim)
    return full.expand(*seg.shape[:-1], full.shape[-1])


def xor_all_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of x across each zone, delivered to every rank (same shape).
    Returns a broadcast view: read it, do not write into it."""
    return xor_fold(x, dim).unsqueeze(dim).expand_as(x)


# The weighted planes of a row take r times its bytes, and their fold half
# as much again.  Past this many bytes of planes they are built and folded
# one zone segment at a time, G launches of sdelta_stack instead of one.
WEIGHTED_BYTES = 1 << 32


def syndrome_reduce_scatter(row: torch.Tensor, dim: int,
                            coeffs: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
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
        return xor_reduce_scatter(kops.syndrome_scale(row, coeffs), dim)
    g, n = row.shape[dim], row.shape[-1]
    if n % g:
        raise ValueError(f"row of {n} words does not split into {g} segments")
    segs = row.reshape(*row.shape[:-1], g, n // g)
    return torch.stack([
        xor_fold(kops.syndrome_scale(segs[..., i, :].contiguous(), coeffs),
                 dim) for i in range(g)], dim=dim)


def syndrome_apply_delta(synd: torch.Tensor, sdelta: torch.Tensor,
                         dim: int) -> torch.Tensor:
    """Bulk stack delta: `synd ^ reduce-scatter(sdelta)`, plane by plane.
    `synd`: `(*M, r, s)`; `sdelta`: `(*M, r, n)` pre-weighted delta rows."""
    return synd ^ xor_reduce_scatter(sdelta, dim)


def meta_all_gather(x: torch.Tensor, dim: int, n_axes: int) -> torch.Tensor:
    """Replicate small per-rank metadata across the zone: `(*M, *s)` ->
    `(*M, G, *s)`, where every device of a zone holds the stacked table of
    its zone's G values in rank order (out[..., i, ...] is rank i's).
    `n_axes` is the number of leading mesh dims."""
    return x.movedim(dim, n_axes - 1).unsqueeze(dim).expand(
        *x.shape[:n_axes], x.shape[dim], *x.shape[n_axes:])


def make_meta_mirror():
    """The window-meta mirror: a function that takes a tuple of tensors
    (None entries pass through) and returns detached copies.  The reference
    reshards its tuple to every device so that a lost rank's copy survives
    on the others; with the zone on one device a copy is that mirror — it
    must be a copy, not a view, because the window's tensors are replaced
    every commit.  The copies are queued on the device's stream: no host
    sync."""
    return lambda tree: utils.tree_map(
        lambda t: t.detach().clone(), tree)


def xor_tree_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The reference's recursive-doubling XOR all-reduce (power-of-two
    zones only, as there): on one device it is the XOR fold over the data
    dim, delivered to every rank (a broadcast view, as `xor_all_reduce`)."""
    g = x.shape[dim]
    if g & (g - 1):
        raise ValueError(f"tree reduce needs a power-of-two zone, got {g}")
    return xor_all_reduce(x, dim)
