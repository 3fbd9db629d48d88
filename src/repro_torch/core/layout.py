"""Zone layout: a sharded state pytree viewed as Pangolin's 2-D zone.

For each non-data mesh coordinate, the G ranks along the **data** axis form
one zone.  Each rank's local shards of every state leaf, as u32 words and
concatenated, form that rank's "chunk row"; leaves ("objects") place at
arbitrary offsets, independent of page boundaries.  The parity row is the
XOR of the G rows, reduce-scattered so each rank stores 1/G of it.

The layout is computed once from abstract shapes + specs and is identical
on every rank.  Rows are zone-stacked: `(*mesh_dims, row_words)`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import utils
from repro_torch.dist import sharding

PyTree = Any

PAGE_WORDS = 1024  # 4 KB pages, as in the paper's recovery granularity.


@dataclasses.dataclass(frozen=True)
class ZoneLayout:
    """Static placement of a state pytree inside the per-rank word row."""
    treedef: Any
    slots: tuple                # tuple[utils.LeafSlot]
    row_words: int              # padded row length (multiple of G * PAGE_WORDS)
    group_size: int             # G — ranks per zone (data-axis size)
    block_words: int            # checksum block == page column width

    @property
    def n_blocks(self) -> int:
        return self.row_words // self.block_words

    @property
    def seg_words(self) -> int:
        """Per-rank parity segment length."""
        return self.row_words // self.group_size

    @property
    def payload_words(self) -> int:
        return sum(s.n_words for s in self.slots)

    # -- storage accounting (the paper's §4.2) --------------------------------
    def overhead_report(self) -> dict:
        state_bytes = self.payload_words * 4
        parity_bytes = self.seg_words * 4          # per rank; 1/G of row
        cksum_bytes = self.n_blocks * 8
        return dict(
            state_bytes_per_rank=state_bytes,
            parity_bytes_per_rank=parity_bytes,
            checksum_bytes_per_rank=cksum_bytes,
            parity_fraction=parity_bytes / max(state_bytes, 1),
            checksum_fraction=cksum_bytes / max(state_bytes, 1),
            replication_fraction=1.0,              # the Pmemobj-R comparison
        )


def build_layout(state: PyTree, group_size: int, specs: PyTree = None,
                 mesh: sharding.ZoneMesh = None,
                 block_words: int = PAGE_WORDS) -> ZoneLayout:
    """Compute the zone layout from abstract state.

    `state`: pytree of leaves with `.shape` and a torch `.dtype` (global
    shapes).  `specs` + `mesh` give each leaf's shard shape; without them
    the shapes are taken as local.
    """
    leaves, treedef = utils.tree_flatten(state)
    spec_leaves = ([None] * len(leaves) if specs is None else
                   utils.tree_leaves(specs))
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} leaves")
    slots = []
    offset = 0
    for leaf, spec in zip(leaves, spec_leaves):
        lshape = (tuple(leaf.shape) if mesh is None else
                  sharding.local_shape(tuple(leaf.shape), spec, mesh))
        n_words = utils.num_words(lshape, leaf.dtype)
        slots.append(utils.LeafSlot(offset=offset, n_words=n_words,
                                    shape=lshape, dtype=leaf.dtype))
        offset += n_words
    row_words = utils.round_up(max(offset, 1), group_size * block_words)
    return ZoneLayout(treedef=treedef, slots=tuple(slots),
                      row_words=row_words, group_size=group_size,
                      block_words=block_words)


def flatten_row(layout: ZoneLayout, local_state: PyTree,
                out: torch.Tensor = None) -> torch.Tensor:
    """Word view + concatenation of zone-stacked shards into the padded row:
    leaves `(*mesh_dims, *local)` -> `(*mesh_dims, row_words)`, each slot
    written once into `out` (an int32 `(*mesh_dims, row_words)` tensor, e.g.
    one tenant's slice of a stacked wave; a new one by default)."""
    leaves = utils.tree_leaves(local_state)
    if len(leaves) != len(layout.slots):
        raise ValueError(f"{len(leaves)} leaves for {len(layout.slots)} slots")
    for i, (leaf, slot) in enumerate(zip(leaves, layout.slots)):
        w = utils.to_words(leaf, batch_dims=leaf.dim() - len(slot.shape))
        if w.shape[-1] != slot.n_words:
            raise ValueError(f"leaf of {w.shape[-1]} words for {slot}")
        if out is None:
            out = torch.empty(*w.shape[:-1], layout.row_words,
                              dtype=utils.WORD, device=w.device)
        out[..., slot.offset:slot.offset + slot.n_words] = w
    out[..., layout.payload_words:] = 0
    return out


def unflatten_row(layout: ZoneLayout, row: torch.Tensor) -> PyTree:
    """Inverse of :func:`flatten_row` — bit-exact."""
    leaves = [utils.from_words(row[..., s.offset:s.offset + s.n_words],
                               s.shape, s.dtype) for s in layout.slots]
    return utils.tree_unflatten(layout.treedef, leaves)


def update_row(layout: ZoneLayout, row: torch.Tensor, new_state: PyTree,
               dirty_leaf_idx: Sequence[int]) -> torch.Tensor:
    """Splice only the dirty leaves' words into a copy of a cached row.

    `row` must equal flatten_row(old state) and leaves outside
    `dirty_leaf_idx` must be unchanged.
    """
    leaves = utils.tree_leaves(new_state)
    out = row.clone()
    for i in dirty_leaf_idx:
        slot = layout.slots[i]
        leaf = leaves[i]
        w = utils.to_words(leaf, batch_dims=leaf.dim() - len(slot.shape))
        out[..., slot.offset:slot.offset + slot.n_words] = w
    return out


def leaves_for_pages(layout: ZoneLayout, pages: Sequence[int]) -> list:
    """Leaf indices whose slots overlap any of the given page columns."""
    wanted = {int(p) for p in pages}
    out = []
    for i, slot in enumerate(layout.slots):
        first = slot.offset // layout.block_words
        last = (slot.offset + max(slot.n_words, 1) - 1) // layout.block_words
        if any(first <= p <= last for p in wanted):
            out.append(i)
    return out


def leaf_pages(layout: ZoneLayout, leaf_index: int) -> np.ndarray:
    """Page-column indices overlapping a given leaf (for targeted patches)."""
    slot = layout.slots[leaf_index]
    first = slot.offset // layout.block_words
    last = (slot.offset + slot.n_words - 1) // layout.block_words
    return np.arange(first, last + 1)


def range_pages(layout: ZoneLayout, offset: int, n_words: int) -> np.ndarray:
    first = offset // layout.block_words
    last = (offset + max(n_words, 1) - 1) // layout.block_words
    return np.arange(first, last + 1)
