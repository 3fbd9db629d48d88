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


# A decode step writes one "time slot" of every cache leaf: for a leaf of
# local shape s with its sequence axis at dim d (identified as an axis of
# length `time_size`), position p touches, for every combination of the
# axes before d, a contiguous run of prod(s[d+1:]) elements starting at
# element offset p * prod(s[d+1:]).  Leaves with no axis of that length
# (recurrent hidden state, conv windows) are rewritten wholly every step
# and count as fully dirty.  All byte math is done on the slot's placement
# inside the word row, so runs that straddle page-column boundaries are
# attributed to both pages.  The result is the same on every zone rank
# (the layout is), which the parity patch path requires.


def _slot_time_runs(slot, time_size: int) -> list:
    """(outer, stride_bytes, run_bytes) descriptors for each candidate
    time axis of the slot; [] when the slot has no axis of that length.

    If several axes match `time_size` the union over all of them is taken
    — a conservative superset that stays correct whichever axis is the
    real sequence axis.
    """
    esize = slot.dtype.itemsize
    runs = []
    for d, sz in enumerate(slot.shape):
        if sz != time_size:
            continue
        inner = int(np.prod(slot.shape[d + 1:], dtype=np.int64))
        outer = int(np.prod(slot.shape[:d], dtype=np.int64))
        runs.append((outer, sz * inner * esize, inner * esize))
    return runs


def time_slice_pages(layout: ZoneLayout, time_size: int,
                     pos: int) -> np.ndarray:
    """Page columns touched by writing time slot `pos` of every leaf.

    Ring-buffer caches wrap (`pos % time_size`); leaves without a
    `time_size` axis contribute all of their pages.  Returns sorted
    unique page indices (np.int32).
    """
    page_bytes = layout.block_words * 4
    p = int(pos) % time_size
    pages = []
    for slot in layout.slots:
        base = slot.offset * 4
        runs = _slot_time_runs(slot, time_size)
        if not runs:
            pages.append(range_pages(layout, slot.offset, slot.n_words))
            continue
        for outer, stride_b, run_b in runs:
            starts = base + np.arange(outer, dtype=np.int64) * stride_b \
                + p * run_b
            first = starts // page_bytes
            last = (starts + max(run_b, 1) - 1) // page_bytes
            span = int((last - first).max()) + 1 if outer else 1
            cand = first[:, None] + np.arange(span)[None, :]
            pages.append(cand[cand <= last[:, None]])
    out = np.unique(np.concatenate(pages)) if pages else np.zeros(0, np.int64)
    return out.astype(np.int32)


def time_slice_words(layout: ZoneLayout, time_size: int, pos: int) -> list:
    """Per-leaf *word* indices touched by writing time slot `pos`.

    Returns one entry per slot: an int32 array of word indices local to
    the slot's word range, or None meaning "whole leaf dirty" (no
    `time_size` axis, an ambiguous shape with several candidate axes, or
    a degenerate time_size < 2).

    The array's shape is position-independent.  For word-aligned runs the
    indices are exact and duplicate-free; for unaligned (sub-word dtype)
    runs each run is widened to a fixed span that may overhang into the
    next time slot's words — never into words this step modifies — and
    may step past the slot's end, so consumers gather with fill semantics
    (out of range -> identical old and new values).
    """
    if time_size < 2:
        return [None] * len(layout.slots)
    p = int(pos) % time_size
    out = []
    for slot in layout.slots:
        runs = _slot_time_runs(slot, time_size)
        if len(runs) != 1:
            # no time axis, or several candidates whose run unions could
            # overlap (and so double-count): whole leaf
            out.append(None)
            continue
        outer, stride_b, run_b = runs[0]
        starts = np.arange(outer, dtype=np.int64) * stride_b + p * run_b
        if run_b % 4 == 0 and stride_b % 4 == 0:
            span = run_b // 4                  # aligned: exact, every pos
        else:
            span = run_b // 4 + 2              # overhang absorbed by fill
        first = starts // 4
        out.append((first[:, None]
                    + np.arange(span, dtype=np.int64)[None, :]
                    ).reshape(-1).astype(np.int32))
    return out


def time_slice_page_capacity(layout: ZoneLayout, time_size: int) -> int:
    """Upper bound on len(time_slice_pages(...)) over all positions.

    Analytic, position-free: each run can straddle at most
    run_bytes // page_bytes + 2 page columns.  Clamped to n_blocks.
    """
    page_bytes = layout.block_words * 4
    total = 0
    for slot in layout.slots:
        runs = _slot_time_runs(slot, time_size)
        if not runs:
            total += len(range_pages(layout, slot.offset, slot.n_words))
            continue
        for outer, _, run_b in runs:
            total += outer * (run_b // page_bytes + 2)
    return min(total, layout.n_blocks)
