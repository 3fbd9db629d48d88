"""XOR parity over zone rows (Pangolin §3.1, §3.5), the r = 1 syndrome stack.

The reference runs these inside a shard_map on each rank's local row; here
rows are zone-stacked `(*mesh_dims, row_words)` and `dim` is the data
(zone) dim.  The stack is `(*mesh_dims, r, seg_words)`; at r = 1 its only
plane is the classic XOR parity.  The r >= 2 Reed-Solomon planes
(`reconstruct_e` and the GF weighting) are the next port slice.

  * build  — full XOR reduce-scatter of the rows (init, bulk commits);
  * bulk delta — parity ^= reduce-scatter(old ^ new) from the fused sweep;
  * patch  — the dirty pages' deltas, XOR-reduced across the zone and
             applied to the owners' segments (the paper's atomic XOR);
  * reconstruct — lost row = XOR of survivors XOR parity (§3.6).
"""
from __future__ import annotations

import torch

from repro_torch.core.layout import ZoneLayout
from repro_torch.dist import collectives as coll


def page_view(row: torch.Tensor, block_words: int) -> torch.Tensor:
    """`(*lead, n)` -> `(*lead, n // bw, bw)` pages."""
    return row.reshape(*row.shape[:-1], -1, block_words)


def gather_pages(row: torch.Tensor, page_idx: torch.Tensor,
                 block_words: int) -> torch.Tensor:
    """`(*lead, k, bw)` dirty page contents."""
    return page_view(row, block_words)[..., page_idx, :]


def build_syndromes(row: torch.Tensor, dim: int) -> torch.Tensor:
    """Full stack build: `(*M, n)` rows -> `(*M, 1, n // G)`."""
    return coll.syndrome_reduce_scatter(row, dim)


def apply_sdelta(synd: torch.Tensor, sdelta_rows: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """Bulk stack delta: synd ^= reduce-scatter of the `(*M, r, n)`
    pre-weighted deltas the fused commit sweep emits."""
    return coll.syndrome_apply_delta(synd, sdelta_rows, dim)


def patch_syndrome_delta(synd: torch.Tensor, sdelta_pages: torch.Tensor,
                         page_idx: torch.Tensor, layout: ZoneLayout,
                         dim: int) -> torch.Tensor:
    """Incremental stack patch for the dirty pages' deltas.

    `synd`: `(*M, r, seg)`; `sdelta_pages`: `(*M, r, k, bw)`; `page_idx`:
    `(k,)` unique page indices.  The deltas XOR-reduce across each zone;
    page p lands in the segment of rank p // pages_per_seg.  Returns a new
    stack; `synd` is not modified.
    """
    bw = layout.block_words
    pps = layout.seg_words // bw
    patch = coll.xor_fold(sdelta_pages, dim).movedim(-2, 0)  # (k, *Mo, r, bw)
    owner = page_idx // pps
    local = page_idx % pps
    pages = synd.reshape(*synd.shape[:-1], pps, bw).movedim(dim, 0).clone()
    # (G, *Mo, r, pps, bw): pages[owner[j], ..., local[j], :] is page j's
    # slot on its owner in every zone; indices are unique, so this is exact
    pages[owner, ..., local, :] = pages[owner, ..., local, :] ^ patch
    return pages.movedim(0, dim).reshape(synd.shape)


def verify_syndromes(row: torch.Tensor, synd: torch.Tensor,
                     dim: int) -> torch.Tensor:
    """Zone invariant per syndrome: `(*M_other, r)` bool, one verdict per
    zone, True iff every rank's stored segment matches the rows."""
    fresh = coll.syndrome_reduce_scatter(row, dim)
    return (fresh == synd).all(dim=-1).all(dim=dim)


def reconstruct_row(row: torch.Tensor, parity_seg: torch.Tensor,
                    lost_rank: int, dim: int) -> torch.Tensor:
    """Rebuild the lost rank's row from the survivors and the parity.

    `row`: `(*M, n)`; `parity_seg`: `(*M, n // G)`.  Every rank of a zone
    receives the same rebuilt row (a broadcast view over `dim`).
    """
    lost = torch.tensor([int(lost_rank)], device=row.device)
    contrib = row.index_fill(dim, lost, 0)
    lost_seg = coll.xor_reduce_scatter(contrib, dim) ^ parity_seg
    return coll.all_gather_row(lost_seg, dim)
