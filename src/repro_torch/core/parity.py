"""Parity over zone rows (Pangolin §3.1, §3.5) and its Reed-Solomon
extension, the syndrome stack S_0..S_{r-1} (S_k = XOR_i g^(k·i)·row_i over
GF(2^32), core/gf.py; S_0 is the classic XOR parity).

The reference runs these inside a shard_map on each rank's local row; here
rows are zone-stacked `(*mesh_dims, row_words)` and `dim` is the data
(zone) dim.  The stack is `(*mesh_dims, r, seg_words)`.  `coeffs` is each
rank's `(*mesh_dims, r)` coefficient table (`gf.rank_syndrome_coeffs`),
None at r = 1.

  * build  — the weighted reduce-scatter of the rows (init, bulk commits);
  * bulk delta — stack ^= reduce-scatter of the fused sweep's weighted
             deltas;
  * patch  — the dirty pages' weighted deltas, XOR-reduced across the zone
             and applied to the owners' segments (the paper's atomic XOR);
  * hybrid — patch or build by dirty fraction (the paper's §3.5 crossover);
  * reconstruct — one lost row = XOR of survivors XOR parity (§3.6); e <= r
             lost rows through the e x e Vandermonde inverse.

The single-parity forms (`patch_parity`, `patch_parity_delta`,
`hybrid_update`, `verify_parity`) are the r = 1 views of the stack
functions, kept as the reference keeps them.

On a zone split over processes (dist/procs.py) the functions the
synchronous engine calls take the mesh's `group`: the rows hold this
process's block of G / W ranks, ranks and page owners are global, a
lost rank or a page owner held by another process is left to it, and
every verdict is ANDed across the processes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import gf
from repro_torch.core.layout import ZoneLayout
from repro_torch.dist import collectives as coll
from repro_torch.kernels import ops as kops


def page_view(row: torch.Tensor, block_words: int) -> torch.Tensor:
    """`(*lead, n)` -> `(*lead, n // bw, bw)` pages."""
    return row.reshape(*row.shape[:-1], -1, block_words)


def gather_pages(row: torch.Tensor, page_idx: torch.Tensor,
                 block_words: int) -> torch.Tensor:
    """`(*lead, k, bw)` dirty page contents."""
    return page_view(row, block_words)[..., page_idx, :]


def _held_ranks(ranks, g_local: int, group=None) -> list:
    """The local data indices of those global `ranks` this process holds
    (all of them, unchecked, without a group)."""
    if group is None:
        return [int(a) for a in ranks]
    off = group.rank * g_local
    return [int(a) - off for a in ranks if 0 <= int(a) - off < g_local]


def build_syndromes(row: torch.Tensor, dim: int,
                    coeffs: Optional[torch.Tensor] = None,
                    group=None) -> torch.Tensor:
    """Full stack build: `(*M, n)` rows -> `(*M, r, n // G)`."""
    return coll.syndrome_reduce_scatter(row, dim, coeffs, group)


def apply_sdelta(synd: torch.Tensor, sdelta_rows: torch.Tensor,
                 dim: int, group=None) -> torch.Tensor:
    """Bulk stack delta: synd ^= reduce-scatter of the `(*M, r, n)`
    pre-weighted deltas the fused commit sweep emits."""
    return coll.syndrome_apply_delta(synd, sdelta_rows, dim, group)


def patch_syndrome_delta(synd: torch.Tensor, sdelta_pages: torch.Tensor,
                         page_idx: torch.Tensor, layout: ZoneLayout,
                         dim: int, group=None) -> torch.Tensor:
    """Incremental stack patch for the dirty pages' deltas.

    `synd`: `(*M, r, seg)`; `sdelta_pages`: `(*M, r, k, bw)`; `page_idx`:
    `(k,)` page indices, unique below `n_blocks`; an entry equal to
    `n_blocks` is the out-of-range sentinel and is dropped (the reference's
    scatter `mode="drop"`), however often it repeats.  The deltas
    XOR-reduce across each zone; page p lands in the segment of rank
    p // pages_per_seg, on the process that holds that rank.  Returns a
    new stack; `synd` is not modified.
    """
    bw = layout.block_words
    pps = layout.seg_words // bw
    g = synd.shape[dim]
    # (k, *Mo, r, bw)
    patch = coll.xor_reduce(sdelta_pages, dim, group).movedim(-2, 0)
    owner = page_idx // pps
    if group is not None:
        # owners held by another process go to the scratch slot as well
        owner = owner - group.rank * g
        owner = torch.where((owner >= 0) & (owner < g), owner, g)
    local = page_idx % pps
    seg_pages = synd.reshape(*synd.shape[:-1], pps, bw).movedim(dim, 0)
    # (G + 1, *Mo, r, pps, bw): pages[owner[j], ..., local[j], :] is page
    # j's slot on its owner in every zone; the sentinel's owner is G, a
    # scratch slot cut off below.  Real indices are unique, so this is exact
    pages = torch.cat([seg_pages, seg_pages[:1]])
    pages[owner, ..., local, :] = pages[owner, ..., local, :] ^ patch
    return pages[:g].movedim(0, dim).reshape(synd.shape)


def patch_parity_delta(parity_seg: torch.Tensor, delta_pages: torch.Tensor,
                       page_idx: torch.Tensor, layout: ZoneLayout,
                       dim: int) -> torch.Tensor:
    """`patch_parity` for callers that already hold the delta: the r = 1
    view of `patch_syndrome_delta`.  `parity_seg`: `(*M, seg)`;
    `delta_pages`: `(*M, k, bw)`."""
    return patch_syndrome_delta(parity_seg.unsqueeze(-2),
                                delta_pages.unsqueeze(-3), page_idx, layout,
                                dim)[..., 0, :]


def patch_parity(parity_seg: torch.Tensor, old_pages: torch.Tensor,
                 new_pages: torch.Tensor, page_idx: torch.Tensor,
                 layout: ZoneLayout, dim: int) -> torch.Tensor:
    """Incremental parity patch for the dirty pages: the delta old ^ new
    (the `xor_delta` kernel), XOR-reduced across each zone and applied to
    the owners' segments.  `old_pages`/`new_pages`: `(*M, k, bw)`."""
    return patch_parity_delta(parity_seg, kops.xor_delta(old_pages, new_pages),
                              page_idx, layout, dim)


def hybrid_update(row_old: torch.Tensor, row_new: torch.Tensor,
                  parity_seg: torch.Tensor, layout: ZoneLayout, dim: int,
                  dirty_page_idx=None,
                  threshold_fraction: float = 0.5) -> torch.Tensor:
    """Patch or build by dirty fraction (a static decision): None means
    everything changed, an empty list a metadata-only transaction (parity
    unchanged); at or past `threshold_fraction` of the pages the parity is
    rebuilt from `row_new`."""
    if dirty_page_idx is not None and len(dirty_page_idx) == 0:
        return parity_seg
    if (dirty_page_idx is None
            or len(dirty_page_idx) / layout.n_blocks >= threshold_fraction):
        return coll.xor_reduce_scatter(row_new, dim)
    idx = torch.as_tensor(dirty_page_idx, device=row_new.device)
    bw = layout.block_words
    return patch_parity(parity_seg, gather_pages(row_old, idx, bw),
                        gather_pages(row_new, idx, bw), idx, layout, dim)


def verify_syndromes(row: torch.Tensor, synd: torch.Tensor, dim: int,
                     coeffs: Optional[torch.Tensor] = None,
                     group=None) -> torch.Tensor:
    """Zone invariant per syndrome: `(*M_other, r)` bool, one verdict per
    zone and syndrome, True iff every rank's stored segment of S_k matches
    the rows."""
    fresh = coll.syndrome_reduce_scatter(row, dim, coeffs, group)
    ok = (fresh == synd).all(dim=-1).all(dim=dim)
    return ok if group is None else group.all_and(ok)


def verify_parity(row: torch.Tensor, parity_seg: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """Zone invariant of the XOR parity: `(*M_other)` bool, True iff the XOR
    of each zone's rows equals its stored parity segments."""
    fresh = coll.xor_reduce_scatter(row, dim)
    return (fresh == parity_seg).all(dim=-1).all(dim=dim)


def _without(row: torch.Tensor, ranks, dim: int, group) -> torch.Tensor:
    """`row` with the held ones of the global `ranks` zero-filled."""
    held = _held_ranks(ranks, row.shape[dim], group)
    return row.index_fill(dim, torch.tensor(held, dtype=torch.long,
                                            device=row.device), 0)


def reconstruct_row(row: torch.Tensor, parity_seg: torch.Tensor,
                    lost_rank: int, dim: int, group=None) -> torch.Tensor:
    """Rebuild the lost rank's row from the survivors and the parity.

    `row`: `(*M, n)`; `parity_seg`: `(*M, n // G)`.  Every rank of a zone
    receives the same rebuilt row (a broadcast view over `dim`).
    """
    contrib = _without(row, [lost_rank], dim, group)
    lost_seg = coll.xor_reduce_scatter(contrib, dim, group) ^ parity_seg
    return coll.all_gather_row(lost_seg, dim, group)


def reconstruct_e(row: torch.Tensor, synd: torch.Tensor, lost_ranks,
                  dim: int, coeffs: Optional[torch.Tensor],
                  group=None) -> tuple:
    """Rebuild e <= r lost ranks' rows in every zone from the stack.

    `row`: `(*M, n)`; `synd`: `(*M, r, n // G)`; `lost_ranks`: distinct
    host ints; `coeffs`: the `(*M, r)` table (None at r = 1).  Survivors
    contribute their rows to the first e syndromes and the lost ranks
    contribute zeros, so S_k ^ s_k = XOR_j g^(k·a_j)·X_j for k < e, which
    `gf.solve_e` inverts.  Returns the e rebuilt rows in `lost_ranks`
    order, each a broadcast view that every rank of a zone receives.
    """
    ranks = tuple(int(a) for a in lost_ranks)
    e = len(ranks)
    if e < 1 or len(set(ranks)) != e:
        raise ValueError(f"erasure recovery needs distinct ranks, got {ranks}")
    if e > synd.shape[-2]:
        raise ValueError(f"{e} erasures need {e} syndromes; the stack holds "
                         f"{synd.shape[-2]}")
    contrib = _without(row, ranks, dim, group)
    survivors = coll.syndrome_reduce_scatter(
        contrib, dim, None if e == 1 else coeffs[..., :e].contiguous(),
        group)
    deficits = (synd[..., :e, :] ^ survivors).movedim(-2, 0).contiguous()
    return tuple(coll.all_gather_row(seg, dim, group)
                 for seg in gf.solve_e(deficits, ranks))
