"""Failure injection (Pangolin §4.6).

  * `inject_rank_loss`    — garbles one data-rank's entire state shard in
    every zone (chip/host failure, HBM UE); the returned FailureEvent is
    what the runtime feeds to recovery.
  * `inject_multi_rank_loss` — garbles e data-ranks' shards at once
    (overlapping failures, recoverable online when e <= r).
  * `inject_scribble`     — XORs a mask into chosen words of one rank's
    flat row (SDC / wild-store analogue), invisible until a checksum
    verification catches it.
  * `smashed_canary_buffer` — a staged buffer whose guard page a kernel
    overran (caught at commit, before state is touched).

Every injector returns a new ProtectedState; the tensors it was given are
not modified.  Ranks are global: on a zone split over processes every
process calls the injector alike, and only the one holding a victim rank
changes its block.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import layout as layout_mod
from repro_torch.core import microbuffer
from repro_torch.core.txn import ProtectedState, Protector, select
from repro_torch.utils import WORD, resolve_device, word


@dataclasses.dataclass
class FailureEvent:
    kind: str                  # "rank_loss" | "multi_loss" | "scribble"
                               # | "canary"
    lost_rank: Optional[int] = None
    locations: Optional[list] = None   # [(rank, page)] for scribbles
    lost_ranks: Optional[list] = None  # every lost rank for multi_loss


def inject_rank_loss(protector: Protector, prot: ProtectedState,
                     rank: int) -> tuple:
    """Overwrite one data-rank's shards with garbage; returns (prot, event)."""
    lo = protector.layout
    row = layout_mod.flatten_row(lo, prot.state)
    victim = protector.rank_index(row.device) == int(rank)
    out = select(victim, row ^ word(0xA5A5A5A5), row)
    return (dataclasses.replace(prot, state=layout_mod.unflatten_row(lo, out)),
            FailureEvent("rank_loss", lost_rank=int(rank)))


def inject_multi_rank_loss(protector: Protector, prot: ProtectedState,
                           ranks) -> tuple:
    """Garble e >= 2 distinct data-ranks' shards at once; returns (prot,
    event) with a "multi_loss" event carrying every lost rank."""
    ranks = [int(r) for r in ranks]
    dead = sorted(set(ranks))
    if len(dead) != len(ranks) or len(dead) < 2:
        raise ValueError(f"multi loss needs >= 2 distinct ranks, got {ranks}")
    lo = protector.layout
    row = layout_mod.flatten_row(lo, prot.state)
    me = protector.rank_index(row.device)
    victim = torch.isin(me, torch.tensor(dead, device=row.device))
    out = select(victim, row ^ word(0xA5A5A5A5), row)
    return (dataclasses.replace(prot, state=layout_mod.unflatten_row(lo, out)),
            FailureEvent("multi_loss", lost_ranks=dead))


def inject_double_rank_loss(protector: Protector, prot: ProtectedState,
                            ranks) -> tuple:
    """The e = 2 multi-rank loss."""
    a, b = (int(r) for r in ranks)
    return inject_multi_rank_loss(protector, prot, (a, b))


def inject_scribble(protector: Protector, prot: ProtectedState,
                    rank: int, word_offsets: Sequence[int],
                    xor_mask: int = 0x00010000) -> tuple:
    """Flip bits at given word offsets of one rank's row (silent until scrub)."""
    lo = protector.layout
    row = layout_mod.flatten_row(lo, prot.state)
    offsets = torch.as_tensor(list(word_offsets), device=row.device)
    mask = torch.zeros(lo.row_words, dtype=WORD, device=row.device)
    mask[offsets] = word(xor_mask)
    victim = protector.rank_index(row.device) == int(rank)
    out = select(victim, row ^ mask, row)
    pages = sorted({int(o) // lo.block_words for o in word_offsets})
    return (dataclasses.replace(prot, state=layout_mod.unflatten_row(lo, out)),
            FailureEvent("scribble", locations=[(int(rank), p) for p in pages]))


# ---------------------------------------------------------------------------
# Seeded deterministic injectors: the same victims on every run of a seed,
# drawn exactly as the reference draws them — np.random.default_rng seeded
# with (seed, crc32(kind)).
# ---------------------------------------------------------------------------


def _rng(seed: int, kind: str) -> np.random.Generator:
    return np.random.default_rng((int(seed), zlib.crc32(kind.encode())))


def seeded_rank_loss(protector: Protector, prot: ProtectedState,
                     seed: int, rank: Optional[int] = None) -> tuple:
    """Deterministic rank loss: victim drawn from (seed, "rank_loss")."""
    if rank is None:
        rank = int(_rng(seed, "rank_loss").integers(protector.group_size))
    return inject_rank_loss(protector, prot, rank)


def seeded_multi_rank_loss(protector: Protector, prot: ProtectedState,
                           seed: int, e: int = 2,
                           ranks: Optional[Sequence[int]] = None) -> tuple:
    """Deterministic e-rank loss: victims drawn without replacement from
    (seed, "multi_loss")."""
    if ranks is None:
        ranks = _rng(seed, "multi_loss").choice(
            protector.group_size, size=e, replace=False)
    return inject_multi_rank_loss(protector, prot, [int(r) for r in ranks])


def scribble_plan(protector: Protector, seed: int,
                  n_words: int = 4, rank: Optional[int] = None) -> tuple:
    """Deterministic scribble parameters: (rank, word_offsets, xor_mask),
    drawn from the payload region only (a scribble into row padding
    vanishes on unflatten and would test nothing)."""
    g = _rng(seed, "scribble")
    if rank is None:
        rank = int(g.integers(protector.group_size))
    row_words = protector.layout.payload_words
    offsets = sorted(int(o) for o in g.choice(
        row_words, size=min(n_words, row_words), replace=False))
    mask = int(g.integers(1, 1 << 32))
    return rank, offsets, mask


def seeded_scribble(protector: Protector, prot: ProtectedState,
                    seed: int, n_words: int = 4,
                    rank: Optional[int] = None) -> tuple:
    """Deterministic scribble: victims from `scribble_plan(seed)`."""
    rank, offsets, mask = scribble_plan(protector, seed,
                                        n_words=n_words, rank=rank)
    return inject_scribble(protector, prot, rank, offsets, xor_mask=mask)


def smashed_canary_buffer(n_words: int = 4096, device=None) -> torch.Tensor:
    """A staged micro-buffer whose guard page was overrun (for tests), on
    the card unless `device` says otherwise."""
    buf = microbuffer.guard(torch.zeros(n_words, dtype=WORD,
                                        device=resolve_device(device)))
    buf[n_words + 3] = word(0x12345678)   # an out-of-bounds write past the payload
    return buf
