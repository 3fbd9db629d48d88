"""Micro-buffering and canaries (Pangolin §3.2).

A staged kernel output carries a guard page of a fixed pattern; a kernel
that writes past its buffer smashes it, and the commit sees that before
it touches protected state (the transaction aborts).  Buffers are int32
words.
"""
from __future__ import annotations

import torch

from repro_torch.utils import WORD, word

CANARY_WORD = word(0xDEADBEEF)
CANARY_WORDS = 128  # one canary "page" of guard words


def guard(row: torch.Tensor) -> torch.Tensor:
    """Append a canary page to a 1-D int32 buffer."""
    canary = torch.full((CANARY_WORDS,), CANARY_WORD, dtype=WORD,
                        device=row.device)
    return torch.cat([row, canary])


def split(guarded: torch.Tensor) -> tuple:
    return guarded[:-CANARY_WORDS], guarded[-CANARY_WORDS:]


def check(guarded: torch.Tensor) -> torch.Tensor:
    """True iff the canary is intact (no overrun into the guard page)."""
    _, canary = split(guarded)
    return (canary == CANARY_WORD).all()


def guard_nd(x: torch.Tensor) -> torch.Tensor:
    """Guard an N-D staging buffer by appending a canary row on dim 0."""
    if x.dtype != WORD:
        raise TypeError("guard_nd stages int32 word buffers")
    canary = torch.full((1, *x.shape[1:]), CANARY_WORD, dtype=WORD,
                        device=x.device)
    return torch.cat([x, canary], dim=0)


def check_nd(guarded: torch.Tensor) -> torch.Tensor:
    return (guarded[-1] == CANARY_WORD).all()


def interior_nd(guarded: torch.Tensor) -> torch.Tensor:
    return guarded[:-1]
