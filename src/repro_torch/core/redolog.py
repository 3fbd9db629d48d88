"""Replicated redo log (Pangolin §3.4, §3.6 "crash recovery").

A log record for a step is the recipe to re-execute it deterministically —
(step, data cursor, RNG key words) — plus the digest of the state it
produced.  The log is a fixed ring of K records of int32 words on the
device.  The reference replicates it on every rank; with the zone on one
device there is one copy (the one `np.asarray` of the reference's shows).
Replay (`lookup`, `replayable_steps`) arrives with the trainer (ROADMAP
queue A, slice S8).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.utils import WORD, as_u64, resolve_device, word


@dataclasses.dataclass
class RedoLog:
    step: torch.Tensor         # (K,)   step id of each record
    data_cursor: torch.Tensor  # (K,)   data-pipeline cursor to replay
    rng: torch.Tensor          # (K, 2) RNG key words of the step
    digest: torch.Tensor       # (K, 2) row digest after the step
    mark: torch.Tensor         # (K,)   1 = logging complete (commit mark)

    @property
    def capacity(self) -> int:
        return self.step.shape[0]


def make(capacity: int = 64, device=None) -> RedoLog:
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(capacity, *shape, dtype=WORD, device=device)
    return RedoLog(step=z(), data_cursor=z(), rng=z(2), digest=z(2), mark=z())


def _slot(log: RedoLog, step: torch.Tensor) -> torch.Tensor:
    return as_u64(step) % log.capacity


def _set(x: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    out = x.clone()
    out[slot] = torch.as_tensor(value, dtype=WORD, device=x.device)
    return out


def append(log: RedoLog, step: torch.Tensor, data_cursor: int,
           rng_words: Sequence[int], digest: torch.Tensor) -> RedoLog:
    """Write a record (mark=0), to be marked complete by `commit_mark`.

    `step` is the 0-d step tensor; `rng_words` the two u32 words of the
    step's RNG key (the reference stores `key_data(rng_key)[:2]`).
    """
    slot = _slot(log, step)
    return RedoLog(
        step=_set(log.step, slot, step),
        data_cursor=_set(log.data_cursor, slot, word(data_cursor)),
        rng=_set(log.rng, slot, [word(v) for v in rng_words]),
        digest=_set(log.digest, slot, digest),
        mark=_set(log.mark, slot, 0))


def commit_mark(log: RedoLog, step: torch.Tensor) -> RedoLog:
    """Set the logging-complete mark — the paper's persistent commit point."""
    return dataclasses.replace(log, mark=_set(log.mark, _slot(log, step), 1))

