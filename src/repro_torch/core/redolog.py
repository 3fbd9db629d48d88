"""Replicated redo log (Pangolin §3.4, §3.6 "crash recovery").

A log record for a step is the recipe to re-execute it deterministically —
(step, data cursor, RNG key words) — plus the digest of the state it
produced.  The log is a fixed ring of K records of int32 words on the
device.  The reference replicates it on every rank; with the zone on one
device there is one copy (the one `np.asarray` of the reference's shows).
Crash recovery reads it back with `replayable_steps` and `lookup`
(runtime/trainer.py).
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
    """The record slot of `step` as a `(K,)` bool mask.  A mask and not an
    index: indexing with a 0-d device tensor reads it on the host, and a
    commit must not wait for the device."""
    return (torch.arange(log.capacity, device=step.device)
            == as_u64(step) % log.capacity)


def _set(x: torch.Tensor, at: torch.Tensor, value) -> torch.Tensor:
    """A copy of `x` with the record at mask `at` set to `value`: a tensor
    on x's device, or host words (one, or one a column).  Selected on the
    device: host words become fill constants, never a blocking copy."""
    if isinstance(value, torch.Tensor):
        at = at.reshape(-1, *([1] * (x.dim() - 1)))
        return torch.where(at, value.to(x.dtype), x)
    if x.dim() == 1:
        return torch.where(at, value, x)
    return torch.stack([torch.where(at, v, x[:, j])
                        for j, v in enumerate(value)], dim=1)


def append(log: RedoLog, step: torch.Tensor, data_cursor: int,
           rng_words: Sequence[int], digest: torch.Tensor) -> RedoLog:
    """Write a record (mark=0), to be marked complete by `commit_mark`.

    `step` is the 0-d step tensor; `rng_words` the two u32 words of the
    step's RNG key (the reference stores `key_data(rng_key)[:2]`).
    """
    at = _slot(log, step)
    return RedoLog(
        step=_set(log.step, at, step),
        data_cursor=_set(log.data_cursor, at, word(data_cursor)),
        rng=_set(log.rng, at, [word(v) for v in rng_words]),
        digest=_set(log.digest, at, digest),
        mark=_set(log.mark, at, 0))


def commit_mark(log: RedoLog, step: torch.Tensor) -> RedoLog:
    """Set the logging-complete mark — the paper's persistent commit point."""
    return dataclasses.replace(log, mark=_set(log.mark, _slot(log, step), 1))



def lookup(log: RedoLog, step: int) -> dict:
    """The record in `step`'s slot: {step, data_cursor, rng, digest, mark}
    as int32 word tensors."""
    slot = (int(step) & 0xFFFFFFFF) % log.capacity
    return dict(step=log.step[slot], data_cursor=log.data_cursor[slot],
                rng=log.rng[slot], digest=log.digest[slot],
                mark=log.mark[slot])


def replayable_steps(log: RedoLog, from_step: int) -> list[int]:
    """Host-side: contiguous marked steps strictly after `from_step` (steps
    read as unsigned words)."""
    steps = as_u64(log.step).tolist()
    marks = as_u64(log.mark).tolist()
    marked = {s for s, m in zip(steps, marks) if m == 1 and s > from_step}
    out, s = [], from_step + 1
    while s in marked:
        out.append(s)
        s += 1
    return out
