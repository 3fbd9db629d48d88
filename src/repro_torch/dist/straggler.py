"""Straggler mitigation for synchronous data parallelism.

Synchronous zones move at the pace of their slowest replica.  The policy
tracks per-replica step durations (host-side, a sliding window) and drops
replicas whose mean exceeds `threshold` x the fleet median — bounded by
`max_drop_fraction` so a mass slowdown (network event, thermal) never
silently shrinks the batch below a floor.  Dropped replicas keep running;
their loss contribution is masked so the gradient stays an average over
healthy replicas only.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict

import numpy as np


class StragglerPolicy:
    def __init__(self, n_replicas: int, threshold: float = 2.0,
                 max_drop_fraction: float = 0.25, window: int = 32):
        assert n_replicas > 0 and threshold > 0
        self.n_replicas = n_replicas
        self.threshold = threshold
        self.max_drop_fraction = max_drop_fraction
        self.window = window
        self._times: Dict[int, Deque[float]] = {
            r: collections.deque(maxlen=window) for r in range(n_replicas)}

    def observe(self, replica: int, duration_s: float) -> None:
        self._times[int(replica)].append(float(duration_s))

    def _means(self) -> np.ndarray:
        return np.asarray([
            np.mean(self._times[r]) if self._times[r] else 0.0
            for r in range(self.n_replicas)])

    def replica_mask(self) -> np.ndarray:
        """(n_replicas,) bool; True = replica participates."""
        means = self._means()
        observed = means > 0
        mask = np.ones(self.n_replicas, bool)
        if not observed.any():
            return mask
        median = float(np.median(means[observed]))
        slow = observed & (means > self.threshold * max(median, 1e-12))
        budget = int(self.max_drop_fraction * self.n_replicas)
        if budget <= 0 or not slow.any():
            return mask
        # drop the slowest first, never more than the budget
        victims = sorted(np.flatnonzero(slow),
                         key=lambda r: (-means[r], r))[:budget]
        mask[list(victims)] = False
        return mask

    def loss_mask(self, global_batch: int) -> np.ndarray:
        """(global_batch,) f32 0/1 mask zeroing dropped replicas' examples.

        The batch is laid out replica-major (replica r owns the contiguous
        slice [r*B/G, (r+1)*B/G)), matching the data-axis sharding.
        """
        per = max(global_batch // self.n_replicas, 1)
        mask = np.repeat(self.replica_mask().astype(np.float32), per)
        if mask.shape[0] < global_batch:     # remainder examples always count
            mask = np.concatenate(
                [mask, np.ones(global_batch - mask.shape[0], np.float32)])
        return mask[:global_batch]
