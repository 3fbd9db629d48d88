"""Deterministic, resumable synthetic data pipeline (the reference's
data/synthetic.py).

Crash recovery (Pangolin §3.6) requires replaying logged steps *exactly*:
the redo log stores a `data_cursor`, and the pipeline must regenerate the
identical batch for any cursor — so batches are a pure function of
(seed, cursor).  `batch_at` is the reference's numpy code, byte for byte;
`device_batch` copies a batch to the device without blocking.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import utils


@dataclasses.dataclass
class SyntheticStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mm_positions: int = 0
    d_model: int = 0              # for mm/src embed stubs
    enc_dec: bool = False

    def batch_at(self, cursor: int) -> dict:
        """Pure function of (seed, cursor) -> host numpy batch."""
        rng = np.random.default_rng((self.seed << 32) ^ cursor)
        n_tok = self.seq_len - self.mm_positions
        # Zipf-ish marginal with a cursor-dependent shift so content varies
        ranks = rng.zipf(1.3, size=(self.global_batch, n_tok))
        tokens = (ranks + cursor) % self.vocab
        batch = {"tokens": tokens.astype(np.int32)}
        if self.mm_positions:
            batch["mm_embeds"] = rng.standard_normal(
                (self.global_batch, self.mm_positions, self.d_model)
            ).astype(np.float32) * 0.02
        if self.enc_dec:
            batch["src_embeds"] = rng.standard_normal(
                (self.global_batch, self.seq_len, self.d_model)
            ).astype(np.float32) * 0.02
        return batch

    def device_batch(self, cursor: int, device=None) -> dict:
        """`batch_at(cursor)` on `device` (the card unless the caller asks
        for the CPU), each copy enqueued without blocking."""
        device = utils.resolve_device(device)
        return {k: utils.to_device(v, device)
                for k, v in self.batch_at(cursor).items()}


def batch_for(cfg, seq_len: int, global_batch: int, seed: int = 0
              ) -> SyntheticStream:
    return SyntheticStream(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed, mm_positions=cfg.mm_positions, d_model=cfg.d_model,
        enc_dec=cfg.enc_layers > 0)
