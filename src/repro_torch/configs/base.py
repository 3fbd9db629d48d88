"""`ProtectConfig`: the single protection knob, validated as the reference
validates it (configs/base.py)."""
from __future__ import annotations

import dataclasses

_PROTECT_MODES = ("none", "ml", "mlp", "mlpc", "replica", "mlp2", "mlpc2")
MAX_REDUNDANCY = 4


@dataclasses.dataclass(frozen=True)
class ProtectConfig:
    mode: str = "mlpc"                # none | ml | mlp | mlpc | replica
                                      # (mlp2/mlpc2 = dual-parity aliases)
    block_words: int = 1024
    hybrid_threshold: float = 0.5
    scrub_period: int = 0             # transactions between scrubs; 0 = off
    log_capacity: int = 64
    overlap_commit: bool = False      # dispatch step t+1 before awaiting t
    pipeline_depth: int = 1           # async commit ring depth (1 = sync)
    window: int = 1                   # deferred-epoch window W (1 = sync)
    redundancy: int = 1               # syndrome stack height r (1..4)
    window_growth_commits: int = 32   # clean commits before window regrowth
    full_scrub_every: int = 1         # N > 1: pre-check on due scrubs, the
                                      # global scrub every Nth
    stream_threshold_words: int = 1 << 20
                                      # rows at least this long take the
                                      # streamed commit route; 0 = flat always
    stream_chunk_words: int = 1 << 16  # words per streamed chunk
    straggler_threshold: float = 0.0  # > 0: straggler mitigation

    @property
    def resolved_mode(self):
        """The effective base protection Mode (aliases folded)."""
        from repro_torch.core.txn import resolved_mode
        return resolved_mode(self.mode, self.redundancy)[0]

    @property
    def resolved_redundancy(self) -> int:
        """The effective syndrome stack height (aliases folded)."""
        from repro_torch.core.txn import resolved_mode
        return resolved_mode(self.mode, self.redundancy)[1]

    def __post_init__(self):
        if self.mode not in _PROTECT_MODES:
            raise ValueError(
                f"ProtectConfig.mode={self.mode!r} is not a protection "
                f"level; pick one of {', '.join(_PROTECT_MODES)} "
                "(Table 2 ladder: none < ml < mlp < mlpc; replica = 2x "
                "storage baseline)")
        if self.window < 1:
            raise ValueError(
                f"ProtectConfig.window={self.window} — the deferred-epoch "
                "window counts commits per redundancy refresh, so it must "
                "be >= 1 (1 = synchronous per-commit protection)")
        if self.scrub_period < 0:
            raise ValueError(
                f"ProtectConfig.scrub_period={self.scrub_period} — use 0 "
                "to disable scrubbing or a positive transaction count "
                "between scrubs")
        if not 1 <= self.redundancy <= MAX_REDUNDANCY:
            raise ValueError(
                f"ProtectConfig.redundancy={self.redundancy} — the "
                f"syndrome stack holds 1 to {MAX_REDUNDANCY} rows")
        if self.redundancy > 1 and self.mode not in ("mlp", "mlpc",
                                                     "mlp2", "mlpc2"):
            raise ValueError(
                f"ProtectConfig.redundancy={self.redundancy} with "
                f"mode={self.mode!r} — extra syndromes extend parity, so "
                "redundancy>1 requires a parity mode (mlp or mlpc)")
        if self.window > 1 and self.mode in ("none", "ml", "replica"):
            raise ValueError(
                f"ProtectConfig.window={self.window} with "
                f"mode={self.mode!r} — the deferred-epoch window batches "
                "parity/checksum refreshes, which this mode does not "
                "maintain; use mlp or mlpc, or window=1")
        if self.pipeline_depth < 1:
            raise ValueError(
                f"ProtectConfig.pipeline_depth={self.pipeline_depth} — "
                "the async commit ring holds at least one in-flight "
                "commit (1 = resolve every verdict before the next)")
        if self.window_growth_commits < 0:
            raise ValueError(
                f"ProtectConfig.window_growth_commits="
                f"{self.window_growth_commits} — use 0 to regrow on clean "
                "scrubs only, or a positive count of clean commits")
        if self.full_scrub_every < 1:
            raise ValueError(
                f"ProtectConfig.full_scrub_every={self.full_scrub_every} "
                "— 1 makes every due scrub global; N > 1 runs the "
                "rank-local pre-check and goes global every Nth scrub")
        if self.block_words < 1:
            raise ValueError(
                f"ProtectConfig.block_words={self.block_words} — the "
                "page-column unit must be a positive word count "
                "(paper default: 1024 words = 4 KB pages)")
        if not 0.0 <= self.hybrid_threshold <= 1.0:
            raise ValueError(
                f"ProtectConfig.hybrid_threshold={self.hybrid_threshold} "
                "— the patch/bulk crossover is a dirty-page fraction and "
                "must lie in [0, 1]")
        if self.log_capacity < 1:
            raise ValueError(
                f"ProtectConfig.log_capacity={self.log_capacity} — the "
                "redo log needs at least one record slot")
        if self.stream_threshold_words < 0:
            raise ValueError(
                f"ProtectConfig.stream_threshold_words="
                f"{self.stream_threshold_words} — use 0 to disable "
                "streaming (flat kernels always)")
        if self.stream_chunk_words < 1:
            raise ValueError(
                f"ProtectConfig.stream_chunk_words="
                f"{self.stream_chunk_words} — the streamed chunk needs a "
                "positive word count")
        if self.straggler_threshold < 0:
            raise ValueError(
                f"ProtectConfig.straggler_threshold="
                f"{self.straggler_threshold} — a positive ratio, or 0 to "
                "disable straggler mitigation")
