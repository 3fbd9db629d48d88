"""Config system (the reference's configs/base.py): `ModelConfig` holds a
model's architecture numbers, `TrainConfig` the optimizer and step
settings (copied field for field, `remat`, `z_loss` and
`grad_compression` included, though the reference reads none of them),
`ProtectConfig` the single protection knob, validated as the reference
validates it.  `WORKLOADS` are the dry run's input-shape cells and
`workload_skips` names the cells an architecture cannot run.

Every architecture has a `repro_torch/configs/<id>.py` exporting `CONFIG`
(the published configuration) and `reduced()` (a small same-family variant
for CPU tests); `repro_torch.configs.registry` resolves `--arch <id>`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

_PROTECT_MODES = ("none", "ml", "mlp", "mlpc", "replica", "mlp2", "mlpc2")
MAX_REDUNDANCY = 4


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_expert: int                 # expert FFN hidden size
    interleave: int = 1           # 1 = every layer MoE; 2 = alternate dense/MoE
    shared_expert: bool = False   # llama4-style always-on shared expert
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | encdec | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # default d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    act: str = "silu"                      # GLU activation
    moe: Optional[MoESpec] = None
    # layer pattern for hybrid/ssm families; None = homogeneous decoder
    block_pattern: Optional[Tuple[str, ...]] = None   # e.g. ("rglru","rglru","attn")
    window: Optional[int] = None           # sliding-window attention size
    enc_layers: int = 0                    # >0 => encoder-decoder
    mm_positions: int = 0                  # frontend stub embedding positions
    subquadratic: bool = False             # True => long_500k runnable
    # numerics
    param_dtype: str = "float32"           # master/param dtype
    compute_dtype: str = "bfloat16"
    moment_dtype: Optional[str] = None     # Adam m/v dtype; None = param_dtype
    logical_overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern is not None:
            return self.block_pattern
        if self.moe is not None and self.moe.interleave == 2:
            return ("dense", "moe")
        if self.moe is not None:
            return ("moe",)
        return ("dense",)

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (of the families the port builds)."""
        from repro_torch.models import api
        return api.count_params(self)

    def active_param_count(self) -> int:
        """The parameters a token runs through: an expert stack counted
        at top_k of num_experts."""
        from repro_torch.models import api
        return api.count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class Workload:
    """One input-shape cell of the dry run."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


WORKLOADS = {
    "train_4k": Workload("train_4k", "train", 4096, 256),
    "prefill_32k": Workload("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Workload("decode_32k", "decode", 32768, 128),
    "long_500k": Workload("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1             # gradient accumulation
    remat: bool = True
    optimizer: str = "adamw"          # adamw | adafactor
    z_loss: float = 1e-4
    grad_compression: bool = False    # int8 all-reduce with error feedback


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


def workload_skips(cfg: ModelConfig, wl: Workload) -> Optional[str]:
    """Reason string if this (arch, workload) cell is skipped, else None."""
    if wl.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention architecture: 524k-token decode requires "
                "sub-quadratic attention (see DESIGN.md §4)")
    return None
