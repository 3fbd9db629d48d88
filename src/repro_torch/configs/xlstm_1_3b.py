"""xlstm-1.3b [ssm] — 48 blocks, d=2048, 4 heads, vocab=50304, d_ff=0
(projections live inside the blocks): xLSTM[7:1] — 7 mLSTM (matrix
memory, chunkwise-parallel training, O(1) decode) per 1 sLSTM (scalar
memory with true state-mixing recurrence).  [arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    subquadratic=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=4, vocab=512,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        param_dtype="float32", compute_dtype="float32")
