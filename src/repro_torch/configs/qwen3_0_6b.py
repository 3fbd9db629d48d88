"""qwen3-0.6b [dense] — 28L d=1024 16H (GQA kv=8) d_ff=3072 vocab=151936,
qk-norm (per-head RMS norm on q/k), head_dim=128, tied embeddings.
[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16,
        param_dtype="float32", compute_dtype="float32")
