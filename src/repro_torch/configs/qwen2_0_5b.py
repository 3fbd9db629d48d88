"""qwen2-0.5b [dense] — 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151936,
QKV bias, tied embeddings.  [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=56, n_heads=14, n_kv=2, d_ff=128,
        vocab=512, head_dim=4,
        param_dtype="float32", compute_dtype="float32")
