"""glm4-9b [dense] — 40L d=4096 32H (GQA kv=2) d_ff=13696 vocab=151552,
RoPE.  kv=2 is the extreme-GQA case: the KV cache cannot shard its 2 heads
over a 16-way model axis, so the cache shards its sequence dimension
instead (`seq_shard` rule).  [hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv=2,
    d_ff=13696,
    vocab=151552,
    head_dim=128,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16,
        param_dtype="float32", compute_dtype="float32")
