"""recurrentgemma-2b [hybrid] — Griffin: 26 blocks in a 2:1
RG-LRU : local-attention pattern, d=2560, 10H (MQA kv=1, head_dim=256),
d_ff=7680, vocab=256000, attention window 2048.  O(1) recurrent state +
windowed KV make the 524k decode cell runnable.  [arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "attn"),
    window=2048,
    tie_embeddings=True,   # Griffin/RG releases share input/output embeddings
    subquadratic=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv=1, d_ff=128,
        vocab=512, head_dim=16, window=16,
        param_dtype="float32", compute_dtype="float32")
