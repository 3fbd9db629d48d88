"""minitron-8b [dense] — width/depth-pruned Nemotron: 32L d=4096 32H
(GQA kv=8) d_ff=16384 vocab=256000.  [arXiv:2407.14679; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=16384,
    vocab=256000,
    head_dim=128,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16,
        param_dtype="float32", compute_dtype="float32")
