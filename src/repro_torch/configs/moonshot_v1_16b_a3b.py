"""moonshot-v1-16b-a3b [moe] — 48L d=2048 16H (kv=16, i.e. MHA) d_ff=1408
per expert, vocab=163840, MoE 64 experts top-6 + shared expert
(kimi/moonlight family).  [hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1408,
    vocab=163840,
    head_dim=128,
    rope_theta=50000.0,
    moe=MoESpec(num_experts=64, top_k=6, d_expert=1408, interleave=1,
                shared_expert=True, capacity_factor=1.25),
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv=4, d_ff=96,
        vocab=512, head_dim=16,
        moe=MoESpec(num_experts=8, top_k=2, d_expert=96, interleave=1,
                    shared_expert=True, capacity_factor=2.0),
        param_dtype="float32", compute_dtype="float32")
