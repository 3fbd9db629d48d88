"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) vocab=202048,
MoE 128 experts top-1, alternating dense/MoE layers + shared expert (the
interleave that lands at ~400B total / ~17B active), early-fusion
multimodal stub.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Numerics: bf16 params + bf16 Adam moments — at 400B parameters a full-f32
optimizer (16 B/param = 6.4 TB) exceeds a 256-chip v5e pod's 4 TB HBM;
bf16 policy (8 B/param = 3.2 TB) fits with room for activations.  The
replica protection mode is *infeasible* at this scale (2x state), which is
exactly the paper's storage argument; parity mode costs 1/G.
"""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    rope_theta=500000.0,
    moe=MoESpec(num_experts=128, top_k=1, d_expert=8192, interleave=2,
                shared_expert=True, capacity_factor=1.25),
    mm_positions=256,            # early-fusion image-patch stub positions
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    moment_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16, mm_positions=4,
        moe=MoESpec(num_experts=4, top_k=1, d_expert=128, interleave=2,
                    shared_expert=True, capacity_factor=2.0),
        param_dtype="float32", compute_dtype="float32",
        moment_dtype=None)
