"""chameleon-34b [vlm] — early-fusion: 48L d=8192 64H (GQA kv=8)
d_ff=22016 vocab=65536 (text + VQ image codes share the vocabulary);
qk-norm for stability as in the release.  The VQ tokenizer is a stub:
`input_specs` provides precomputed patch-embedding positions in addition
to the discrete token stream.  [arXiv:2405.09818; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=22016,
    vocab=65536,
    head_dim=128,
    qk_norm=True,
    mm_positions=256,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16, mm_positions=4,
        param_dtype="float32", compute_dtype="float32")
