"""seamless-m4t-large-v2 [audio] — encoder-decoder backbone: 24L encoder +
24L decoder, d=1024, 16H MHA, d_ff=8192, vocab=256206.  The speech frontend
(fbank conformer adaptor) is a stub per the assignment: `input_specs`
provides precomputed frame embeddings (B, S, d).  [arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,              # decoder layers
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=128, vocab=512, head_dim=16,
        param_dtype="float32", compute_dtype="float32")
