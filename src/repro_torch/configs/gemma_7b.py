"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.

GeGLU activation, head_dim=256 (q-dim 4096 != d_model) [arXiv:2403.08295; hf].
Full attention -> no long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    act="gelu",
    tie_embeddings=True,  # gemma ties the unembedding
    supports_long_context=False,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=192, vocab_size=512,
    )
