"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648.

vocab=152064, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].
Full attention -> no long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152_064,
    act="silu",
    qkv_bias=True,
    supports_long_context=False,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=512,
    )
