"""deepseek-coder-33b [dense] — 62L d_model=7168 56H (GQA kv=8) d_ff=19200.

vocab=32256, llama-style SwiGLU [arXiv:2401.14196; hf].
Full attention -> no long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32_256,
    act="silu",
    supports_long_context=False,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=512,
    )
