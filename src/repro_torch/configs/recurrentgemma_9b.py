"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288.

vocab=256000, Griffin pattern: 2 RG-LRU blocks : 1 local-attention block
(window 2048), lru_width=4096 [arXiv:2402.19427; unverified].
Recurrent + local attention -> long_500k runnable.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    act="gelu",
    pattern_unit=("rglru", "rglru", "attn"),
    attn_windows=(None, None, 2048),
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
    supports_long_context=True,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, lru_width=64,
        attn_windows=(None, None, 16),
    )
