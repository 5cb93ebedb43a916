"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention (window 1024), 128k context
[hf:google/gemma-3-1b-pt; unverified].  The 5:1 hybrid makes long_500k
runnable: per decoded token the global layers cost O(T) and the local
layers O(window).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    act="gelu",
    pattern_unit=("attn",) * 6,  # 5 local + 1 global
    attn_windows=(1024, 1024, 1024, 1024, 1024, None),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    supports_long_context=True,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=7, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, attn_windows=(16, 16, 16, 16, 16, None),
    )
