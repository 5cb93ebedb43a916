"""internvl2-2b [vlm] — InternLM2-1.8B backbone: 24L d_model=2048 16H (kv=8).

d_ff=8192 vocab=92553 [arXiv:2404.16821; hf].  The InternViT vision tower
is a stub per the brief: ``input_specs()`` supplies precomputed patch
embeddings (n_prefix_embeds x d_model) that are prepended to the token
embeddings.  Full attention -> no long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_553,
    act="silu",
    frontend="vision_stub",
    n_prefix_embeds=256,  # one 448x448 tile -> 256 visual tokens
    supports_long_context=False,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, n_prefix_embeds=8,
    )
