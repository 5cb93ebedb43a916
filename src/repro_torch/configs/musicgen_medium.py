"""musicgen-medium [audio] — decoder-only LM over EnCodec tokens.

48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf].  The EnCodec frontend is a stub per the brief:
``input_specs()`` supplies token ids (the EnCodec codes themselves) — the
transformer backbone is what we model.  Full attention -> no long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    frontend="audio_stub",
    supports_long_context=False,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
    )
