"""xlstm-350m [ssm] — 24L d_model=1024 4H d_ff=0 vocab=50304.

Alternating mLSTM / sLSTM blocks [arXiv:2405.04517; unverified]: the
blocks carry their own up/down projections (projection factor 2 for
mLSTM, ferroelectric 4/3 FFN after sLSTM), hence d_ff=0 at the top level.
Recurrent state -> long_500k runnable.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50_304,
    pattern_unit=("mlstm", "slstm"),
    attn_windows=(None, None),
    supports_long_context=True,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        vocab_size=512,
    )
