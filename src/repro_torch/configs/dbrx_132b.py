"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) vocab=100352.

Fine-grained MoE on every layer: 16 experts, top-4, expert d_ff=10752
[hf:databricks/dbrx-base; unverified].  Full attention -> no long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,  # every FFN is MoE
    vocab_size=100_352,
    act="silu",
    pattern_unit=("moe",),
    attn_windows=(None,),
    n_experts=16,
    moe_top_k=4,
    moe_d_ff=10752,
    supports_long_context=False,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        vocab_size=512, n_experts=4, moe_top_k=2, moe_d_ff=64,
    )
