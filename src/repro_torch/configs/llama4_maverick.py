"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8).

MoE: 128 routed experts top-1 + 1 shared expert, expert d_ff=8192,
vocab=202048 [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Assumption log (DESIGN.md §4): MoE on every *second* layer
(interleave step 2, as in the released Maverick config) with dense-layer
d_ff=16384; this reproduces ~400B total / ~17B active parameters implied
by the model name.  Early-fusion multimodality is out of scope for the
text backbone (the brief assigns the LM backbone only).
Full attention -> no long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,  # dense layers
    vocab_size=202_048,
    act="silu",
    pattern_unit=("attn", "moe"),
    attn_windows=(None, None),
    n_experts=128,
    moe_top_k=1,
    moe_d_ff=8192,
    n_shared_experts=1,
    supports_long_context=False,
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, n_experts=8, moe_d_ff=64,
    )
