"""Model / shape / run configuration schema: a copy of
``repro.configs.base`` (pure dataclasses), kept in the port so that it
imports nothing of the reference.

Every assigned architecture is expressed as a ``ModelConfig``; the four
benchmark shapes are ``ShapeConfig`` instances.  Configs are plain frozen
dataclasses — no framework magic — and each arch module in this package
exports ``CONFIG`` plus a reduced ``smoke_config()`` for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

LayerKind = Literal["attn", "moe", "rglru", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- block pattern -----------------------------------------------------
    # The repeating unit of layer kinds; layer i has kind
    # pattern_unit[i % len(pattern_unit)].  "attn" entries may carry a
    # sliding window via attn_windows (None = global attention).
    pattern_unit: tuple[str, ...] = ("attn",)
    attn_windows: tuple[int | None, ...] = (None,)  # parallel to pattern_unit
    # --- attention ----------------------------------------------------------
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    logit_softcap: float | None = None
    # --- mlp -----------------------------------------------------------------
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    # --- moe ------------------------------------------------------------------
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # expert hidden size (d_ff = dense-layer hidden size)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- recurrent (rglru / xlstm) ---------------------------------------------
    lru_width: int = 0  # RG-LRU hidden width (recurrentgemma)
    conv_width: int = 4  # temporal conv in recurrent blocks
    # --- frontends ---------------------------------------------------------------
    frontend: str | None = None  # None | "audio_stub" | "vision_stub"
    n_prefix_embeds: int = 0  # stub frontend prefix length (vlm patches)
    # --- misc -----------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # which shapes this arch can run (long_500k needs sub-quadratic attn)
    supports_long_context: bool = False

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        unit = self.pattern_unit
        return tuple(unit[i % len(unit)] for i in range(self.n_layers))

    @property
    def layer_windows(self) -> tuple[int | None, ...]:
        w = self.attn_windows
        return tuple(w[i % len(w)] for i in range(self.n_layers))

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.pattern_unit)

    @property
    def n_leftover(self) -> int:
        return self.n_layers % len(self.pattern_unit)

    def param_count(self) -> int:
        """Total parameters (embedding included once unless tied)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab_size
        qdim = self.n_heads * self.head_dim
        kvdim = self.n_kv_heads * self.head_dim
        total = 0
        for kind, _w in zip(self.layer_kinds, self.layer_windows):
            if kind == "attn":
                total += d * qdim + 2 * d * kvdim + qdim * d  # qkvo
                if self.qkv_bias:
                    total += qdim + 2 * kvdim
                total += 2 * d  # norms
                if dff:
                    total += 3 * d * dff
            elif kind == "moe":
                total += d * qdim + 2 * d * kvdim + qdim * d + 2 * d
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * self.moe_d_ff
                total += self.n_shared_experts * 3 * d * self.moe_d_ff
            elif kind == "rglru":
                w = self.lru_width or d
                # in/out proj (x2 branches), gates, conv
                total += 2 * d * w + w * d + 3 * w + self.conv_width * w + 2 * d
                if dff:
                    total += 3 * d * dff
            elif kind == "mlstm":
                # up-proj x2, qkv over 2d, out
                total += 2 * d * 2 * d + 3 * (2 * d) * (2 * d) // max(self.n_heads, 1) * 0
                total += 2 * d * 2 * d + 4 * (2 * d) + 2 * d * d + 2 * d
                total += 3 * (2 * d) * self.head_dim * self.n_heads // max(1, self.n_heads)
            elif kind == "slstm":
                total += 4 * d * d + 4 * d * d + 2 * d  # in + recurrent
                if dff:
                    total += 2 * d * int(4 * d * 4 / 3)
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE counts top_k + shared experts)."""
        if self.n_experts == 0:
            return self.param_count()
        dense_total = self.param_count()
        moe_layers = sum(1 for k in self.layer_kinds if k == "moe")
        all_experts = moe_layers * self.n_experts * 3 * self.d_model * self.moe_d_ff
        active = moe_layers * (self.moe_top_k + self.n_shared_experts) * 3 * self.d_model * self.moe_d_ff
        return dense_total - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(config: ModelConfig) -> tuple[ShapeConfig, ...]:
    """long_500k only for sub-quadratic archs (DESIGN.md §4)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if config.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)
