"""Serving decode step: one new token against per-layer caches.

Port of ``repro.serve.decode``: ``make_serve_step`` for one device (a
layout on a mesh raises), and ``cache_pspecs``, the caches' specs under
a layout (the KV cache over its sequence on ``model``, recurrent states
over batch), planned exactly as the reference plans them."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NULL_LAYOUT, Layout, PartitionSpec as P
from repro_torch.models.attention import kv_cache_quantized
from repro_torch.serve.prefill import as_device_tensor, require_one_device


def make_serve_step(cfg: ModelConfig, *, layout: Layout = NULL_LAYOUT, greedy: bool = True):
    """``serve_step(params, caches, tokens, pos)``: ``params`` the port's
    ``Transformer``, ``caches`` from its ``init_caches`` (one a layer: KV
    rings and recurrent states, updated in place), ``tokens`` (B, 1),
    ``pos`` the tokens' absolute position (a Python
    int, so no device scalar is read back).  Returns {"logits" (B, 1, V)
    float32, "next_tokens" (B, 1) int32 — the greedy argmax, first index
    on ties; with ``greedy=False`` the input tokens, the caller samples —
    "caches"}.  Raises on a layout with a mesh."""
    require_one_device(layout, "make_serve_step")

    def serve_step(params, caches: list, tokens, pos: int) -> dict:
        if params.cfg != cfg:
            raise ValueError(f"serve_step: the model's config is {params.cfg.name}, not {cfg.name}")
        tokens = as_device_tensor(tokens, params.device)
        logits, caches = params.forward_decode(tokens, caches, int(pos))
        if greedy:
            next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        else:
            next_tok = tokens
        return {"logits": logits, "next_tokens": next_tok, "caches": caches}

    return serve_step


def _axes_of(layout: Layout, *names) -> P:
    return P(*[layout.act_axes(n) for n in names])


def cache_pspecs(cfg: ModelConfig, layout: Layout) -> list:
    """Specs matching ``Transformer.init_caches``' structure, one dict a
    layer (``REPRO_KV_INT8=1``: the int8 cache's codes and scales)."""
    specs = []
    for kind in cfg.layer_kinds:
        if kind in ("attn", "moe"):
            kv = _axes_of(layout, "act_batch", "cache_seq", "kv_heads", "head_dim")
            pos = P(layout.act_axes("cache_seq"))
            if kv_cache_quantized():
                s = _axes_of(layout, "act_batch", "cache_seq", "kv_heads")
                specs.append({"k_q": kv, "k_s": s, "v_q": kv, "v_s": s, "pos": pos})
            else:
                specs.append({"k": kv, "v": kv, "pos": pos})
        elif kind == "rglru":
            specs.append({"h": _axes_of(layout, "act_batch", "act_lru"),
                          "conv": _axes_of(layout, "act_batch", "conv", "act_lru")})
        elif kind == "mlstm":
            specs.append({"c": _axes_of(layout, "act_batch", "heads", "head_dim", "inner"),
                          "n": _axes_of(layout, "act_batch", "heads", "head_dim"),
                          "m": _axes_of(layout, "act_batch", "heads"),
                          "conv": _axes_of(layout, "act_batch", "conv", "inner")})
        elif kind == "slstm":
            z = _axes_of(layout, "act_batch", "heads", "head_dim")
            specs.append({"c": z, "n": z, "h": z, "m": z})
    return specs
