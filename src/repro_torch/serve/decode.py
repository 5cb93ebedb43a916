"""Serving decode step: one new token against per-layer caches.

Port of ``repro.serve.decode.make_serve_step`` for one device.  The
reference's ``cache_pspecs`` (the caches' sharding over the ``model``
axis) waits for the port's sharding layouts."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.prefill import as_device_tensor


def make_serve_step(cfg: ModelConfig, *, greedy: bool = True):
    """``serve_step(params, caches, tokens, pos)``: ``params`` the port's
    ``Transformer``, ``caches`` from its ``init_caches`` (one a layer: KV
    rings and recurrent states, updated in place), ``tokens`` (B, 1),
    ``pos`` the tokens' absolute position (a Python
    int, so no device scalar is read back).  Returns {"logits" (B, 1, V)
    float32, "next_tokens" (B, 1) int32 — the greedy argmax, first index
    on ties; with ``greedy=False`` the input tokens, the caller samples —
    "caches"}."""

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
