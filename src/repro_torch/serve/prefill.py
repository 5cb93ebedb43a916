"""Prefill step: full-sequence forward that emits last-token logits + KV.

Port of ``repro.serve.prefill`` for one device (no sharding layout)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch)``: ``params`` the port's
    ``Transformer`` for ``cfg``, ``batch`` {"tokens" (B, T)[,
    "prefix_embeds" (B, P, D)]} as numpy arrays or tensors.  Returns
    {"logits" (B, 1, V) float32, "caches": one (k, v) an attention layer
    (kinds ``attn`` and ``moe``) in layer order; the recurrent kinds'
    layers give none} on the model's device."""

    def prefill_step(params, batch: dict) -> dict:
        if params.cfg != cfg:
            raise ValueError(f"prefill_step: the model's config is {params.cfg.name}, not {cfg.name}")
        dev = params.device
        prefix = batch.get("prefix_embeds")
        logits, caches = params.forward_prefill(
            as_device_tensor(batch["tokens"], dev),
            None if prefix is None else as_device_tensor(prefix, dev))
        return {"logits": logits, "caches": caches}

    return prefill_step
