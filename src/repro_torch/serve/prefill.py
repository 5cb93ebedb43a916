"""Prefill step: full-sequence forward that emits last-token logits + KV.

Port of ``repro.serve.prefill`` for one device.  A layout on a mesh is
planned (``distributed.sharding``) but not executed: the step raises on
one."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NULL_LAYOUT, Layout


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def require_one_device(layout: Layout, what: str) -> None:
    """Raise unless ``layout`` has no mesh: serving executes on one device;
    the ``prefill`` / ``decode`` / ``long`` layouts are plans only (tensor
    parallel decode, the sequence-sharded cache and expert parallelism
    are not executed)."""
    if layout.mesh is not None and layout.kind is not None:
        raise NotImplementedError(
            f"{what}: the {layout.kind!r} layout on a mesh is planned (param_pspec, "
            "cache_pspecs) but not executed in the port; pass NULL_LAYOUT")


def make_prefill_step(cfg: ModelConfig, *, layout: Layout = NULL_LAYOUT):
    """``prefill_step(params, batch)``: ``params`` the port's
    ``Transformer`` for ``cfg``, ``batch`` {"tokens" (B, T)[,
    "prefix_embeds" (B, P, D)]} as numpy arrays or tensors.  Returns
    {"logits" (B, 1, V) float32, "caches": one (k, v) an attention layer
    (kinds ``attn`` and ``moe``) in layer order; the recurrent kinds'
    layers give none} on the model's device.  Raises on a layout with a
    mesh (``require_one_device``)."""
    require_one_device(layout, "make_prefill_step")

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
