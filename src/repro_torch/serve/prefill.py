"""Prefill step: full-sequence forward that emits last-token logits + KV.

Port of ``repro.serve.prefill``.  On one device the step runs the
``Transformer``; under the ``prefill`` layout on a live mesh (one
process a rank) it runs the rank's ``StoredParams``: the batch's rows
over ``data``, the sequence over ``model``, the parameters stored
ZeRO-sharded and gathered a layer at a time
(``models.transformer.StoredParams``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NULL_LAYOUT, Layout, Shard, shard_of
from repro_torch.models.transformer import StoredParams


def as_device_tensor(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def serving_shard(layout: Layout, what: str, kinds: tuple) -> Shard | None:
    """None for a layout without a mesh (one device); else the ``Shard``
    the step executes.  Raises on an ``AbstractMesh`` (it plans, it joins
    no world) and on a layout kind the step does not run."""
    if layout.mesh is None or layout.kind is None:
        return None
    if layout.kind not in kinds:
        raise NotImplementedError(f"{what}: the {layout.kind!r} layout is not executed by this "
                                  f"step; it executes {kinds}")
    return shard_of(layout, what)


def make_prefill_step(cfg: ModelConfig, *, layout: Layout = NULL_LAYOUT):
    """``prefill_step(params, batch)``: ``batch`` {"tokens" (B, T)[,
    "prefix_embeds" (B, P, D)]} as numpy arrays or tensors.  On one device
    ``params`` is the port's ``Transformer`` for ``cfg``; returns {"logits"
    (B, 1, V) float32, "caches": one (k, v) an attention layer (kinds
    ``attn`` and ``moe``) in layer order; the recurrent kinds' layers give
    none} on the model's device.

    With the ``prefill`` layout on a live mesh, ``params`` is this rank's
    ``StoredParams`` (``models.zoo.init_params(cfg, gen, layout=layout)``)
    and every rank is given the whole batch: the logits are its rows'
    (B / data, 1, V), equal on every ``model`` rank, and each (k, v) its
    (rows, sequence) block.  Raises on an ``AbstractMesh`` and on another
    layout kind on a mesh."""
    shard = serving_shard(layout, "make_prefill_step", ("prefill",))

    def prefill_step(params, batch: dict) -> dict:
        if params.cfg != cfg:
            raise ValueError(f"prefill_step: the model's config is {params.cfg.name}, not {cfg.name}")
        if shard is not None:
            if not isinstance(params, StoredParams):
                raise ValueError("prefill_step: under the prefill layout, params is the rank's "
                                 "StoredParams (models.zoo.init_params(..., layout=layout))")
            if params.shard != shard:
                raise ValueError("prefill_step: the params were made for another layout or mesh")
        dev = params.device
        prefix = batch.get("prefix_embeds")
        logits, caches = params.forward_prefill(
            as_device_tensor(batch["tokens"], dev),
            None if prefix is None else as_device_tensor(prefix, dev))
        return {"logits": logits, "caches": caches}

    return prefill_step
