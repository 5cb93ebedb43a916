"""Serving decode step: one new token against per-layer caches.

Port of ``repro.serve.decode``: ``make_serve_step`` on one device and
under the ``decode`` and ``long`` layouts on a live mesh (one process a
rank: tensor parallelism over ``model`` through d_model, the KV cache
over its sequence, a distributed softmax; see
``models.transformer``), ``cache_pspecs``, the caches' specs under a
layout (the KV cache over its sequence, recurrent states over batch),
planned exactly as the reference plans them, and ``cache_blocks``, a
rank's blocks of whole caches under them."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import NULL_LAYOUT, Layout, NamedSharding, PartitionSpec as P
from repro_torch.models.attention import kv_cache_quantized
from repro_torch.serve.prefill import as_device_tensor, serving_shard


def make_serve_step(cfg: ModelConfig, *, layout: Layout = NULL_LAYOUT, greedy: bool = True):
    """``serve_step(params, caches, tokens, pos)``: ``params`` the port's
    ``Transformer``, ``caches`` from its ``init_caches`` (one a layer: KV
    rings and recurrent states, updated in place), ``tokens`` (B, 1),
    ``pos`` the tokens' absolute position (a Python
    int, so no device scalar is read back).  Returns {"logits" (B, 1, V)
    float32, "next_tokens" (B, 1) int32 — the greedy argmax, first index
    on ties; with ``greedy=False`` the input tokens, the caller samples —
    "caches"}.

    With the ``decode`` or ``long`` layout on a live mesh, ``params`` is
    this rank's model (``models.zoo.init_params(cfg, gen, layout=layout)``
    or ``models.convert.shard_model``), ``caches`` its blocks (its
    ``init_caches``), ``tokens`` and the outputs its rows (``act_batch``:
    ``data`` in decode; every row in long), the logits equal on every
    ``model`` rank.  Raises on an ``AbstractMesh``, on another layout
    kind on a mesh.  w8a16 weights (``init_params(..., w8a16=True)``)
    run under a layout as on one device."""
    shard = serving_shard(layout, "make_serve_step", ("decode", "long"))

    def serve_step(params, caches: list, tokens, pos: int) -> dict:
        if params.cfg != cfg:
            raise ValueError(f"serve_step: the model's config is {params.cfg.name}, not {cfg.name}")
        if shard is not None:
            if params.shard != shard:
                raise ValueError("serve_step: the model does not hold this rank's blocks under "
                                 "this layout (models.zoo.init_params(..., layout=layout))")
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


def cache_blocks(cfg: ModelConfig, caches: list, layout: Layout) -> list:
    """This rank's blocks (``cache_pspecs``) of whole caches laid out as
    one device's ``init_caches``: a KV cache's sequence cut to the
    ceiling block and padded with empty slots (``pos`` -1, zeros), as a
    rank's ``init_caches`` makes them."""
    mesh = layout.mesh
    out = []
    for spec, cache in zip(cache_pspecs(cfg, layout), caches):
        block = {}
        for name, t in cache.items():
            sh = NamedSharding(mesh, spec[name])
            part, want = sh.shard(t), sh.shard_shape(tuple(t.shape))
            full = torch.full(want, -1 if name == "pos" else 0, dtype=t.dtype, device=t.device)
            full[tuple(slice(0, n) for n in part.shape)] = part
            block[name] = full
        out.append(block)
    return out
