"""Model zoo: public entry points per architecture.

Port of ``repro.models.zoo``'s concrete half: ``init_params`` and
``make_concrete_batch``.  The reference's ``input_specs`` /
``abstract_params`` build ``jax.ShapeDtypeStruct`` stand-ins for its
multi-pod dry run (``eval_shape``); the port's dry run
(``launch.dryrun``) builds a rank's empty blocks on the meta device
instead (``models.convert.empty_rank_params``).  ``param_axes`` is ``models.convert.reference_axes`` of a
``Transformer(cfg, device="meta")``.  Stub frontends surface here as in the
reference: internvl2's patch embeddings arrive as a precomputed
``prefix_embeds`` input.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import NULL_LAYOUT, Layout
from repro_torch.models.convert import draw_rank_params
from repro_torch.models.layers import quantize_model
from repro_torch.models.transformer import StoredParams, Transformer


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None, *,
                layout: Layout = NULL_LAYOUT, w8a16: bool = False) -> Transformer | StoredParams:
    """A randomly initialised model from ``generator`` on ``device``
    (``None``: the card; on a mesh, the mesh's device), its linears
    quantised to w8a16 (``layers.quantize_model``) when ``w8a16``.  With
    a serving layout on a live mesh, this rank's parameters of that same
    model (``models.convert.draw_rank_params``: a ``Transformer`` of
    compute blocks under ``decode`` / ``long``, ``StoredParams`` under
    ``prefill``), drawn a leaf at a time, each linear quantised whole
    before it is cut."""
    if layout.mesh is not None and layout.kind is not None:
        return draw_rank_params(cfg, generator, layout, device, w8a16=w8a16)
    model = Transformer(cfg, generator=generator, device=device)
    return quantize_model(model) if w8a16 else model


def _bf16(x: np.ndarray) -> np.ndarray:
    """Values rounded to bfloat16 (through float32, as the reference's
    ``jnp.asarray(..., bfloat16)`` rounds them), held as float32: numpy
    has no bfloat16."""
    return torch.from_numpy(np.asarray(x, np.float64)).to(torch.bfloat16).float().numpy()


def make_concrete_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0) -> dict:
    """Small concrete batch for smoke tests, as numpy arrays: the
    reference's values for the same seed (its leaves are drawn in sorted
    key order: ``prefix_embeds``, ``targets``, ``tokens``).  The bf16
    ``prefix_embeds`` come as float32 holding bf16 values.  Train and
    prefill shapes; a decode batch's caches come from
    ``Transformer.init_caches``."""
    if shape.kind not in ("train", "prefill"):
        raise ValueError(f"make_concrete_batch: shape kind {shape.kind!r} (train or prefill)")
    rng = np.random.default_rng(seed)
    b, t = shape.global_batch, shape.seq_len
    shapes = {"tokens": (b, t)}
    if shape.kind == "train":
        shapes["targets"] = (b, t)
    if cfg.frontend == "vision_stub":
        p = cfg.n_prefix_embeds
        shapes = {k: (b, t - p) for k in shapes}
        shapes["prefix_embeds"] = (b, p, cfg.d_model)
    out = {}
    for key in sorted(shapes):
        if key == "prefix_embeds":
            out[key] = _bf16(rng.normal(size=shapes[key]) * 0.02)
        else:
            out[key] = rng.integers(0, cfg.vocab_size, size=shapes[key]).astype(np.int32)
    return out
