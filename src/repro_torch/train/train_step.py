"""Training step on one device: loss by autograd, global-norm clip,
warmup-cosine schedule, pluggable optimizer (AdamW / Adafactor / 8-bit).

Port of ``repro.train.train_step`` for the reference's ``NULL_LAYOUT``
(one device).  The masters are float32; a bf16 model's layers run on
them rounded to bf16 inside each rematerialised unit
(``Transformer.forward_train``).  The optimizer sees the reference's
leaves: ``models.convert.reference_leaves`` stacks each unit leaf in
place (the layers' parameters become views of it), and each parameter's
``.grad`` is a view of a stacked gradient buffer of the same layout, so
the backward accumulates straight into the reference's gradient leaves.

The reference's ``grad_specs`` (gradients constrained to their ZeRO
shard before the clip), ``REPRO_GRAD_SHARD`` and
``make_train_state_specs`` place state over a mesh; they wait for the
port's sharding layouts.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import zoo
from repro_torch.models.convert import leaf_params, reference_leaves
from repro_torch.models.transformer import Transformer, lm_loss
from repro_torch.optim import OptConfig, clip_by_global_norm, opt_init, opt_update, warmup_cosine
from repro_torch.serve.prefill import as_device_tensor


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 2000
    total_steps: int = 100_000
    opt: OptConfig = OptConfig()


class TrainState(NamedTuple):
    """``params`` the model (float32 masters, laid out by
    ``reference_leaves``), ``opt`` the optimizer's state over those
    leaves, ``step`` an int32 scalar tensor."""
    params: Transformer
    opt: object
    step: torch.Tensor


def grad_leaves(model: Transformer) -> dict[str, torch.Tensor]:
    """A float32 gradient buffer a reference leaf (``reference_leaves``'
    paths and shapes), made on the first call; every call returns the same
    buffers and points each parameter's ``.grad`` at a view of its leaf's
    buffer again (``model.zero_grad()`` sets them to None), so the next
    backward accumulates into the buffers.  Raises if a parameter is no
    longer a view of its stacked leaf (the model was moved by ``.to``)."""
    leaves = reference_leaves(model)
    grads = model.__dict__.get("_grad_leaves")
    if grads is None:
        grads = {path: torch.zeros_like(leaf) for path, leaf in leaves.items()}
        model.__dict__["_grad_leaves"] = grads
    for path, ps in leaf_params(model).items():
        for u, p in enumerate(ps):
            unit = path.startswith("units/")
            if p.data_ptr() != (leaves[path][u] if unit else leaves[path]).data_ptr():
                raise ValueError(f"grad_leaves: {path} is no longer the model's stacked leaf; "
                                 "a model is moved before its first train step, not after")
            p.grad = grads[path][u] if unit else grads[path]
    return grads


def state_tree(state: TrainState) -> TrainState:
    """``state`` laid out as the reference's ``TrainState`` tree, as the
    checkpointer saves it: the params the model's ``reference_leaves``
    (the same tensors, units stacked), ``opt`` and ``step`` as they are."""
    return state._replace(params=reference_leaves(state.params))


def load_state_tree(state: TrainState, tree: TrainState) -> TrainState:
    """``state`` holding ``tree``'s values (a ``state_tree`` as the
    checkpointer restores it): the params copied into the model's leaves
    in place, ``opt`` and ``step`` taken from ``tree``."""
    leaves = reference_leaves(state.params)
    with torch.no_grad():
        for path, leaf in tree.params.items():
            leaves[path].copy_(leaf)
    return TrainState(params=state.params, opt=tree.opt, step=tree.step)


def make_train_state(cfg: ModelConfig, hp: TrainHParams, generator: torch.Generator,
                     device=None) -> TrainState:
    """A randomly initialised model from ``generator`` on ``device``
    (``None``: the card), trainable, its masters laid out as the
    reference's leaves, with the optimizer's initial state and step 0."""
    model = zoo.init_params(cfg, generator, device=device).requires_grad_(True)
    params = reference_leaves(model)
    return TrainState(params=model, opt=opt_init(params, hp.opt),
                      step=torch.zeros((), dtype=torch.int32, device=model.device))


def make_train_step(cfg: ModelConfig, hp: TrainHParams):
    """``train_step(state, batch) -> (state, metrics)``: ``batch`` holds
    ``tokens`` and ``targets`` (B, T) (and ``prefix_embeds`` for the
    vision stub) as numpy arrays or tensors.  The loss and its gradients
    by autograd (each pattern unit rematerialised), the gradients clipped
    to ``hp.opt.clip_norm`` by global norm, the learning rate from
    ``warmup_cosine`` at the state's step, then the optimizer's update in
    place.  Metrics ``loss``,
    ``grad_norm`` and ``lr`` are float32 scalars left on the device."""

    def train_step(state: TrainState, batch: dict):
        model = state.params
        if model.cfg != cfg:
            raise ValueError(f"train_step: the model's config is {model.cfg.name}, not {cfg.name}")
        params, grads = reference_leaves(model), grad_leaves(model)
        for g in grads.values():
            g.zero_()
        batch = {k: as_device_tensor(v, model.device) for k, v in batch.items()}
        loss = lm_loss(model, batch)
        loss.backward()
        grads, gnorm = clip_by_global_norm(grads, hp.opt.clip_norm)
        lr = warmup_cosine(state.step, peak_lr=hp.peak_lr, warmup=hp.warmup,
                           total=hp.total_steps)
        opt = opt_update(grads, state.opt, params, lr, hp.opt)
        return (TrainState(params=model, opt=opt, step=state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr})

    return train_step
