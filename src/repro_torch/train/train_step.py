"""Training step: loss by autograd, global-norm clip, warmup-cosine
schedule, pluggable optimizer (AdamW / Adafactor / 8-bit), on one device
or ZeRO-sharded over a mesh of processes.

Port of ``repro.train.train_step``.  The masters are float32; a bf16
model's layers run on them rounded to bf16 inside each rematerialised
unit (``Transformer.forward_train``).  The optimizer sees the
reference's leaves: ``models.convert.reference_leaves`` stacks each unit
leaf in place (the layers' parameters become views of it), and each
parameter's ``.grad`` is a view of a stacked gradient buffer of the same
layout, so the backward accumulates straight into the reference's
gradient leaves.

**On a mesh** (``layout = make_layout("train", mesh)`` with ``mesh`` a
live ``launch.mesh.Mesh``, one process a rank), the step is ZeRO data
parallelism, executed by this module where the reference leaves it to
XLA's partitioner:

* each rank stores only its block of every float32 master and optimizer
  leaf, by ``make_train_state_specs`` (the train layout shards each leaf
  over both free axes); ``make_train_state(..., layout=)`` builds that
  state from the same initial weights as one device;
* every step gathers the compute parameters whole (one ``all_gather`` of
  the concatenated blocks).  The plan puts expert weights on ``model``
  for expert parallelism; the step gathers them whole too and runs every
  expert on every rank;
* the batch's rows go over the layout's ``act_batch`` axes (``data``, or
  ``data`` x ``model`` under ``dp_only``).  ``act_seq`` places the loss
  positions: each rank runs the forward over the *whole* sequence of its
  rows and takes the loss terms of its own ``T / model`` positions only,
  back-propagating those.  The sum over ranks is the full gradient,
  exact for every layer kind, recurrent ones included.  It costs
  ``model``-fold redundant forward and backward work through the layer
  stack (only the loss head is split); true sequence-parallel compute
  (K/V gathered over ``model``, channel-sharded RG-LRU, expert
  parallelism) is not done;
* the loss is the reference's global one: ``n_valid`` is all-reduced,
  and the MoE's Switch aux loss, a product of two batch means, takes the
  whole batch's routed shares (``MoE.batch_mean``) while each rank's aux
  and z-loss terms are averaged over the ranks;
* gradients: with ``REPRO_GRAD_SHARD=1`` (the default) and
  ``grad_specs`` (the params' storage specs), one ``reduce_scatter`` of
  the concatenated blocks leaves each rank the sum of its own blocks
  (gloo and nccl both run their own reduce-scatter; gloo stages CUDA
  tensors through the host), the norm is a sum of partial squares and
  one scalar ``all_reduce`` (a replicated block counted once);
  with ``REPRO_GRAD_SHARD=0`` or no ``grad_specs``, the whole gradient
  is all-reduced, clipped, then sliced to the blocks.  8-bit AdamW's
  moments are replicated (the reference's specs), so it always takes
  whole gradients.  Then the clip, ``warmup_cosine`` and the update on
  the blocks.

Gathering the whole compute tree once a step is a memory cost the
reference avoids (it gathers a scanned layer at a time).  Only the
``train`` layout executes on a mesh; any other layout raises.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    NULL_LAYOUT,
    Layout,
    NamedSharding,
    PartitionSpec as P,
    act_pspec,
    map_axes,
    map_specs,
    named_shardings,
    store_pspec,
    tree_pspecs,
)
from repro_torch.models import zoo
from repro_torch.models.convert import leaf_params, reference_axes, reference_leaves
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import Transformer, chunked_xent, lm_loss
from repro_torch.optim import OptConfig, clip_by_global_norm, opt_init, opt_update, warmup_cosine
from repro_torch.optim.adamw import Adam8State, AdafactorState, AdamWState, Sharded
from repro_torch.serve.prefill import as_device_tensor


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 2000
    total_steps: int = 100_000
    opt: OptConfig = OptConfig()


class TrainState(NamedTuple):
    """``params`` the model (float32 masters, laid out by
    ``reference_leaves``) on one device; on a mesh, this rank's blocks of
    the masters by leaf path.  ``opt`` the optimizer's state over those
    leaves, ``step`` an int32 scalar tensor."""
    params: Transformer | dict
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
    (the same tensors, units stacked), ``opt`` and ``step`` as they are.
    A sharded state is such a tree already."""
    if isinstance(state.params, dict):
        return state
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


def _on_mesh(layout: Layout) -> bool:
    return layout.mesh is not None and layout.kind is not None


def _live_mesh(layout: Layout):
    """The layout's mesh, checked to be one the step can execute on."""
    if layout.kind != "train":
        raise NotImplementedError(f"the {layout.kind!r} layout is planned but not executed on a "
                                  "mesh; the train step executes the 'train' layout")
    if not hasattr(layout.mesh, "rank"):
        raise ValueError(f"{type(layout.mesh).__name__} joins no world: it plans, it cannot "
                         "execute; pass a launch.mesh.Mesh")
    return layout.mesh


def make_train_state(cfg: ModelConfig, hp: TrainHParams, generator: torch.Generator,
                     device=None, *, layout: Layout = NULL_LAYOUT) -> TrainState:
    """A randomly initialised model from ``generator`` on ``device``
    (``None``: the card; on a mesh, the mesh's device), trainable, its
    masters laid out as the reference's leaves, with the optimizer's
    initial state and step 0.  With a ``train`` layout on a live mesh,
    this rank's blocks of that same state (``make_train_state_specs``):
    every rank draws the whole model from the generator and keeps its
    blocks."""
    on_mesh = _on_mesh(layout)
    if on_mesh:
        mesh = _live_mesh(layout)
        device = mesh.device if device is None else device
    model = zoo.init_params(cfg, generator, device=device).requires_grad_(True)
    params = reference_leaves(model)
    state = TrainState(params=model, opt=opt_init(params, hp.opt),
                       step=torch.zeros((), dtype=torch.int32, device=model.device))
    if not on_mesh:
        return state
    specs = make_train_state_specs(params, reference_axes(model), layout, hp.opt.name)
    with torch.no_grad():
        return map_specs(lambda spec, t: NamedSharding(mesh, spec).shard(t).clone(
                             memory_format=torch.contiguous_format),
                         specs, state_tree(state))


def make_train_state_specs(params: dict, axes: dict, layout: Layout, opt_name: str) -> TrainState:
    """Specs matching ``TrainState(params, opt, step)`` for ``params``
    (leaf path -> tensor or anything with a ``shape``, e.g. on the meta
    device) with logical ``axes`` (``models.convert.reference_axes``):
    the params' storage specs; AdamW's moments as the params; Adafactor's
    row and column statistics from their dropped-dimension shapes;
    8-bit AdamW's states replicated."""
    p_specs = tree_pspecs(axes, params, layout, stored=True)
    if opt_name == "adamw":
        opt_specs = AdamWState(step=P(), m=p_specs, v=p_specs)
    elif opt_name == "adafactor":
        def vr_spec(ax, leaf):
            shape = tuple(leaf.shape)
            if len(shape) >= 2:
                return store_pspec(shape[:-1], ax[:-1], layout)
            return store_pspec(shape, ax, layout)

        def vc_spec(ax, leaf):
            shape = tuple(leaf.shape)
            if len(shape) >= 2:
                return store_pspec(shape[:-2] + shape[-1:], ax[:-2] + ax[-1:], layout)
            return P()

        opt_specs = AdafactorState(step=P(), vr=map_axes(vr_spec, axes, params),
                                   vc=map_axes(vc_spec, axes, params))
    elif opt_name == "adamw8bit":  # block-flattened states: stored replicated
        rep = {k: P() for k in p_specs}
        opt_specs = Adam8State(step=P(), m_q=rep, m_s=dict(rep), v_q=dict(rep), v_s=dict(rep))
    else:
        raise ValueError(f"optimizer {opt_name!r}")
    return TrainState(params=p_specs, opt=opt_specs, step=P())


def make_train_step(cfg: ModelConfig, hp: TrainHParams, *, layout: Layout = NULL_LAYOUT,
                    grad_specs: dict | None = None):
    """``train_step(state, batch) -> (state, metrics)``: ``batch`` holds
    ``tokens`` and ``targets`` (B, T) (and ``prefix_embeds`` for the
    vision stub) as numpy arrays or tensors — the whole global batch, on
    a mesh too (each rank takes its part).  The loss and its gradients
    by autograd (each pattern unit rematerialised), the gradients clipped
    to ``hp.opt.clip_norm`` by global norm, the learning rate from
    ``warmup_cosine`` at the state's step, then the optimizer's update in
    place.  Metrics ``loss``, ``grad_norm`` and ``lr`` are float32
    scalars left on the device.

    With a ``train`` layout on a live mesh, the ZeRO step of the module
    docstring; ``grad_specs`` (the params' storage specs,
    ``make_train_state_specs(...).params``) and ``REPRO_GRAD_SHARD``
    (default ``"1"``) choose the gradient reduction."""
    if _on_mesh(layout):
        return _ShardedStep(cfg, hp, layout, grad_specs)

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


class _ShardedStep:
    """The ZeRO train step on a live mesh (the module docstring).  Holds
    the compute model (every leaf gathered whole each step) and the plan:
    each leaf's ``NamedSharding`` and full shape."""

    def __init__(self, cfg: ModelConfig, hp: TrainHParams, layout: Layout, grad_specs):
        self.cfg, self.hp = cfg, hp
        self.mesh = _live_mesh(layout)
        self.world = math.prod(self.mesh.shape)
        meta = Transformer(cfg, device="meta")
        leaves = reference_leaves(meta)
        specs = make_train_state_specs(leaves, reference_axes(meta), layout, hp.opt.name)
        if grad_specs is not None and dict(grad_specs) != specs.params:
            raise ValueError("grad_specs: the port reduces gradients into the params' storage "
                             "blocks; pass make_train_state_specs(...).params")
        shardings = named_shardings(self.mesh, specs)
        self.shapes = {k: tuple(v.shape) for k, v in leaves.items()}
        self.sharded = Sharded(self.shapes, shardings.params, shardings.opt)
        self.reduce_scatter = (grad_specs is not None and hp.opt.name != "adamw8bit"
                               and os.environ.get("REPRO_GRAD_SHARD", "1") == "1")
        # the batch's rows over act_batch, its loss positions over act_seq
        self.batch_sharding = NamedSharding(self.mesh, act_pspec(("act_batch", "act_seq"), layout))
        self.model: Transformer | None = None

    def _compute_model(self) -> Transformer:
        """The compute model on the mesh's device, made on the first step
        (uninitialised: every step gathers its leaves whole)."""
        if self.model is None:
            model = Transformer(self.cfg, generator=None, device=self.mesh.device)
            model.requires_grad_(True)
            reference_leaves(model)
            for m in model.modules():
                if isinstance(m, MoE):
                    m.batch_mean = self._world_mean
            self.model = model
        return self.model

    def _world_mean(self, x: torch.Tensor) -> torch.Tensor:
        y = x.detach().clone()
        dist.all_reduce(y)
        return y / self.world

    @torch.no_grad()
    def _gather(self, shards: dict, leaves: dict) -> None:
        """Every leaf whole from every rank's blocks: one ``all_gather`` of
        the concatenated blocks."""
        local = torch.cat([shards[k].reshape(-1) for k in self.shapes])
        out = local.new_empty((self.world, local.numel()))
        dist.all_gather(list(out.unbind(0)), local)
        for r in range(self.world):
            off = 0
            for k, shape in self.shapes.items():
                sh = self.sharded.params[k]
                n = shards[k].numel()
                if sh.owns(r):
                    leaves[k][sh.block(shape, r)] = out[r, off:off + n].view(shards[k].shape)
                off += n

    @torch.no_grad()
    def _reduce_scatter(self, grads: dict) -> dict:
        """Each rank's blocks of the summed gradients: one
        ``reduce_scatter`` of every rank's concatenated blocks."""
        ins = torch.stack([torch.cat([grads[k][self.sharded.params[k].block(shape, r)].reshape(-1)
                                      for k, shape in self.shapes.items()])
                           for r in range(self.world)])
        out = ins.new_empty(ins.shape[1:])
        dist.reduce_scatter(out, list(ins.unbind(0)))
        shards, off = {}, 0
        for k, shape in self.shapes.items():
            block = self.sharded.params[k].shard_shape(shape)
            n = math.prod(block)
            shards[k] = out[off:off + n].view(block)
            off += n
        return shards

    @torch.no_grad()
    def _all_reduce(self, grads: dict) -> None:
        """The summed gradients whole, in place: one ``all_reduce``."""
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        dist.all_reduce(flat)
        off = 0
        for g in grads.values():
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()

    def _loss(self, model: Transformer, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(this rank's term of the global loss, for the backward; the
        global loss).  The terms sum over the ranks to the reference's
        ``lm_loss`` of the whole batch (see the module docstring)."""
        dev = model.device
        targets = batch["targets"]
        b, t = targets.shape
        rows, pos = self.batch_sharding.block((b, t), self.mesh.rank)
        # ranks that hold the same rows and positions (axes the batch leaves out)
        copies = self.world * (rows.stop - rows.start) * (pos.stop - pos.start) // (b * t)
        prefix = batch.get("prefix_embeds")
        prefix = None if prefix is None else as_device_tensor(prefix[rows], dev)
        hidden, aux = model.forward_train(as_device_tensor(batch["tokens"][rows], dev), prefix)
        lead = 0 if prefix is None else prefix.shape[1]  # no loss on the vision prefix
        own = hidden[:, lead + pos.start:lead + pos.stop]
        loss_sum, n_valid = chunked_xent(own, model.unembed_matrix(),
                                         as_device_tensor(targets[rows, pos], dev))
        n_all = n_valid.float()
        dist.all_reduce(n_all)
        term = loss_sum / torch.clamp_min(n_all / copies, 1) / copies + aux / self.world
        total = term.detach().clone()
        dist.all_reduce(total)
        return term, total

    def __call__(self, state: TrainState, batch: dict):
        hp = self.hp
        model = self._compute_model()
        leaves, grads = reference_leaves(model), grad_leaves(model)
        self._gather(state.params, leaves)
        for g in grads.values():
            g.zero_()
        term, loss = self._loss(model, batch)
        term.backward()
        if self.reduce_scatter:
            grads, gnorm = clip_by_global_norm(self._reduce_scatter(grads), hp.opt.clip_norm,
                                               self.sharded)
        else:
            self._all_reduce(grads)
            grads, gnorm = clip_by_global_norm(grads, hp.opt.clip_norm)
            if hp.opt.name != "adamw8bit":  # its moments are whole
                grads = {k: self.sharded.params[k].shard(g) for k, g in grads.items()}
        lr = warmup_cosine(state.step, peak_lr=hp.peak_lr, warmup=hp.warmup,
                           total=hp.total_steps)
        opt = opt_update(grads, state.opt, state.params, lr, hp.opt, self.sharded)
        return (TrainState(params=state.params, opt=opt, step=state.step + 1),
                {"loss": loss, "grad_norm": gnorm, "lr": lr})
