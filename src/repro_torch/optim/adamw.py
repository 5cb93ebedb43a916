"""Optimizers: AdamW (float32 state), Adafactor (factored second moment)
and blockwise 8-bit AdamW (quantised moments, float32 per-block scales).

Port of ``repro.optim.adamw``.  Parameters, gradients and
moments are dicts of tensors keyed by the reference's leaf paths
(``models.convert.reference_leaves``), in its flattening order; a unit
leaf is stacked over the units, as the reference's is, which matters
where an update reaches across a leaf: Adafactor factors the last two
axes and clips by the RMS of the whole leaf, 8-bit AdamW cuts the
flattened leaf into blocks of 256.

``init(params) -> state``; ``update(grads, state, params, lr, cfg)``
writes the new parameters and moments in place under ``torch.no_grad``
and returns the new state (its ``step`` a new int32 scalar).  The
arithmetic is the reference's op for op, Python constants rounded to
float32 as JAX's weak types are; ``b ** step`` is a float32 ``pow`` of a
0-dim tensor (on the CPU it equals XLA's at steps 1-3,000 for b = 0.9,
0.95 and 0.999).  Where XLA's CPU backend contracts a multiply and an
add into one FMA the jitted reference can differ in the last bit; the
reductions (``global_norm``'s sums, Adafactor's means) sum in another
order.  ``tests/test_torch_optim.py`` states the distances.

Sharded (``Sharded``: each leaf's full shape and ``NamedSharding`` on a
live mesh, as ``train.train_step`` stores a ZeRO state), the leaves are
this rank's blocks.  ``global_norm`` sums the squares of the blocks each
rank owns (a leaf, or part of one, replicated over an axis is counted on
that axis's coordinate 0 only) and all-reduces one scalar.  AdamW is
elementwise and runs on the blocks as it is.  Adafactor's row and column
means, its row statistics' mean and its update RMS are sums over the
whole leaf: each is summed over the owned blocks into the full
statistic's shape and all-reduced over the world, and the factored
statistics are gathered whole to update and sliced back to their
storage blocks.  8-bit AdamW's moments are replicated (the reference's
specs): it takes whole gradients, updates the whole moments on every
rank and this rank's block of the parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor | adamw8bit
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


class Sharded(NamedTuple):
    """How a sharded update's leaves lie on the mesh: ``shapes`` each
    path's full shape, ``params`` each parameter's ``NamedSharding``
    (also its gradient's and AdamW moments'), ``opt`` the optimizer
    state's tree of ``NamedSharding`` (``make_train_state_specs``')."""
    shapes: dict
    params: dict
    opt: Any

    @property
    def rank(self) -> int:
        return next(iter(self.params.values())).mesh.rank


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    dist.all_reduce(x)
    return x


def global_norm(tree: dict, sharded: Sharded | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in the dict's order (the reference's flattening order).
    ``sharded``: the leaves are blocks; the squares of the blocks this
    rank owns are summed and all-reduced over the world."""
    if sharded is None:
        return sqrt(sum(torch.sum(torch.square(x.float())) for x in tree.values()))
    parts = [torch.sum(torch.square(x.float())) for k, x in tree.items()
             if sharded.params[k].owns(sharded.rank)]
    dev = next(iter(tree.values())).device
    return sqrt(_all_reduce(sum(parts, torch.zeros((), device=dev))))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float,
                        sharded: Sharded | None = None) -> tuple[dict, torch.Tensor]:
    """Scales every gradient in place by ``min(1, max_norm / max(norm,
    1e-9))``; returns (grads, the norm before clipping)."""
    norm = global_norm(grads, sharded)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale)
    return grads, norm


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's.  torch's float32
    ``sqrt`` on the CPU is not (666 of 100,000 random values an ulp off);
    through float64 it is (53 >= 2 x 24 + 2 bits, so the double rounding
    is exact).  CUDA's float32 ``sqrt`` is correctly rounded itself."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def _new_step(step: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(step + 1 as int32, the same as a float32 scalar)."""
    step = step + 1
    return step, step.float()


def _bias_correction(b: float, step_f: torch.Tensor) -> torch.Tensor:
    """``1 - b ** step`` in float32 (a 0-dim float32 pow; ``b`` stays a
    Python number, so no host-to-device copy waits for the card's queue)."""
    return 1.0 - torch.pow(b, step_f)


# ---------------------------------------------------------------- AdamW
def adamw_init(params: dict) -> AdamWState:
    dev = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=_zeros(params), v=_zeros(params))


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, lr, cfg: OptConfig) -> AdamWState:
    step, step_f = _new_step(state.step)
    b1c, b2c = _bias_correction(cfg.b1, step_f), _bias_correction(cfg.b2, step_f)
    for k, p in params.items():
        g = grads[k].float()
        m = state.m[k].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = state.v[k].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        p.sub_(lr * ((m / b1c) / (sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p))
    return AdamWState(step=step, m=state.m, v=state.v)


# ------------------------------------------------------------ Adafactor
class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: dict  # row statistics (the full second moment for leaves under 2-D)
    vc: dict  # column statistics (a (1,) zero for leaves under 2-D)


def adafactor_init(params: dict) -> AdafactorState:
    dev = next(iter(params.values())).device
    f32 = dict(dtype=torch.float32, device=dev)
    vr = {k: torch.zeros(p.shape[:-1] if p.dim() >= 2 else p.shape, **f32)
          for k, p in params.items()}
    vc = {k: torch.zeros(p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else (1,), **f32)
          for k, p in params.items()}
    return AdafactorState(step=torch.zeros((), dtype=torch.int32, device=dev), vr=vr, vc=vc)


def _sum_whole(part: torch.Tensor, shape, where: tuple, owner: bool) -> torch.Tensor:
    """The world's sum of every rank's ``part``, placed at ``where`` in a
    zero tensor of ``shape`` (nothing from a rank that is not ``owner``)."""
    full = part.new_zeros(shape)
    if owner:
        full[where] = part
    return _all_reduce(full)


@torch.no_grad()
def _adafactor_sharded(grads: dict, state: AdafactorState, params: dict, lr, cfg: OptConfig,
                       sh: Sharded) -> AdafactorState:
    """``adafactor_update`` on this rank's blocks (see the module docstring)."""
    step, step_f = _new_step(state.step)
    beta2 = 1.0 - step_f ** -0.8
    rank = sh.rank
    for k, p in params.items():
        g, shape, psh = grads[k].float(), sh.shapes[k], sh.params[k]
        g2 = g * g + 1e-30
        where, owner = psh.block(shape, rank), psh.owns(rank)
        vr, vc = state.vr[k], state.vc[k]
        if len(shape) >= 2:
            rows, cols = where[:-1], where[:-2] + where[-1:]
            row_mean = _sum_whole(g2.sum(dim=-1), shape[:-1], rows, owner) / shape[-1]
            col_mean = _sum_whole(g2.sum(dim=-2), shape[:-2] + shape[-1:], cols, owner) / shape[-2]
            vr_sh, vc_sh = sh.opt.vr[k], sh.opt.vc[k]
            vr_full = beta2 * vr_sh.gather(vr, shape[:-1]) + (1 - beta2) * row_mean
            vc_full = beta2 * vc_sh.gather(vc, shape[:-2] + shape[-1:]) + (1 - beta2) * col_mean
            vr.copy_(vr_sh.shard(vr_full))
            vc.copy_(vc_sh.shard(vc_full))
            r_norm = vr_full / torch.clamp_min(vr_full.mean(dim=-1, keepdim=True), 1e-30)
            denom = r_norm[rows][..., None] * vc_full[cols][..., None, :]
            u = g / sqrt(denom + cfg.eps)
        else:  # vr is stored as the parameter is: the same block
            vr.copy_(beta2 * vr + (1 - beta2) * g2)
            u = g / sqrt(vr + cfg.eps)
        sq = torch.sum(u * u) if owner else u.new_zeros(())
        rms = sqrt(_all_reduce(sq) / math.prod(shape) + 1e-30)
        u = u / torch.clamp_min(rms, 1.0)
        p.sub_(lr * (u + cfg.weight_decay * p))
    return AdafactorState(step=step, vr=state.vr, vc=state.vc)


@torch.no_grad()
def adafactor_update(grads: dict, state: AdafactorState, params: dict, lr,
                     cfg: OptConfig, sharded: Sharded | None = None) -> AdafactorState:
    if sharded is not None:
        return _adafactor_sharded(grads, state, params, lr, cfg, sharded)
    step, step_f = _new_step(state.step)
    beta2 = 1.0 - step_f ** -0.8  # the paper's schedule
    for k, p in params.items():
        g = grads[k].float()
        g2 = g * g + 1e-30
        vr, vc = state.vr[k], state.vc[k]
        if p.dim() >= 2:
            vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
            vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
            denom = ((vr[..., None] / torch.clamp_min(vr.mean(dim=-1, keepdim=True), 1e-30)[..., None])
                     * vc[..., None, :])
            u = g / sqrt(denom + cfg.eps)
        else:
            vr.copy_(beta2 * vr + (1 - beta2) * g2)
            u = g / sqrt(vr + cfg.eps)
        rms = sqrt(torch.mean(u * u) + 1e-30)  # update clipping: RMS <= 1
        u = u / torch.clamp_min(rms, 1.0)
        p.sub_(lr * (u + cfg.weight_decay * p))
    return AdafactorState(step=step, vr=state.vr, vc=state.vc)


# ------------------------------------------------------ 8-bit AdamW
BLOCK = 256


class Adam8State(NamedTuple):
    step: torch.Tensor
    m_q: dict  # int8 (n_blocks, BLOCK)
    m_s: dict  # float32 (n_blocks,)
    v_q: dict
    v_s: dict


def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The flattened leaf, zero-padded to whole blocks of 256: int8 codes
    ``round(x / max(scale, 1e-12))`` with ``scale = max |block| / 127``."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    amax = blocks.abs().amax(dim=1)
    # a divisor tensor: CUDA multiplies by the reciprocal of a Python number,
    # an ulp off at times (a scale, then a code, unlike the CPU's and XLA's)
    scale = amax / torch.full_like(amax, 127.0)
    return torch.round(blocks / torch.clamp_min(scale[:, None], 1e-12)).to(torch.int8), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (q.float() * scale[:, None]).reshape(-1)[:n].reshape(shape)


def adamw8bit_init(params: dict) -> Adam8State:
    dev = next(iter(params.values())).device
    zq = {k: _quant(torch.zeros_like(p, dtype=torch.float32)) for k, p in params.items()}
    return Adam8State(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m_q={k: q for k, (q, _) in zq.items()}, m_s={k: s for k, (_, s) in zq.items()},
                      v_q={k: q.clone() for k, (q, _) in zq.items()},
                      v_s={k: s.clone() for k, (_, s) in zq.items()})


@torch.no_grad()
def adamw8bit_update(grads: dict, state: Adam8State, params: dict, lr,
                     cfg: OptConfig, sharded: Sharded | None = None) -> Adam8State:
    """``sharded``: ``grads`` are whole, ``params`` this rank's blocks."""
    step, step_f = _new_step(state.step)
    b1c, b2c = _bias_correction(cfg.b1, step_f), _bias_correction(cfg.b2, step_f)
    for k, p in params.items():
        g = grads[k].float()
        shape = g.shape
        m = cfg.b1 * _dequant(state.m_q[k], state.m_s[k], shape) + (1 - cfg.b1) * g
        v = cfg.b2 * _dequant(state.v_q[k], state.v_s[k], shape) + (1 - cfg.b2) * g * g
        mb, vb = (m, v) if sharded is None else (sharded.params[k].shard(m), sharded.params[k].shard(v))
        p.sub_(lr * ((mb / b1c) / (sqrt(vb / b2c) + cfg.eps) + cfg.weight_decay * p))
        for q, s, x in ((state.m_q[k], state.m_s[k], m), (state.v_q[k], state.v_s[k], v)):
            nq, ns = _quant(x)
            q.copy_(nq)
            s.copy_(ns)
    return Adam8State(step=step, m_q=state.m_q, m_s=state.m_s, v_q=state.v_q, v_s=state.v_s)


# ------------------------------------------------------------- dispatch
def opt_init(params: dict, cfg: OptConfig):
    return {"adamw": adamw_init, "adafactor": adafactor_init,
            "adamw8bit": adamw8bit_init}[cfg.name](params)


def opt_update(grads: dict, state, params: dict, lr, cfg: OptConfig,
               sharded: Sharded | None = None):
    """``sharded``: the leaves are this rank's blocks (whole gradients for
    8-bit AdamW); AdamW's update is elementwise and needs nothing more."""
    if cfg.name == "adamw":
        return adamw_update(grads, state, params, lr, cfg)
    return {"adafactor": adafactor_update,
            "adamw8bit": adamw8bit_update}[cfg.name](grads, state, params, lr, cfg, sharded)
