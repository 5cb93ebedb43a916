"""Shared model layers: norms, rotary embeddings, projections, FFNs.

Port of ``repro.models.layers`` for one device: the reference's logical
sharding constraints (``lshard``) are no-ops there and are dropped.  The
arithmetic follows the reference op for op:

  * ``rms_norm`` computes in float32, scales by ``(1 + scale)`` (a
    Gemma-style scale initialised to ones) and casts back to the input's
    dtype;
  * ``linear`` casts the float32 master weight to the activation's dtype
    at every call and rounds the product once to that dtype (a bf16
    ``torch.matmul`` accumulates in float32 and rounds once, as XLA's
    ``preferred_element_type=float32`` followed by ``astype`` does); with
    ``dtype=torch.float32`` (the MoE router, the recurrent gates) the
    weight is cast to float32 and the input promoted to it, so a bf16
    input gives a float32 product of its bf16 values, and the bias is
    added in float32;
  * ``rope`` splits the head into halves (not interleaved pairs),
    rotates in float32 and casts back;
  * the GeLU is the tanh form (``jax.nn.gelu``'s default; ``F.gelu``'s
    own default is the erf form), and it and the SiLU round each op to
    the input's dtype with the constants in that dtype, as XLA does on a
    bf16 input.

Weights are ``nn.Parameter``s in float32, the reference's masters; a
linear's weight is held as ``(in, *out)``, the reference's layout, so a
reference parameter tree carries over without a transpose.

w8a16 serving (the reference's ``quantize_tree`` and ``linear``'s
``w_q`` / ``w_s`` branch): ``quantize_model`` turns every ``Linear``'s
master into int8 codes ``w_q`` (in, *out) and float32 per-output-channel
scales ``w_s`` (*out), symmetric over the input dimension, both buffers
(no gradient); the product then dequantises first, ``w_q.to(dt) *
w_s.to(dt)``, as the reference does.  Embeddings and the raw tensors of
the MoE experts, the RG-LRU and the xLSTM stay float32, as in the
reference.  The port's layers are not stacked, so each layer's scale is
taken over its own input dimension: the reference's, given the logical
axes, is taken over axis 1 of a stacked leaf, the same numbers.

Under an executed serving layout (``distributed.sharding.Shard``) a
rank holds blocks of the weights.  A ``Linear`` whose input dimension is
split (``reduce``, an ``Axis``: q/k/v, the FFN's gate and up, the
router, the recurrent kinds' input projections) takes the partial
product of its input block and weight rows, in float32 from the
operands rounded to the activation dtype, sums the partials over the
axis in float32 and rounds once to that dtype, as the one-device
product accumulates in float32 and rounds once (a bf16 sum of bf16
partials would round twice); the bias is added after the sum.  A
``Linear`` whose output dimension is split computes its block with no
collective; ``linears`` sends the partials of several products of one
input (q/k/v, the FFN's gate and up) in one all-reduce.  An ``RMSNorm``
whose input is split (``split``) sums the block's squares, all-reduces
the sum and scales its block; it is not folded into the products'
all-reduce, since one device rounds the normalised values to the
activation dtype before the products, which needs the sum first.
A w8a16 ``Linear`` under a layout dequantises its blocks of ``w_q`` and
``w_s`` as one device does (``w_q.to(dt) * w_s.to(dt)``) and then takes
the float weights' path.  Its scales are taken over the whole input
dimension before the blocks are cut, as the reference quantises each
leaf whole and then shards it.  Reference behaviour copied: the
reference's ``quantize_axes`` gives a stacked unit leaf's scales
(``units``, *out) the axes of ``w[1:]`` (in, *out), so its spec splits
the *units* by the input axis's rule (over ``model`` in ``decode`` and
``long``).  A rank then holds those rows (``ScaleRows``) and
``gathered_scales`` all-gathers a layer's rows over the axis before the
layer runs.

A ``Drawing`` given as the init's generator passes every leaf drawn
from its generator through its ``keep`` as it is drawn, in the init's
order: a rank's parameter blocks are drawn leaf by leaf from the
one-device init's generator that way, each leaf kept as its block and
freed (``models.zoo.init_params`` with a layout).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple

import torch
from torch import nn


class Drawing(NamedTuple):
    """An init's generator whose every drawn leaf passes through ``keep``
    (the leaf in, the tensor to keep out)."""
    generator: torch.Generator
    keep: Callable[[torch.Tensor], torch.Tensor]


def generator_of(generator) -> torch.Generator | None:
    """The ``torch.Generator`` to draw from (a ``Drawing``'s own)."""
    return generator.generator if isinstance(generator, Drawing) else generator


def drawn(generator, w: torch.Tensor) -> torch.Tensor:
    """A leaf just drawn from ``generator``, through its ``keep`` when it
    is a ``Drawing``."""
    return generator.keep(w) if isinstance(generator, Drawing) else w


def normal_init(shape, scale: float, generator: torch.Generator | Drawing | None,
                device) -> torch.Tensor:
    """float32 N(0, scale^2) from ``generator``; uninitialised storage when
    no generator is given (a loader fills it)."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if generator is not None:
        w = drawn(generator, w.normal_(generator=generator_of(generator)).mul_(scale))
    return w


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and float32 scales of a weight (in, *out), symmetric over
    the input dimension: ``scale = max |w| / 127`` a column, codes
    ``round(w / max(scale, 1e-12))`` (half to even, as ``jnp.round``)
    clipped to +-127."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=0)
    # a divisor tensor: CUDA multiplies by the reciprocal of a Python number,
    # an ulp off at times (a scale, then a code, unlike the CPU's and XLA's)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(wf / torch.clamp_min(scale[None], 1e-12)), -127, 127)
    return q.to(torch.int8), scale


class Linear(nn.Module):
    """Weight ``w`` (in_dim, *out_shape) with fan-in init N(0, 1/in_dim)
    (the reference's ``init_linear``), optional zero bias ``b`` (*out_shape).
    Quantised (``set_w8a16``), ``w`` is None and the buffers ``w_q`` /
    ``w_s`` hold the weight.  Under a layout whose spec splits a stacked
    unit leaf's scales over the units (``ScaleRows``, the module
    docstring), ``w_s`` is the rank's rows of that leaf and
    ``gathered_scale`` this layer's row while ``gathered_scales`` runs."""

    def __init__(self, in_dim: int, out_shape, *, bias: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        out_shape = (out_shape,) if isinstance(out_shape, int) else tuple(out_shape)
        self.w = nn.Parameter(normal_init((in_dim,) + out_shape, 1.0 / math.sqrt(in_dim),
                                      generator, device), requires_grad=False)
        self.b = (nn.Parameter(torch.zeros(out_shape, dtype=torch.float32, device=device),
                               requires_grad=False) if bias else None)
        self.reduce = None  # the Axis its input dimension is split over, under a layout
        self.scale_rows = None  # a ScaleRows when w_s holds rows of a stacked leaf's scales
        self.gathered_scale = None

    def weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The float32 master, or the w8a16 weight dequantised in ``dtype``
        (``w_q.to(dtype) * w_s.to(dtype)``, the reference's order)."""
        if self.w is not None:
            return self.w
        w_s = self.w_s if self.scale_rows is None else self.gathered_scale
        if w_s is None:
            raise RuntimeError("a Linear whose scales are rows of a stacked leaf runs inside "
                               "gathered_scales")
        return self.w_q.to(dtype) * w_s.to(dtype)

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        w = self.weight(dtype or x.dtype)
        if self.reduce is not None:
            return linear_reduced(x, w, self.b, dtype, self.reduce)
        return linear(x, w, self.b, dtype)

    def set_w8a16(self, w_q: torch.Tensor, w_s: torch.Tensor) -> None:
        """Hold the weight as int8 codes ``w_q`` (in, *out) and float32
        scales ``w_s`` (*out); the float32 master is dropped."""
        self.w = None
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_s", w_s)


@dataclasses.dataclass(frozen=True)
class ScaleRows:
    """A w8a16 ``Linear`` of unit ``unit`` of a stacked leaf whose scales
    (``units``, *out) the rank holds as its ceiling block of rows over
    ``axis`` (the reference's ``quantize_axes`` spec: the scales' unit
    dimension takes the input axis's rule)."""
    unit: int
    units: int
    axis: object


@contextlib.contextmanager
def gathered_scales(lins: list):
    """While the block runs, each ``Linear`` of ``lins`` (one layer's
    Linears with ``scale_rows``, ``Transformer.scale_rows``) holds its
    unit's row of scales in ``gathered_scale``: every such Linear's rows
    (padded to the ceiling block) in one all-gather over their axis."""
    axis = lins[0].scale_rows.axis
    rows = -(-lins[0].scale_rows.units // axis.size)
    pads = []
    for m in lins:
        p = m.w_s.new_zeros((rows,) + tuple(m.w_s.shape[1:]))
        p[:m.w_s.shape[0]] = m.w_s
        pads.append(p.reshape(-1))
    got = axis.all_gather(torch.cat(pads)[None], 0)  # (axis, every Linear's rows)
    off = 0
    for m, p in zip(lins, pads):
        part = got[:, off:off + p.numel()].reshape((axis.size * rows,) + tuple(m.w_s.shape[1:]))
        m.gathered_scale = part[m.scale_rows.unit]
        off += p.numel()
    try:
        yield
    finally:
        for m in lins:
            m.gathered_scale = None


def quantize_model(model: nn.Module) -> nn.Module:
    """w8a16 in place: every ``Linear`` of ``model`` quantised one at a
    time (``quantize_weight``), each master freed as it goes, so the
    float32 tree is never held twice.  Returns ``model``."""
    for m in model.modules():
        if isinstance(m, Linear) and m.w is not None:
            m.set_w8a16(*quantize_weight(m.w))
    return model


class RMSNorm(nn.Module):
    """``scale`` (dim,) float32, initialised to ones; see ``rms_norm``."""

    def __init__(self, dim: int, eps: float, *, device=None):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.scale = nn.Parameter(torch.ones((dim,), dtype=torch.float32, device=device),
                                  requires_grad=False)
        self.split = None  # the Axis its input's last dimension is split over, under a layout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split is not None:
            return rms_norm_split(x, self.scale, self.eps, self.dim, self.split)
        return rms_norm(x, self.scale, self.eps)


class FFN(nn.Module):
    """Gated FFN (SwiGLU for ``act="silu"``, GeGLU for ``"gelu"``)."""

    def __init__(self, d_model: int, d_ff: int, act: str, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.act = act
        self.gate = Linear(d_model, d_ff, generator=generator, device=device)
        self.up = Linear(d_model, d_ff, generator=generator, device=device)
        self.down = Linear(d_ff, d_model, generator=generator, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = linears(x, (self.gate, self.up))
        return self.down(act(self.act)(gate) * up)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, eps: float, dim: int,
                   axis) -> torch.Tensor:
    """``rms_norm`` of a tensor whose last dimension (``dim`` wide) is
    split over ``axis``: x and ``scale`` this rank's blocks.  The block's
    sum of squares in float32, summed over the axis, over ``dim``."""
    xf = x.float()
    var = axis.all_reduce(torch.sum(xf * xf, dim=-1, keepdim=True)) / dim
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rms_norm_block(x: torch.Tensor, scale: torch.Tensor, eps: float, cols: slice) -> torch.Tensor:
    """``rms_norm`` of a whole x whose output is wanted on the block
    ``cols`` of its last dimension only (``scale`` that block): the
    variance over the whole row, the block scaled."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf[..., cols] * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def linear_reduced(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, dtype, axis):
    """``linear`` with its input dimension split over ``axis``: x (..., in
    block) and w (in block, *out) this rank's blocks.  The partial
    product of the operands rounded to ``dtype`` (default x's), in
    float32, summed over the axis in float32, rounded once to the dtype,
    then the bias."""
    dt = dtype or x.dtype
    y = torch.matmul(x.to(dt).float(), w.to(dt).float().reshape(w.shape[0], -1))
    y = axis.all_reduce(y).to(dt).reshape(*x.shape[:-1], *w.shape[1:])
    if b is not None:
        y = y + b.to(dt)
    return y


def linears(x: torch.Tensor, mods, dtype: torch.dtype | None = None) -> list:
    """Each ``Linear`` of ``mods`` applied to ``x``.  Where all of them
    split their input dimension over one axis (a layout's contracting
    products of one input: q/k/v, gate/up), their float32 partial
    products are summed in one all-reduce, each then rounded once and
    given its bias, as ``linear_reduced`` would one by one."""
    axis = mods[0].reduce
    if axis is None or any(m.reduce is not axis for m in mods):
        return [m(x, dtype) for m in mods]
    dt = dtype or x.dtype
    xf = x.to(dt).float()
    ws = [m.weight(dt) for m in mods]
    flat = [w.to(dt).float().reshape(w.shape[0], -1) for w in ws]
    y = axis.all_reduce(torch.cat([torch.matmul(xf, w) for w in flat], dim=-1)).to(dt)
    out = []
    for m, w, part in zip(mods, ws, y.split([f.shape[1] for f in flat], dim=-1)):
        part = part.reshape(*x.shape[:-1], *w.shape[1:])
        out.append(part if m.b is None else part + m.b.to(dt))
    return out


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (..., in) @ w (in, *out) -> (..., *out) in ``dtype`` (default x's):
    the weight cast to it, x promoted to it, the product rounded once to
    it, then the bias in it."""
    dt = dtype or x.dtype
    y = torch.matmul(x.to(dt), w.to(dt).reshape(w.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if b is not None:
        y = y + b.to(dt)
    return y


def rope_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``theta ** (-arange(half) / half)`` as float32: the exponent in
    float32 (exact for a power-of-two half), the power in float64 and
    rounded once, which matches XLA's correctly rounded float32 power
    where torch's float32 ``pow`` can be an ulp off."""
    half = head_dim // 2
    e = -torch.arange(0, half, dtype=torch.float32) / half
    return (theta ** e.double()).float().to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
    """Rotary embedding. x (..., T, H, dh), positions (..., T) integer,
    ``freq`` from ``rope_freq``."""
    half = x.shape[-1] // 2
    ang = positions[..., None].float() * freq  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float.  An op of a tensor
    with it rounds as the same op with a 0-dim tensor of that dtype (a
    weak-typed constant of the reference, rounded to the array's dtype
    first), and needs no host-to-device copy, which would wait for the
    card's queue."""
    return torch.tensor(v, dtype=dtype).item()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default, ``approximate=True``: the tanh form)
    op for op: ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 *
    x**3))))`` with the constants in x's dtype and each op rounded to it,
    as XLA evaluates it on a bf16 input (``F.gelu(approximate="tanh")``
    rounds once; its default is the erf form)."""
    dt = x.dtype
    inner = scalar(math.sqrt(2.0 / math.pi), dt) * (x + scalar(0.044715, dt) * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * logistic(x)``, the logistic as XLA expands it,
    ``1 / (1 + exp(-x))``, each op rounded to x's dtype (``F.silu`` and
    ``torch.sigmoid`` round once, which differs in bf16)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (XLA's logistic, ``1 / (1 + exp(-x))``)."""
    return 1.0 / (1.0 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))`` (``F.softplus`` returns x past its threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def act(name: str):
    """The reference's ``_act``: the tanh-form GeLU for "gelu", else SiLU."""
    return gelu_tanh if name == "gelu" else silu


def ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        act_name: str) -> torch.Tensor:
    """Gated FFN: down(act(gate(x)) * up(x))."""
    h = act(act_name)(linear(x, w_gate)) * linear(x, w_up)
    return linear(h, w_down)


def causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                history: torch.Tensor | None = None):
    """Causal temporal conv of the recurrent blocks (the reference's
    ``rglru._conv1d`` / ``xlstm._causal_conv``). x (B, T, W), ``conv_w``
    (cw, W), ``history`` (B, cw-1, W) or None (zeros).  Returns (out
    (B, T, W), the new history: the last cw-1 inputs), both in x's dtype;
    the taps are summed in order, each product and sum rounded to it."""
    cw, t = conv_w.shape[0], x.shape[1]
    if history is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    w = conv_w.to(x.dtype)
    out = xp[:, 0:t] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + t] * w[i]
    return out + conv_b.to(x.dtype), xp[:, xp.shape[1] - (cw - 1):]
