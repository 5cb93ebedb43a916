"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Port of ``repro.models.rglru`` for one device.  Two branches from the
block's input: a gate branch (linear -> GeLU) and a recurrent branch
(linear -> causal temporal conv -> RG-LRU); their product is projected
back to d_model.  The recurrence, elementwise over channels:

    r_t = sigmoid(W_a xi_t),  i_t = sigmoid(W_x xi_t)
    log a_t = -8 softplus(Lambda) r_t
    h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) (i_t xi_t)

The gates and the recurrence run in float32 (the gate linears cast their
weights to float32).  The full-sequence form is ``linear_scan``, a
log-depth parallel scan over T in ``jax.lax.associative_scan``'s order
of combines, not a T-step loop; decode is one step of the recurrence.

Under an executed serving layout (``shard``): decode's input products
reduce over the split d_model and ``w_out`` gives the rank's d_model
block (``layers.Linear``); the state is whole on every ``model`` rank
(``act_lru`` is unmapped there).  Prefill goes from sequence blocks to
channel blocks (``act_lru``) for the conv and the scan: the input's
sequence is all-gathered over ``model``, each rank computes its block of
the ``W`` channels (the recurrent and gate branches' columns), the conv
over them, the conv's output all-gathered over the channels for the
gates' products (each rank its gates' columns), the scan over its
channels; ``w_out``'s partial products over the channel block are
summed and scattered back to sequence blocks (a reduce-scatter in
float32), then rounded once.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (Linear, causal_conv, drawn, gelu_tanh, generator_of,
                                       linear, linears, normal_init, sigmoid, softplus)

_C = 8.0


def _combine(left, right):
    """The reference's combine: (a1, b1) then (a2, b2) is (a1 a2, a2 b1 + b2)."""
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even at 0, 2, ... and odd at 1, 3, ... along dim 1."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``_combine`` over dim 1: the second output is
    h_t = a_t h_{t-1} + b_t from h_{-1} = 0.  The recursion of
    ``jax.lax.associative_scan`` (combine adjacent pairs, scan the
    halves, fill in the even positions, interleave), so each h_t comes
    from the same combines in the same order: 2 log2(T) levels."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = linear_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


class RGLRU(nn.Module):
    """``w_rec`` / ``w_gate`` (d, W), ``w_out`` (W, d), the gate linears
    ``w_a`` / ``w_i`` (W, W), ``lam`` (W,) (so that a ~ U[0.9, 0.999]^(1/8)
    at r = 1), ``conv_w`` (conv_width, W) N(0, 0.01^2), ``conv_b`` (W,) zeros."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        kw = dict(generator=generator, device=device)
        self.w_rec = Linear(d, w, **kw)
        self.w_gate = Linear(d, w, **kw)
        self.w_out = Linear(w, d, **kw)
        self.w_a = Linear(w, w, **kw)
        self.w_i = Linear(w, w, **kw)
        lam = torch.empty((w,), dtype=torch.float32, device=device)
        if generator is not None:  # the inverse softplus of -log(u) / 8
            u = lam.uniform_(0.9, 0.999, generator=generator_of(generator))
            lam = drawn(generator, torch.log(torch.expm1(-torch.log(u) / _C)))
        self.lam = nn.Parameter(lam, requires_grad=False)
        self.conv_w = nn.Parameter(normal_init((cfg.conv_width, w), 0.01, generator, device),
                                   requires_grad=False)
        self.conv_b = nn.Parameter(torch.zeros((w,), dtype=torch.float32, device=device),
                                   requires_grad=False)
        self.shard = None  # a Shard under an executed serving layout

    def _gates(self, xi: torch.Tensor, xi_all: torch.Tensor | None = None,
               cols: slice = slice(None)):
        """(a, sqrt(1 - a^2) i xi), float32, from the conv output xi; under
        prefill's channel split, the gates' ``cols`` from every channel's
        ``xi_all``."""
        if xi_all is None:
            r = sigmoid(self.w_a(xi, torch.float32))
            i = sigmoid(self.w_i(xi, torch.float32))
        else:
            f32 = torch.float32
            r = sigmoid(linear(xi_all, self.w_a.weight(f32)[:, cols], dtype=f32))
            i = sigmoid(linear(xi_all, self.w_i.weight(f32)[:, cols], dtype=f32))
        a = torch.exp(-_C * softplus(self.lam[cols].float()) * r)
        beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
        return a, beta * i * xi.float()

    def _forward_split(self, x: torch.Tensor) -> torch.Tensor:
        """Prefill under the layout: x the rank's sequence block (B, T
        block, D) -> its block of the output (the module docstring)."""
        ax = self.shard.seq
        w = self.lam.shape[0]
        if w % ax.size:
            raise NotImplementedError(f"RG-LRU prefill: width {w} over {ax.size} ranks")
        cols = ax.block(w)
        xs = ax.all_gather(x, 1)  # (B, T, D)
        dt = x.dtype
        xi = linear(xs, self.w_rec.weight(dt)[:, cols])
        gate = gelu_tanh(linear(xs, self.w_gate.weight(dt)[:, cols]))
        xi, _ = causal_conv(xi, self.conv_w[:, cols], self.conv_b[cols])
        _, h = linear_scan(*self._gates(xi, ax.all_gather(xi, -1), cols))
        y = (h.to(dt) * gate).float()
        part = torch.matmul(y, self.w_out.weight(dt)[cols].to(dt).float())
        return ax.reduce_scatter(part, 1).to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The full sequence: x (B, T, D) -> (B, T, D)."""
        if self.shard is not None:
            return self._forward_split(x)
        xi, gate = linears(x, (self.w_rec, self.w_gate))
        gate = gelu_tanh(gate)
        xi, _ = causal_conv(xi, self.conv_w, self.conv_b)
        _, h = linear_scan(*self._gates(xi))
        return self.w_out(h.to(x.dtype) * gate)

    def decode(self, x: torch.Tensor, state: dict):
        """One token: x (B, 1, D), ``state`` from ``make_rglru_state``,
        updated in place (``h`` float32; ``conv`` the last inputs, in x's
        dtype as the reference returns them)."""
        xi, gate = linears(x, (self.w_rec, self.w_gate))
        gate = gelu_tanh(gate)
        xi, conv = causal_conv(xi, self.conv_w, self.conv_b, state["conv"])
        a, b = self._gates(xi)
        h = a[:, 0] * state["h"] + b[:, 0]
        state["h"], state["conv"] = h, conv
        return self.w_out(h[:, None, :].to(x.dtype) * gate), state


def make_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    """``h`` (B, W) float32 zeros and ``conv`` (B, conv_width - 1, W) zeros
    in ``dtype``."""
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype, device=device)}
