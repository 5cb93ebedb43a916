"""Mixture-of-Experts FFN with dropped tokens (top-k routing, capacity).

Port of ``repro.models.moe`` for one device (no expert parallelism):

  * router logits in float32 (the router's weight cast to float32),
    softmax as jax writes it;
  * top-k by a stable descending sort, so tied probabilities go to the
    lower expert index as in ``jax.lax.top_k``; the gates renormalised
    over the chosen experts with ``max(sum, 1e-9)``;
  * per-group capacity ``max(int(S k capacity_factor / E), 1)``: a group
    is a sequence in the full-sequence forward and the whole batch in
    decode (``group_by_batch``);
  * a (token, k) pair's slot in its expert is the count of earlier pairs
    routed there, in (token, k) order (a float32 cumsum of the one-hot
    routing, exact for integers); pairs at or past capacity are dropped;
  * the expert SwiGLU / GeGLU products in the activation dtype over
    (E, G x capacity) rows;
  * the outputs combined with the gates (rounded to the activation dtype,
    as the reference's combine tensor is) summed in float32 over k, then
    the shared expert's FFN of the input added (llama4).

The reference dispatches and combines with (G, S, E, C) one-hot einsums;
here the dispatch is a scatter of token rows into their slots (exact:
the reference's dispatch sums one row times 1) and the combine a gather
of each pair's expert row, so no (G, S, E, C) tensor exists.  The
combine's k terms are summed in k order where the reference's dot sums
its E x C terms in its own order, within float32 rounding of k terms.
The aux losses (``moe_aux``, the Switch load-balance loss, and
``moe_zloss``) come back in a dict as the reference returns them.

``batch_mean`` (None on one device) is set by a sharded train step: it
maps this rank's share of tokens routed to each expert to the whole
batch's (an all-reduce; no gradient flows through it), because the
Switch loss ``E * sum(frac_tokens * mean_prob)`` is a product of two
batch means.  ``mean_prob`` enters linearly, so its global mean needs no
collective here: the step averages each rank's aux term over the ranks
(``train.train_step``), which sums the gradient as the whole batch's.

Expert parallelism under an executed serving layout (``shard``): a rank
holds its block of the experts (``experts`` on ``model``) and runs only
the pairs routed to them, in their capacity slots; the combined output
of every rank's experts is summed over ``model`` in float32 and then
rounded to the activation dtype, as one device sums the k terms in
float32 and rounds once.

* decode (``group_by_batch``) groups the *whole* batch, whatever the
  ``data`` split: as under GSPMD, the capacity positions (and so which
  pairs drop) come from routing over every row, so the router's logits
  are all-gathered over the batch axis before the cumulative positions.
  The input is the rank's d_model block; it is all-gathered over
  ``model`` for the experts' products, and the rank keeps its block of
  the output;
* prefill routes a sequence a group, so the input's sequence blocks
  are all-gathered over ``model`` and routed whole; the summed output
  comes back as the rank's sequence block (a reduce-scatter).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import FFN, Linear, act, normal_init


class Routing(NamedTuple):
    """One group batch's routing: float32 ``probs`` (G, S, E) and
    ``logits``, ``gates`` (G, S, K) renormalised, ``experts`` (G, S, K)
    int64, ``slot`` (G, S, K) the pair's position in its expert, ``kept``
    (G, S, K) bool (slot < capacity), ``capacity``."""
    logits: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    onehot: torch.Tensor
    slot: torch.Tensor
    kept: torch.Tensor
    capacity: int


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class MoE(nn.Module):
    """``router`` (d, E), ``w_gate`` / ``w_up`` (E, d, moe_d_ff)
    N(0, 1/d), ``w_down`` (E, moe_d_ff, d) N(0, 1/moe_d_ff), and ``shared``,
    a gated FFN of width moe_d_ff x n_shared_experts, when the config has
    shared experts."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.batch_mean = None  # a sharded train step's all-reduce of frac_tokens
        self.router = Linear(d, e, **kw)
        self.w_gate = nn.Parameter(normal_init((e, d, ff), d ** -0.5, generator, device),
                                   requires_grad=False)
        self.w_up = nn.Parameter(normal_init((e, d, ff), d ** -0.5, generator, device),
                                 requires_grad=False)
        self.w_down = nn.Parameter(normal_init((e, ff, d), ff ** -0.5, generator, device),
                                   requires_grad=False)
        self.shared = (FFN(d, ff * cfg.n_shared_experts, cfg.act, **kw)
                       if cfg.n_shared_experts else None)
        self.shard = None  # a Shard under an executed serving layout

    def route(self, xg: torch.Tensor) -> Routing:
        """Route the groups xg (G, S, D)."""
        return self.route_logits(self.router(xg, torch.float32))

    def route_logits(self, logits: torch.Tensor) -> Routing:
        """Route the groups by their float32 router logits (G, S, E)."""
        cfg = self.cfg
        g, s, _ = logits.shape
        e, k = cfg.n_experts, cfg.moe_top_k
        cap = max(int(s * k * cfg.capacity_factor / e), 1)
        probs = softmax(logits)
        vals, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, experts = vals[..., :k], experts[..., :k]
        gates = vals / torch.clamp_min(vals.sum(dim=-1, keepdim=True), 1e-9)
        onehot = F.one_hot(experts, e).float()  # (G, S, K, E)
        flat = onehot.reshape(g, s * k, e)
        before = (torch.cumsum(flat, dim=1) - flat).reshape(g, s, k, e)
        slot = torch.gather(before, -1, experts[..., None])[..., 0].long()
        return Routing(logits, probs, gates, experts, onehot, slot, slot < cap, cap)

    def _experts(self, xg: torch.Tensor, r: Routing, first: int) -> torch.Tensor:
        """The gated sum, float32 (G, S, D), of the pairs of the tokens xg
        (G, S, D) (routing ``r``) kept by the experts this module holds,
        ``first`` the first of them: each kept pair's row in (G, E x C + 1),
        every other pair in the last (dump) row, which no expert reads."""
        cfg = self.cfg
        g, s, d = xg.shape
        e, k, cap, dt = self.w_gate.shape[0], cfg.moe_top_k, r.capacity, xg.dtype
        mine = r.kept & (r.experts >= first) & (r.experts < first + e)
        rows = torch.where(mine, (r.experts - first) * cap + r.slot, e * cap)  # (G, S, K)
        gi = torch.arange(g, device=xg.device)[:, None, None].expand(g, s, k)
        si = torch.arange(s, device=xg.device)[None, :, None].expand(g, s, k)
        xe = xg.new_zeros((g, e * cap + 1, d))
        xe[gi, rows] = xg[gi, si]
        xe = xe[:, :e * cap].reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
        h = act(cfg.act)(torch.bmm(xe, self.w_gate.to(dt))) * torch.bmm(xe, self.w_up.to(dt))
        ye = torch.bmm(h, self.w_down.to(dt))  # (E, G x C, D)
        ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
        ye = torch.cat([ye, ye.new_zeros((g, 1, d))], dim=1)
        weight = torch.where(mine, r.gates, 0.0).to(dt).float()  # the combine, rounded to dt
        acc = torch.zeros((g, s, d), dtype=torch.float32, device=xg.device)
        for j in range(k):
            acc = acc + ye[gi[..., j], rows[..., j]].float() * weight[..., j, None]
        return acc

    def _sharded(self, x: torch.Tensor, group_by_batch: bool):
        """(out, routing) under the layout of ``self.shard`` (the module
        docstring): decode's x (B_local, 1, D block), prefill's
        (B_local, T block, D)."""
        sh, dt = self.shard, x.dtype
        first = sh.experts.block(self.cfg.n_experts).start
        if group_by_batch:  # decode: route the global batch
            b = x.shape[0]
            logits = sh.batch.all_gather(self.router(x, torch.float32).reshape(1, b, -1), 1)
            r = self.route_logits(logits)
            mine = slice(sh.batch.index * b, (sh.batch.index + 1) * b)
            r_rows = Routing(*(f[:, mine] if isinstance(f, torch.Tensor) else f for f in r))
            xg = sh.embed.all_gather(x, -1).reshape(1, b, -1)
            acc = sh.experts.all_reduce(self._experts(xg, r_rows, first))
            out = acc.to(dt).reshape(b, 1, -1)[..., sh.embed.block(self.cfg.d_model)]
            return out, r
        if sh.seq is not sh.experts:
            raise NotImplementedError("prefill MoE: the experts' axis must be the sequence's")
        xg = sh.seq.all_gather(x, 1)  # (B, T, D): a sequence a group
        r = self.route(xg)
        return sh.seq.reduce_scatter(self._experts(xg, r, first), 1).to(dt), r

    def forward(self, x: torch.Tensor, *, group_by_batch: bool = False):
        """x (B, T, D) -> (out (B, T, D), {"moe_aux", "moe_zloss"} float32)."""
        cfg = self.cfg
        b, t, d = x.shape
        e, dt = cfg.n_experts, x.dtype
        if self.shard is not None:
            out, r = self._sharded(x, group_by_batch)
        else:
            xg = x.reshape(1, b * t, d) if group_by_batch else x
            r = self.route(xg)
            out = self._experts(xg, r, 0).to(dt).reshape(b, t, d)
        if self.shared is not None:
            out = out + self.shared(x)
        # Switch load-balance loss + router z-loss
        frac_tokens = r.onehot.sum(dim=2).mean(dim=(0, 1))  # (E,) share routed
        if self.batch_mean is not None:
            frac_tokens = self.batch_mean(frac_tokens)
        mean_prob = r.probs.mean(dim=(0, 1))
        aux = e * torch.sum(frac_tokens * mean_prob) * cfg.router_aux_coef
        zloss = 1e-4 * torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
        return out, {"moe_aux": aux, "moe_zloss": zloss}
