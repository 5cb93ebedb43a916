"""xLSTM blocks: mLSTM (matrix memory, parallel form) and sLSTM (scalar
memory with recurrent gate coupling), arXiv:2405.04517.

Port of ``repro.models.xlstm`` for one device.

mLSTM: the full sequence uses the stabilized parallel form, an
attention-like product with a gate-derived (B, T, T, H) decay matrix, its
row maximum as the stabilizer and ``max(|sum_u sd|, exp(-m))`` as the
normalizer; decode uses the recurrent matrix-memory update

    C_t = f_t C_{t-1} + i_t v_t k_t^T,  n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

with the state's ``m`` starting at -1e30.  The block up-projects by 2
(q and k from the conv path, v from the pre-conv path), then RMS-norms,
gates with SiLU and projects down.

sLSTM: strictly sequential (h_{t-1} enters the gates through per-head
recurrent matrices), so the full sequence is a T-step loop of eager
steps; the four recurrent products of a step are one batched product
over the heads.  Stabilized exponential gating, ``max(n, 1e-6)``, then
an RMS norm and a GeGLU FFN of width round(4 d 4/3 / 64) 64.

Gates, memories and the recurrence run in float32; the gate linears cast
their weights to float32.

Under an executed serving layout (``shard``): in decode the states are
whole on every ``model`` rank (the heads are unmapped); the input
products reduce over the split d_model and the output products give
the rank's d_model block (``layers.Linear``).  The mLSTM's ``norm``
spans its 2d inner width, which is whole on every rank, so the rank
holds that scale whole; the sLSTM's post-norm takes the whole hidden
state's variance and scales the rank's d_model block
(``layers.rms_norm_block``).  Prefill puts no constraint inside the
blocks (as the reference): the layer gathers the sequence and runs the
block whole (``models.transformer.XLSTMLayer``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (FFN, Linear, RMSNorm, causal_conv, log_sigmoid,
                                       linears, normal_init, rms_norm, rms_norm_block, scalar,
                                       sigmoid, silu)

NEG_INF = -1e30
GATES = ("i", "f", "z", "o")


# ------------------------------------------------------------------ mLSTM
class MLSTM(nn.Module):
    """``w_up`` / ``w_gate`` (d, 2d), ``conv_w`` (conv_width, 2d), ``conv_b``,
    ``wq`` / ``wk`` (2d, (H, dh)), ``w_i`` (2d, H), ``w_f`` (2d, H) with its
    bias from 3 to 6 (forget gates near 1 at init), ``norm`` (2d), ``w_out``
    (2d, d); the value head is 2d / H wide."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
        inner = 2 * d
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.w_up = Linear(d, inner, **kw)
        self.w_gate = Linear(d, inner, **kw)
        self.conv_w = nn.Parameter(normal_init((cfg.conv_width, inner), 0.01, generator, device),
                                   requires_grad=False)
        self.conv_b = nn.Parameter(torch.zeros((inner,), dtype=torch.float32, device=device),
                                   requires_grad=False)
        self.wq = Linear(inner, (h, dh), **kw)
        self.wk = Linear(inner, (h, dh), **kw)
        self.w_i = Linear(inner, h, **kw)
        self.w_f = Linear(inner, h, bias=True, **kw)
        self.w_f.b.data.copy_(torch.linspace(3.0, 6.0, h))
        self.norm = RMSNorm(inner, cfg.norm_eps, device=device)
        self.w_out = Linear(inner, d, **kw)

    def _qkvif(self, x: torch.Tensor, history: torch.Tensor | None = None):
        """x (B, T, D) -> q, k (B, T, H, dh), v (B, T, H, 2d/H) in x's
        dtype, log_i and log_f (B, T, H) float32, the conv's history, and
        the output gate's product ``w_gate(x)``."""
        cfg = self.cfg
        up, gate = linears(x, (self.w_up, self.w_gate))  # up (B, T, 2d): v, before the conv
        conv, hist = causal_conv(up, self.conv_w, self.conv_b, history)
        conv = silu(conv)
        q = self.wq(conv) * scalar(cfg.head_dim ** -0.5, x.dtype)
        k = self.wk(conv)
        b, t = x.shape[:2]
        v = up.reshape(b, t, cfg.n_heads, -1)
        log_i = self.w_i(conv, torch.float32)
        log_f = log_sigmoid(self.w_f(conv, torch.float32))
        return q, k, v, log_i, log_f, hist, gate

    def _out(self, gate: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        hidden = rms_norm(hidden, self.norm.scale, self.cfg.norm_eps)
        return self.w_out(hidden * silu(gate))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The stabilized parallel form. x (B, T, D) -> (B, T, D); the
        (T, T) products are held as (B, H, T_s, T_u)."""
        b, t, d = x.shape
        q, k, v, log_i, log_f, _, gate = self._qkvif(x)
        cum_f = torch.cumsum(log_f, dim=1).transpose(1, 2)  # (B, H, T)
        # D[s, u] = cum_f[s] - cum_f[u] + log_i[u] for u <= s
        dmat = cum_f[..., :, None] - cum_f[..., None, :] + log_i.transpose(1, 2)[..., None, :]
        causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        dmat = torch.where(causal, dmat, NEG_INF)
        m = dmat.amax(dim=-1, keepdim=True)  # (B, H, T, 1): the row stabilizer
        dexp = torch.exp(dmat - m)
        del dmat
        scores = torch.einsum("bshd,buhd->bhsu", q.float(), k.float())
        sd = scores * dexp
        del scores, dexp
        norm = torch.maximum(torch.abs(sd.sum(dim=-1)), torch.exp(-m[..., 0]))  # (B, H, T)
        hidden = torch.einsum("bhsu,buhv->bshv", sd, v.float()) / norm.transpose(1, 2)[..., None]
        return self._out(gate, hidden.reshape(b, t, 2 * d).to(x.dtype))

    def decode(self, x: torch.Tensor, state: dict):
        """One token: x (B, 1, D), ``state`` from ``make_mlstm_state``,
        updated in place."""
        b = x.shape[0]
        q, k, v, log_i, log_f, hist, gate = self._qkvif(x, state["conv"])
        qf, kf, vf = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
        log_i, log_f = log_i[:, 0], log_f[:, 0]  # (B, H)
        m_new = torch.maximum(log_f + state["m"], log_i)
        f_s = torch.exp(log_f + state["m"] - m_new)
        i_s = torch.exp(log_i - m_new)
        c = (f_s[..., None, None] * state["c"]
             + i_s[..., None, None] * (kf[..., :, None] * vf[..., None, :]))  # (B, H, dh, dv)
        n = f_s[..., None] * state["n"] + i_s[..., None] * kf
        num = torch.einsum("bhd,bhdv->bhv", qf, c)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)), torch.exp(-m_new))
        hidden = (num / den[..., None]).reshape(b, 1, -1).to(x.dtype)
        state.update(c=c, n=n, m=m_new, conv=hist)
        return self._out(gate, hidden), state


def make_mlstm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    """``c`` (B, H, dh, 2d/H), ``n`` (B, H, dh) float32 zeros, ``m`` (B, H)
    at -1e30, ``conv`` (B, conv_width - 1, 2d) zeros in ``dtype``."""
    h, dh = cfg.n_heads, cfg.head_dim
    dv = 2 * cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, dh, dv), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), NEG_INF, **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, 2 * cfg.d_model), dtype=dtype,
                                device=device)}


# ------------------------------------------------------------------ sLSTM
class SLSTM(nn.Module):
    """``w_i`` / ``w_f`` / ``w_z`` / ``w_o`` (d, (H, dh)) with biases (the
    forget gate's at 3), ``r_i`` ... ``r_o`` (H, dh, dh) N(0, 1/dh), ``norm``
    (d), ``ffn`` (GeGLU of width 4d x 4/3 rounded to a multiple of 64);
    dh = d / H."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        for g in GATES:
            setattr(self, f"w_{g}", Linear(d, (h, dh), bias=True, **kw))
            setattr(self, f"r_{g}", nn.Parameter(
                normal_init((h, dh, dh), dh ** -0.5, generator, device), requires_grad=False))
        self.w_f.b.data.fill_(3.0)
        self.norm = RMSNorm(d, cfg.norm_eps, device=device)
        self.ffn = FFN(d, int(round(4 * d * 4 / 3 / 64)) * 64, "gelu", **kw)
        self.shard = None  # a Shard under an executed serving layout

    def _recurrent(self) -> torch.Tensor:
        """The four recurrent matrices side by side, (H, dh, 4 dh) float32."""
        return torch.cat([getattr(self, f"r_{g}").float() for g in GATES], dim=-1)

    @staticmethod
    def _step(r: torch.Tensor, state: tuple, gates: tuple):
        """One step. ``state`` (c, n, h, m) each (B, H, dh) float32, ``gates``
        the four input preactivations (B, H, dh); returns the new state."""
        c, n, h_prev, m = state
        rec = torch.bmm(h_prev.transpose(0, 1), r).transpose(0, 1)  # (B, H, 4 dh)
        zi, zf, zz, zo = (g + rr for g, rr in zip(gates, rec.chunk(4, dim=-1)))
        log_f = log_sigmoid(zf)
        m_new = torch.maximum(log_f + m, zi)
        i_s = torch.exp(zi - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c_new = f_s * c + i_s * torch.tanh(zz)
        n_new = f_s * n + i_s
        h_new = sigmoid(zo) * c_new / torch.clamp_min(n_new, 1e-6)
        return c_new, n_new, h_new, m_new

    def _post(self, hs: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """hs (B, T, H, dh) -> norm, then out + GeGLU FFN(out)."""
        b, t = hs.shape[:2]
        hs = hs.reshape(b, t, -1).to(dtype)
        if self.shard is not None and self.shard.kind != "prefill":  # this rank's d_model block
            out = rms_norm_block(hs, self.norm.scale, self.cfg.norm_eps,
                                 self.shard.embed.block(self.cfg.d_model))
        else:
            out = rms_norm(hs, self.norm.scale, self.cfg.norm_eps)
        return out + self.ffn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The T-step scan. x (B, T, D) -> (B, T, D)."""
        b, t, _ = x.shape
        # (T, B, H, dh) each, so a step reads contiguous rows
        gates = [getattr(self, f"w_{g}")(x, torch.float32).transpose(0, 1).contiguous()
                 for g in GATES]
        r = self._recurrent()
        state = make_slstm_state(self.cfg, b, x.device)
        state = (state["c"], state["n"], state["h"], state["m"])
        hs = torch.empty((t,) + state[0].shape, dtype=torch.float32, device=x.device)
        for i in range(t):
            state = self._step(r, state, tuple(g[i] for g in gates))
            hs[i] = state[2]
        return self._post(hs.transpose(0, 1), x.dtype)

    def decode(self, x: torch.Tensor, state: dict):
        """One token: x (B, 1, D), ``state`` from ``make_slstm_state``,
        updated in place."""
        gates = tuple(g[:, 0] for g in linears(x, [getattr(self, f"w_{g}") for g in GATES],
                                                torch.float32))
        c, n, h, m = self._step(self._recurrent(), (state["c"], state["n"], state["h"],
                                                    state["m"]), gates)
        state.update(c=c, n=n, h=h, m=m)
        return self._post(h[:, None], x.dtype), state


def make_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """``c``, ``n``, ``h`` (B, H, dh) float32 zeros and ``m`` at -1e30."""
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = torch.zeros((batch, h, dh), dtype=torch.float32, device=device)
    return {"c": z, "n": z, "h": z,
            "m": torch.full((batch, h, dh), NEG_INF, dtype=torch.float32, device=device)}
