"""GQA attention: the chunked causal/windowed forward (prefill) and cached
one-token decode.

Port of ``repro.models.attention`` for one device.  The forward is the
reference's flash-style loop over KV chunks with float32 running max and
sum, in its arithmetic: scores and the PV product take float32 inputs
(the reference asks XLA for float32 outputs of bf16 products, which the
exact upcast reproduces), masked scores are ``NEG_INF`` = -1e30, not
-inf, so a query whose whole chunk is masked (a windowed layer's early
chunks) sums ``exp(0)`` until a chunk holds a valid key and then
``alpha = exp(-1e30 - m)`` = 0 wipes it — where -inf would give NaN.

Decode keeps a ring-buffer cache for windowed layers (slot ``pos %
length``) and a full-length cache for global ones (slot ``pos``), with
each slot's absolute position, so the window mask is exact across the
ring's wrap.  The decode PV product has no float32 output type in the
reference: its dtype is the promotion of the probabilities cast to the
activation dtype and the cache's dtype, and so it is here.

GQA is computed with grouped einsums — K/V are never materialised per
query head.  ``F.scaled_dot_product_attention`` is not used: it masks
with -inf and rounds the scores its own way.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Linear, linear, rope, rope_freq, scalar

NEG_INF = -1e30


class Attention(nn.Module):
    """Projections ``wq`` (d, (H, dh)), ``wk`` / ``wv`` (d, (KV, dh)) —
    with biases when ``cfg.qkv_bias`` — and ``wo`` (H * dh, d)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.wq = Linear(d, (h, dh), bias=cfg.qkv_bias, **kw)
        self.wk = Linear(d, (kv, dh), bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d, (kv, dh), bias=cfg.qkv_bias, **kw)
        self.wo = Linear(h * dh, d, **kw)
        self.register_buffer("freq", rope_freq(dh, cfg.rope_theta, device), persistent=False)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Project + rope. x (B, T, D) -> q (B,T,KV,G,dh), k/v (B,T,KV,dh)."""
        cfg = self.cfg
        q = self.wq(x)  # (B, T, H, dh)
        k = self.wk(x)  # (B, T, KV, dh)
        v = self.wv(x)
        q = rope(q, positions, self.freq)
        k = rope(k, positions, self.freq)
        q = q * scalar(cfg.head_dim ** -0.5, q.dtype)
        b, t = x.shape[0], x.shape[1]
        q = q.reshape(b, t, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
        return q, k, v

    def _out_proj(self, o: torch.Tensor) -> torch.Tensor:
        b, t = o.shape[:2]
        return linear(o.reshape(b, t, self.cfg.n_heads * self.cfg.head_dim), self.wo.w)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, window: int | None,
                kv_chunk: int = 512):
        """Causal (optionally windowed) attention over KV chunks.

        x (B, T, D), positions (B, T) or (T,).  Returns (out (B, T, D),
        (k, v) (B, T, KV, dh) each, the prompt's KV for prefill)."""
        cfg = self.cfg
        b, t, _ = x.shape
        kv_g, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
        q, k, v = self._qkv(x, positions)
        chunk = min(kv_chunk, t)
        while t % chunk:
            chunk //= 2
        qpos = positions if positions.dim() == 2 else positions[None].expand(b, t)
        qp = qpos[:, None, None, :, None]  # (B, 1, 1, T, 1)
        qf = q.float()
        m = torch.full((b, kv_g, g, t), NEG_INF, dtype=torch.float32, device=x.device)
        l = torch.zeros((b, kv_g, g, t), dtype=torch.float32, device=x.device)
        o = torch.zeros((b, t, kv_g, g, dh), dtype=torch.float32, device=x.device)
        for base in range(0, t, chunk):
            kci, vci = k[:, base:base + chunk], v[:, base:base + chunk]
            s = torch.einsum("btkgd,bskd->bkgts", qf, kci.float())  # (B,KV,G,T,chunk)
            kpos = base + torch.arange(chunk, device=x.device)
            mask = qp >= kpos
            if window is not None:
                mask = mask & ((qp - kpos) < window)
            if cfg.logit_softcap:
                s = cfg.logit_softcap * torch.tanh(s / cfg.logit_softcap)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bkgts,bskd->btkgd", p.to(x.dtype).float(), vci.float())
            m = m_new
        o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        o = o.reshape(b, t, cfg.n_heads, dh).to(x.dtype)
        return self._out_proj(o), (k, v)

    def decode(self, x: torch.Tensor, cache: dict, pos: int, *, window: int | None):
        """One-token cached attention. x (B, 1, D); ``pos`` the token's
        absolute position.

        Global layers: slot = pos (cache length == max sequence).  Windowed
        layers: slot = pos % length (ring buffer); the stored per-slot
        absolute positions make the window mask exact across the wrap.
        The cache's tensors are updated in place (and returned)."""
        cfg = self.cfg
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        q, k_new, v_new = self._qkv(x, positions)  # q (B,1,KV,G,dh)
        k, v, cpos = cache["k"], cache["v"], cache["pos"]
        length = k.shape[1]
        slot = pos % length if window is not None else pos
        cpos[slot] = pos
        k[:, slot] = k_new[:, 0].to(k.dtype)
        v[:, slot] = v_new[:, 0].to(v.dtype)
        s = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float())  # (B,KV,G,1,S) f32
        valid = (cpos >= 0) & (cpos <= pos)
        if window is not None:
            valid = valid & ((pos - cpos) < window)
        s = torch.where(valid, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        pv = torch.promote_types(x.dtype, v.dtype)
        o = torch.einsum("bkgts,bskd->btkgd", p.to(x.dtype).to(pv), v.to(pv))
        o = o.reshape(b, 1, cfg.n_heads, cfg.head_dim)
        return self._out_proj(o), cache


def make_cache(cfg: ModelConfig, batch: int, length: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """KV cache for one attention layer: ``k`` / ``v`` (B, length, KV, dh)
    zeros and ``pos`` (length,) int32, each slot's absolute position (-1:
    empty)."""
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, length, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, kv, dh), dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }
