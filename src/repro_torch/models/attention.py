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

With ``REPRO_KV_INT8=1`` when the cache is made (the reference's
``kv_cache_quantized``), the cache holds int8 codes ``k_q`` / ``v_q`` and
float32 scales ``k_s`` / ``v_s`` a (slot, head), the new token's written
in place at its slot as the bf16 path writes it; decode dequantises the
whole cache to the activation dtype at every step, as the reference
does, so a bf16 model's PV product stays bf16 however the cache was
asked for (no promotion to float32).

GQA is computed with grouped einsums — K/V are never materialised per
query head.  ``F.scaled_dot_product_attention`` is not used: it masks
with -inf and rounds the scores its own way.

Under an executed serving layout (``shard``, a ``distributed.sharding.
Shard``):

* ``prefill``: the queries are the rank's sequence block at their global
  positions; K/V are all-gathered over the sequence axis (``act_kv_seq``
  is unmapped), so each query runs the one-device loop over the same KV
  chunks; the rank's own (k, v) block is returned;
* ``decode`` / ``long``: q, k and v are whole on every rank (their
  products reduce over the split d_model); the rank holds its block of
  every cache (``cache_seq``: ``model`` in decode, the world in long),
  padded to the ceiling block with empty slots (``pos`` -1), and only
  the rank whose block holds the token's slot writes it.  A ring's slot
  is ``pos % window`` (the ring's length is the window, or a cache
  shorter than it whose positions never reach it, where ``pos % length
  == pos`` too).  The softmax is distributed (flash-decode): each rank
  takes its slots' maximum m_r and sum of ``exp(s - m_r)`` l_r in
  float32; one all-gather brings every rank's (m_r, l_r), and each rank
  forms the global maximum m and sum ``l = sum_r l_r exp(m_r - m)`` in
  rank order; the probabilities ``exp(s - m) / l`` are rounded to the
  activation dtype as one device rounds them; the local PV product in
  float32 is all-reduced (sum) and cast to the PV dtype: two collectives
  where max, sum and PV all-reduces take three.  The sums run in another
  order than ``torch.softmax``'s, so this is held to a tolerance, not
  bit for bit.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Linear, linears, rope, rope_freq, scalar

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
        self.shard = None  # a Shard under an executed serving layout

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Project + rope. x (B, T, D) -> q (B,T,KV,G,dh), k/v (B,T,KV,dh)."""
        cfg = self.cfg
        q, k, v = linears(x, (self.wq, self.wk, self.wv))  # (B, T, H | KV, dh)
        q = rope(q, positions, self.freq)
        k = rope(k, positions, self.freq)
        q = q * scalar(cfg.head_dim ** -0.5, q.dtype)
        b, t = x.shape[0], x.shape[1]
        q = q.reshape(b, t, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
        return q, k, v

    def _out_proj(self, o: torch.Tensor) -> torch.Tensor:
        b, t = o.shape[:2]
        return self.wo(o.reshape(b, t, self.cfg.n_heads * self.cfg.head_dim))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, window: int | None,
                kv_chunk: int = 512):
        """Causal (optionally windowed) attention over KV chunks.

        x (B, T, D), positions (B, T) or (T,).  Returns (out (B, T, D),
        (k, v) (B, T, KV, dh) each, the prompt's KV for prefill)."""
        cfg = self.cfg
        b, t, _ = x.shape
        kv_g, g, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
        q, k, v = self._qkv(x, positions)
        kk, vv = k, v
        if self.shard is not None:  # the whole sequence's K/V for this block's queries
            kk, vv = self.shard.seq.all_gather(k, 1), self.shard.seq.all_gather(v, 1)
        tk = kk.shape[1]
        chunk = min(kv_chunk, tk)
        while tk % chunk:
            chunk //= 2
        qpos = positions if positions.dim() == 2 else positions[None].expand(b, t)
        qp = qpos[:, None, None, :, None]  # (B, 1, 1, T, 1)
        qf = q.float()
        m = torch.full((b, kv_g, g, t), NEG_INF, dtype=torch.float32, device=x.device)
        l = torch.zeros((b, kv_g, g, t), dtype=torch.float32, device=x.device)
        o = torch.zeros((b, t, kv_g, g, dh), dtype=torch.float32, device=x.device)
        for base in range(0, tk, chunk):
            kci, vci = kk[:, base:base + chunk], vv[:, base:base + chunk]
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
        cpos = cache["pos"]
        quantized = "k_q" in cache
        length = cpos.shape[0]
        sh = self.shard
        if sh is None:
            slot = pos % length if window is not None else pos
        else:  # the cache's global slot, then this rank's block of it (or none)
            slot = pos % window if window is not None else pos
            slot = slot - sh.cache.index * length
            slot = slot if 0 <= slot < length else None
        if slot is not None:
            cpos[slot] = pos
            if quantized:
                for name, new in (("k", k_new), ("v", v_new)):
                    cache[name + "_q"][:, slot], cache[name + "_s"][:, slot] = quant_kv(new[:, 0])
            else:
                cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
                cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        if quantized:
            dt = x.dtype
            k = cache["k_q"].to(dt) * cache["k_s"][..., None].to(dt)
            v = cache["v_q"].to(dt) * cache["v_s"][..., None].to(dt)
        else:
            k, v = cache["k"], cache["v"]
        s = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float())  # (B,KV,G,1,S) f32
        valid = (cpos >= 0) & (cpos <= pos)
        if window is not None:
            valid = valid & ((pos - cpos) < window)
        s = torch.where(valid, s, NEG_INF)
        pv = torch.promote_types(x.dtype, v.dtype)
        if sh is None:
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgts,bskd->btkgd", p.to(x.dtype).to(pv), v.to(pv))
        else:  # flash-decode over the split cache: every rank's (max, sum of exp), then PV
            m = s.amax(dim=-1, keepdim=True)  # (B, KV, G, 1, 1)
            ml = sh.cache.all_gather(torch.cat([m, torch.exp(s - m).sum(dim=-1, keepdim=True)],
                                               dim=-1)[None], 0)
            m = ml[..., :1].amax(dim=0)
            l = (ml[..., 1:] * torch.exp(ml[..., :1] - m)).sum(dim=0)
            p = (torch.exp(s - m) / l).to(x.dtype)
            o = sh.cache.all_reduce(torch.einsum("bkgts,bskd->btkgd", p.float(),
                                                 v.float())).to(pv)
        o = o.reshape(b, 1, cfg.n_heads, cfg.head_dim)
        return self._out_proj(o), cache


def kv_cache_quantized() -> bool:
    """The int8 KV cache switch, ``REPRO_KV_INT8=1``, read when a cache is
    made (the reference's name and reading)."""
    return os.environ.get("REPRO_KV_INT8", "0") == "1"


def quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., dh) -> (int8 codes, float32 scales (...)): ``scale = max |x|
    / 127`` over dh, codes ``round(x / max(scale, 1e-9))`` clipped to
    +-127 (the reference's ``_quant_kv``; its eps is 1e-9, the weights'
    1e-12)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0)  # a true division on the card too
    q = torch.round(xf / torch.clamp_min(scale[..., None], 1e-9))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def make_cache(cfg: ModelConfig, batch: int, length: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """KV cache for one attention layer: ``k`` / ``v`` (B, length, KV, dh)
    zeros in ``dtype`` and ``pos`` (length,) int32, each slot's absolute
    position (-1: empty).  With ``REPRO_KV_INT8=1`` (``dtype`` unused):
    int8 ``k_q`` / ``v_q`` (B, length, KV, dh) and float32 ``k_s`` /
    ``v_s`` (B, length, KV) zeros beside ``pos``."""
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    if kv_cache_quantized():
        codes = dict(dtype=torch.int8, device=device)
        scales = dict(dtype=torch.float32, device=device)
        return {"k_q": torch.zeros((batch, length, kv, dh), **codes),
                "k_s": torch.zeros((batch, length, kv), **scales),
                "v_q": torch.zeros((batch, length, kv, dh), **codes),
                "v_s": torch.zeros((batch, length, kv), **scales),
                "pos": torch.full((length,), -1, dtype=torch.int32, device=device)}
    return {
        "k": torch.zeros((batch, length, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, kv, dh), dtype=dtype, device=device),
        "pos": torch.full((length,), -1, dtype=torch.int32, device=device),
    }
