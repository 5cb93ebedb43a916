"""Model assembly for inference: embed, the layer stack, prefill and decode.

Port of ``repro.models.transformer``'s inference half for layer kind
``"attn"`` (dense attention + gated FFN, global or sliding-window).  The
reference groups layers into stacked pattern units under ``lax.scan``
with rematerialisation; here the layers are an ``nn.ModuleList`` in
layer order and every forward runs eagerly under
``torch.inference_mode`` — no scan, no remat, no sharding layout (one
device).  The other layer kinds (``moe``, ``rglru``, ``mlstm``,
``slstm``) raise ``NotImplementedError``: they are later items of the
port's roadmap, as are training and the loss.

Dtypes follow the reference: the weights are float32 masters, cast at
every use to the activation dtype (``cfg.dtype``); the embedding is
scaled by ``sqrt(d_model)`` rounded to that dtype first (50.5, not
50.596, for d_model 2560 in bf16); logits come out in float32.  A
decode step whose caches are wider than the activations (the reference's
``generate`` uses float32 caches) promotes the residual stream to the
wider dtype from the first layer's attention output on, exactly as the
reference does.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, make_cache
from repro_torch.models.layers import FFN, RMSNorm, normal_init, rms_norm, scalar

UNPORTED_KINDS = ("moe", "rglru", "mlstm", "slstm")


class Layer(nn.Module):
    """One ``"attn"`` layer: pre-norm attention and pre-norm gated FFN,
    each added to the residual stream."""

    def __init__(self, cfg: ModelConfig, window: int | None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.window = window
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, **kw)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.act, **kw) if cfg.d_ff else None

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        if self.ffn is None:  # the reference adds zeros
            return x
        return x + self.ffn(self.norm2(x))

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        h, kv = self.attn(self.norm1(x), positions, window=self.window)
        return self._ffn(x + h), kv

    def decode(self, x: torch.Tensor, cache: dict, pos: int):
        h, cache = self.attn.decode(self.norm1(x), cache, pos, window=self.window)
        return self._ffn(x + h), cache


class Transformer(nn.Module):
    """The decoder-only LM of ``cfg`` (attention-only configs).

    ``embed`` (V, D) float32 N(0, 1/D), ``final_norm``, ``unembed`` (D, V)
    unless the embeddings are tied, and ``layers`` in layer order.
    Weights are drawn from ``generator`` on ``device`` (``None``: the
    card), in an order of this port's own — not the reference's PRNG
    stream; ``models.convert.params_from_reference`` carries reference
    weights over.  With ``generator=None`` the storage is left
    uninitialised for such a loader."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        missing = sorted(set(cfg.layer_kinds) & set(UNPORTED_KINDS))
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: layer kinds {missing} are not ported yet (ROADMAP.md, Queue 1 "
                "item 10a: moe.py / rglru.py / xlstm.py); only 'attn' layers run in repro_torch")
        device = resolve_device(device)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(normal_init((v, d), 1.0 / math.sqrt(d), generator, device),
                                  requires_grad=False)
        self.final_norm = RMSNorm(d, cfg.norm_eps, device=device)
        self.unembed = (None if cfg.tie_embeddings else nn.Parameter(
            normal_init((d, v), 1.0 / math.sqrt(d), generator, device), requires_grad=False))
        self.layers = nn.ModuleList(
            Layer(cfg, w, generator=generator, device=device) for w in cfg.layer_windows)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        """The activations' dtype, ``cfg.dtype``."""
        return torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32

    def unembed_matrix(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed  # (D, V)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embedding scaled by sqrt(d_model) rounded to the dtype."""
        dt = self.dtype
        # the cast after the gather: the same numbers as the reference's
        # cast-then-gather, without casting the whole table
        return self.embed[tokens].to(dt) * scalar(math.sqrt(self.cfg.d_model), dt)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 logits of hidden states x (B, T, D): the unembedding
        cast to the model dtype, the product in x's (promoted) dtype with
        float32 output, as the reference's ``preferred_element_type``."""
        w = self.unembed_matrix().to(self.dtype)
        return torch.matmul(x.float(), w.float())

    @torch.inference_mode()
    def forward_hidden(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None,
                       *, collect_kv: bool = False):
        """Full-sequence forward (the reference's ``forward_train`` without
        the loss): returns (final-normed hidden (B, T, D), per-layer (k, v)
        list or None).  ``prefix_embeds`` (B, P, D) is prepended for the
        vision-stub frontend."""
        x = self.embed_tokens(tokens)
        if self.cfg.frontend == "vision_stub" and prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        b, t = x.shape[:2]
        positions = torch.arange(t, dtype=torch.int64, device=x.device)[None].expand(b, t)
        kvs = []
        for layer in self.layers:
            x, kv = layer(x, positions)
            if collect_kv:
                kvs.append(kv)
        return rms_norm(x, self.final_norm.scale, self.cfg.norm_eps), (kvs if collect_kv else None)

    @torch.inference_mode()
    def forward_prefill(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None):
        """Returns (last-token logits (B, 1, V) float32, one (k, v) a layer
        in layer order, each (B, T, KV, dh) in the model dtype)."""
        hidden, kvs = self.forward_hidden(tokens, prefix_embeds, collect_kv=True)
        return self.logits(hidden[:, -1:, :]), kvs

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16) -> list:
        """Per-layer decode caches: a windowed layer's holds min(window,
        max_len) slots, a global layer's max_len."""
        return [make_cache(self.cfg, batch, min(w, max_len) if w else max_len, dtype, self.device)
                for w in self.cfg.layer_windows]

    @torch.inference_mode()
    def forward_decode(self, tokens: torch.Tensor, caches: list, pos: int):
        """One decode step. tokens (B, 1) at absolute position ``pos``.
        Returns (logits (B, 1, V) float32, caches), the caches updated in
        place."""
        x = self.embed_tokens(tokens)
        for layer, cache in zip(self.layers, caches):
            x, _ = layer.decode(x, cache, pos)
        return self.logits(rms_norm(x, self.final_norm.scale, self.cfg.norm_eps)), caches

