"""Model assembly: embed, the layer stack, prefill, decode and the loss.

Port of ``repro.models.transformer``'s inference half for every layer
kind: ``"attn"`` (attention + gated FFN, global or sliding-window),
``"moe"`` (attention + mixture-of-experts FFN), ``"rglru"`` (the RG-LRU
block + gated FFN), ``"mlstm"`` and ``"slstm"`` (the xLSTM blocks, which
carry their own projections and have no second norm), one layer class a
kind as ``apply_layer_train`` / ``apply_layer_decode`` lay them out.  The
reference groups layers into stacked pattern units under ``lax.scan``
with rematerialisation; here the layers are an ``nn.ModuleList`` in
layer order, run eagerly — no scan, no sharding layout (one device).
Prefill and decode run under ``torch.inference_mode``; ``forward_train``
runs with autograd, each pattern unit (not the leftover layers) under
``torch.utils.checkpoint`` as the reference rematerialises its scan body
(``REPRO_REMAT=dots``: a selective policy that saves the products
without batch dimensions, the reference's
``dots_with_no_batch_dims_saveable``), and returns the summed MoE aux
terms (``moe_aux + moe_zloss`` a layer).  ``chunked_xent`` streams the
cross-entropy over vocabulary chunks of 32,768 (the last one padded with
-1e30 logits), so full float32 logits never exist; ``lm_loss`` adds the
aux terms and gives a vision prefix targets of -1.

Dtypes follow the reference: the weights are float32 masters, cast at
every use to the activation dtype (``cfg.dtype``); the embedding is
scaled by ``sqrt(d_model)`` rounded to that dtype first (50.5, not
50.596, for d_model 2560 in bf16); logits come out in float32.  In a
bf16 full-sequence forward every layer runs on its masters rounded to
bf16 first, as the reference casts the layer stack early
(``REPRO_CAST_EARLY``, on by default): the weights consumed in float32
(the RG-LRU's ``lam`` and gate linears, the xLSTM gates and sLSTM
recurrent matrices, the MoE router, the norms' scales) are then the
bf16-rounded masters, which changes their numbers; decode reads the
float32 masters.  A decode step whose caches are wider than the
activations (the reference's ``generate`` uses float32 caches) promotes
the residual stream to the wider dtype from the first attention layer's
output on, exactly as the reference does.

Under an executed serving layout (``distributed.sharding.Shard``, on a
live (``data``, ``model``) or (``pod``, ``data``, ``model``) mesh, one
process a rank):

* ``decode`` and ``long``: a ``Transformer`` holding the rank's
  ``param_pspec`` blocks (``models.convert.shard_model`` or
  ``models.zoo.init_params(..., layout=)``) runs ``forward_decode`` on
  its rows (``act_batch``) with the residual stream as its d_model
  block: the embedding lookup gives the block, the norms reduce their
  sums of squares, the products that contract d_model reduce their
  float32 partials (``layers.Linear``), those that produce d_model give
  the block, the logits are the partial products against the table's
  block summed over ``model`` (float32, equal on every ``model`` rank);
  ``init_caches`` makes the rank's blocks of the caches
  (``serve.decode.cache_pspecs``: KV over ``cache_seq``, padded to the
  ceiling block with empty slots; recurrent states over the rows);
* ``prefill``: ``StoredParams`` holds the rank's ZeRO block
  (``store_pspec``) of every reference leaf and ``forward_prefill``
  gathers one layer's compute parameters at a time (one all-gather over
  the world), runs it on the rank's rows and sequence block
  (``act_batch``, ``act_seq``) and frees it; the embedding table is
  gathered for the lookup and again for the logits.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Layout, NamedSharding, Shard, _entry_axes
from repro_torch.models.attention import Attention, make_cache
from repro_torch.models.layers import (FFN, Linear, RMSNorm, gathered_scales, normal_init,
                                       rms_norm, scalar)
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU, make_rglru_state
from repro_torch.models.xlstm import MLSTM, SLSTM, make_mlstm_state, make_slstm_state


class AttnLayer(nn.Module):
    """An ``"attn"`` or ``"moe"`` layer: pre-norm attention, then a
    pre-norm gated FFN (``ffn``; none when d_ff is 0) or mixture of
    experts (``moe``: per sequence in the full forward, the whole batch
    in decode), each added to the residual stream."""

    def __init__(self, cfg: ModelConfig, kind: str, window: int | None, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cfg, self.window = cfg, window
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, **kw)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.moe = MoE(cfg, **kw) if kind == "moe" else None
        self.ffn = (FFN(cfg.d_model, cfg.d_ff, cfg.act, **kw) if kind == "attn" and cfg.d_ff
                    else None)

    def _mlp(self, x: torch.Tensor, group_by_batch: bool):
        """(x + the FFN or MoE of norm2(x), the MoE's aux terms summed or None)."""
        if self.moe is not None:
            out, aux = self.moe(self.norm2(x), group_by_batch=group_by_batch)
            return x + out, aux["moe_aux"] + aux["moe_zloss"]
        if self.ffn is None:  # the reference adds zeros
            return x, None
        return x + self.ffn(self.norm2(x)), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Returns (x, this layer's (k, v), the MoE aux terms or None)."""
        h, kv = self.attn(self.norm1(x), positions, window=self.window)
        x, aux = self._mlp(x + h, False)
        return x, kv, aux

    def decode(self, x: torch.Tensor, cache: dict, pos: int):
        h, cache = self.attn.decode(self.norm1(x), cache, pos, window=self.window)
        return self._mlp(x + h, True)[0], cache

    def make_cache(self, batch: int, max_len: int, dtype, device) -> dict:
        """A windowed layer's ring holds min(window, max_len) slots, a
        global layer's max_len; under a layout, this rank's ceiling
        block of them."""
        length = min(self.window, max_len) if self.window else max_len
        if self.attn.shard is not None:
            length = -(-length // self.attn.shard.cache.size)
        return make_cache(self.cfg, batch, length, dtype, device)


class RGLRULayer(nn.Module):
    """An ``"rglru"`` layer: pre-norm RG-LRU block, then pre-norm gated FFN."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.rglru = RGLRU(cfg, **kw)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.act, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        x = x + self.rglru(self.norm1(x))
        return x + self.ffn(self.norm2(x)), None, None

    def decode(self, x: torch.Tensor, state: dict, pos: int):
        h, state = self.rglru.decode(self.norm1(x), state)
        x = x + h
        return x + self.ffn(self.norm2(x)), state

    def make_cache(self, batch: int, max_len: int, dtype, device) -> dict:
        return make_rglru_state(self.cfg, batch, dtype, device)


class XLSTMLayer(nn.Module):
    """An ``"mlstm"`` or ``"slstm"`` layer: the pre-norm block added to the
    residual stream (the block carries its own projections and FFN)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        block = (MLSTM if kind == "mlstm" else SLSTM)(cfg, generator=generator, device=device)
        setattr(self, kind, block)  # the reference's tree key: "mlstm" / "slstm"
        self.shard = None  # a Shard under the executed prefill layout

    @property
    def block(self) -> nn.Module:
        return getattr(self, self.kind)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        if self.shard is None:
            return x + self.block(self.norm1(x)), None, None
        # prefill: the block runs over the whole gathered sequence, and the
        # rank keeps its sequence block of the output
        seq = self.shard.seq
        out = self.block(seq.all_gather(self.norm1(x), 1))
        return x + out[:, seq.block(out.shape[1])], None, None

    def decode(self, x: torch.Tensor, state: dict, pos: int):
        h, state = self.block.decode(self.norm1(x), state)
        return x + h, state

    def make_cache(self, batch: int, max_len: int, dtype, device) -> dict:
        if self.kind == "mlstm":
            return make_mlstm_state(self.cfg, batch, dtype, device)
        return make_slstm_state(self.cfg, batch, device)


def make_layer(cfg: ModelConfig, kind: str, window: int | None, *,
               generator: torch.Generator | None = None, device=None) -> nn.Module:
    """The layer of ``kind`` (the reference's ``init_layer``)."""
    kw = dict(generator=generator, device=device)
    if kind in ("attn", "moe"):
        return AttnLayer(cfg, kind, window, **kw)
    if kind == "rglru":
        return RGLRULayer(cfg, **kw)
    if kind in ("mlstm", "slstm"):
        return XLSTMLayer(cfg, kind, **kw)
    raise ValueError(f"layer kind {kind!r}")


def rounded_params(layer: nn.Module, dtype: torch.dtype) -> dict:
    """The layer's float32 masters (and w8a16 scales) rounded to ``dtype``,
    by name, the int8 codes as they are (the reference's early cast of the
    layer stack: every float32 leaf).  Differentiable: the gradient flows
    back to the masters."""
    return {name: t.to(dtype) if t.dtype == torch.float32 else t
            for name, t in layer.state_dict(keep_vars=True).items()}


def _dots_saveable(ctx, op, *args, **kwargs):
    """``REPRO_REMAT=dots``: keep the products without batch dimensions
    (``aten.mm``: the linears), recompute everything else — the
    reference's ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class Transformer(nn.Module):
    """The decoder-only LM of ``cfg``.

    ``embed`` (V, D) float32 N(0, 1/D), ``final_norm``, ``unembed`` (D, V)
    unless the embeddings are tied, and ``layers`` in layer order.
    Weights are drawn from ``generator`` on ``device`` (``None``: the
    card), in an order of this port's own — not the reference's PRNG
    stream; ``models.convert.params_from_reference`` carries reference
    weights over.  With ``generator=None`` the storage is left
    uninitialised for such a loader; ``device="meta"`` (no generator)
    builds the shapes alone, so a full-width model is counted without
    its storage."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        meta = device is not None and torch.device(device).type == "meta"
        device = torch.device("meta") if meta else resolve_device(device)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(normal_init((v, d), 1.0 / math.sqrt(d), generator, device),
                                  requires_grad=False)
        self.final_norm = RMSNorm(d, cfg.norm_eps, device=device)
        self.unembed = (None if cfg.tie_embeddings else nn.Parameter(
            normal_init((d, v), 1.0 / math.sqrt(d), generator, device), requires_grad=False))
        self.layers = nn.ModuleList(
            make_layer(cfg, kind, w, generator=generator, device=device)
            for kind, w in zip(cfg.layer_kinds, cfg.layer_windows))
        self.shard = None  # a Shard when the model holds a rank's blocks (decode, long)
        self.scale_rows: dict = {}  # layer index -> its Linears holding scale rows (w8a16, mesh)

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
        out = torch.matmul(x.float(), w.float())
        return out if self.shard is None else self.shard.embed.all_reduce(out)

    def _run_layer(self, layer: nn.Module, x: torch.Tensor, positions: torch.Tensor):
        """One layer: in bf16 on its masters rounded to bf16 (the reference's
        ``REPRO_CAST_EARLY``), else on the masters.  Returns (x, kv, aux)."""
        if self.dtype == torch.float32:
            return layer(x, positions)
        return torch.func.functional_call(layer, rounded_params(layer, self.dtype), (x, positions))

    def _run_unit(self, layers, x: torch.Tensor, positions: torch.Tensor, kvs: list | None):
        """Layers in order: (x, their aux terms summed in float32 from 0, as
        the reference's scan body sums them); each attention layer's
        (k, v) appended to ``kvs`` when given."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in layers:
            x, kv, a = self._run_layer(layer, x, positions)
            if a is not None:
                aux = aux + a
            if kvs is not None and kv is not None:
                kvs.append(kv)
        return x, aux

    def _run_stack(self, x: torch.Tensor, positions: torch.Tensor, *, kvs: list | None = None,
                   remat: bool = False):
        """The pattern units, each under ``torch.utils.checkpoint`` when
        ``remat`` (the rounding to bf16 inside it, so no bf16 copy of the
        stack is held for the backward), then the leftover layers.  Returns
        (x, the aux terms: the units' sum, then each leftover's added)."""
        n_unit = len(self.cfg.pattern_unit)
        n_stacked = self.cfg.n_units * n_unit
        units = [self.layers[u * n_unit:(u + 1) * n_unit] for u in range(self.cfg.n_units)]
        run = functools.partial(self._run_unit, positions=positions, kvs=kvs)
        if remat:
            kw = {"use_reentrant": False}
            if os.environ.get("REPRO_REMAT", "full") == "dots":
                kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                     _dots_saveable)
            run = functools.partial(checkpoint, self._run_unit, positions=positions, kvs=None, **kw)
        auxs = []
        for layers in units:
            x, a = run(layers, x)
            auxs.append(a)
        aux = (torch.stack(auxs).sum() if auxs
               else torch.zeros((), dtype=torch.float32, device=x.device))
        for layer in self.layers[n_stacked:]:
            x, a = self._run_unit([layer], x, positions, kvs)
            aux = aux + a
        return x, aux

    def _positions(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        return torch.arange(t, dtype=torch.int64, device=x.device)[None].expand(b, t)

    def _prefixed(self, x: torch.Tensor, prefix_embeds: torch.Tensor | None) -> torch.Tensor:
        if self.cfg.frontend == "vision_stub" and prefix_embeds is not None:
            return torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        return x

    @torch.inference_mode()
    def forward_hidden(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None,
                       *, collect_kv: bool = False):
        """Full-sequence forward (the reference's ``forward_train`` without
        the loss): returns (final-normed hidden (B, T, D), the attention
        layers' (k, v) in layer order, or None).  ``prefix_embeds``
        (B, P, D) is prepended for the vision-stub frontend.  In bf16 each
        layer runs on its masters rounded to bf16, as the reference's
        default ``REPRO_CAST_EARLY`` runs it."""
        x = self._prefixed(self.embed_tokens(tokens), prefix_embeds)
        kvs = [] if collect_kv else None
        x, _ = self._run_stack(x, self._positions(x), kvs=kvs)
        return rms_norm(x, self.final_norm.scale, self.cfg.norm_eps), kvs

    def forward_train(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None,
                      *, remat: bool = True):
        """The reference's ``forward_train`` with autograd: returns
        (final-normed hidden (B, T, D), the MoE aux terms summed, float32).
        Each pattern unit is rematerialised when ``remat`` (the backward
        recomputes it; ``REPRO_REMAT=dots`` keeps its linears' products),
        which changes memory, not numbers.  The embedding table is cast to
        the model dtype before the gather, the reference's order, so its
        gradient is summed in that dtype as the reference's is."""
        dt = self.dtype
        x = self.embed.to(dt)[tokens] * scalar(math.sqrt(self.cfg.d_model), dt)
        x = self._prefixed(x, prefix_embeds)
        x, aux = self._run_stack(x, self._positions(x), remat=remat)
        return rms_norm(x, self.final_norm.scale, self.cfg.norm_eps), aux

    @torch.inference_mode()
    def forward_prefill(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None):
        """Returns (last-token logits (B, 1, V) float32, one (k, v) an
        attention layer (kinds ``attn`` and ``moe``) in layer order, each
        (B, T, KV, dh) in the model dtype; the recurrent layers' states are
        not returned, as the reference's ``collect_kv`` returns none)."""
        hidden, kvs = self.forward_hidden(tokens, prefix_embeds, collect_kv=True)
        return self.logits(hidden[:, -1:, :]), kvs

    def rows(self, batch: int) -> int:
        """This rank's rows of a batch of ``batch`` (all of it on one device)."""
        if self.shard is None:
            return batch
        if batch % self.shard.batch.size:
            raise ValueError(f"a batch of {batch} does not split over {self.shard.batch.size} "
                             "ranks of act_batch")
        return batch // self.shard.batch.size

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16) -> list:
        """Per-layer decode caches, one a layer: KV rings for attention
        layers (a windowed layer's holds min(window, max_len) slots, a
        global layer's max_len), recurrent states (dicts of float32
        tensors, the conv histories in ``dtype``) for the others.  A
        rank's model makes the rank's blocks of a ``batch``-row cache."""
        b = self.rows(batch)
        return [layer.make_cache(b, max_len, dtype, self.device) for layer in self.layers]

    @torch.inference_mode()
    def forward_decode(self, tokens: torch.Tensor, caches: list, pos: int):
        """One decode step. tokens (B, 1) at absolute position ``pos`` (a
        rank's model: its rows).  Returns (logits (B, 1, V) float32,
        caches), the caches updated in place."""
        x = self.embed_tokens(tokens)
        for i, (layer, cache) in enumerate(zip(self.layers, caches)):
            if i in self.scale_rows:  # w8a16 on a mesh: the layer's stacked scales' rows
                with gathered_scales(self.scale_rows[i]):
                    x, _ = layer.decode(x, cache, pos)
            else:
                x, _ = layer.decode(x, cache, pos)
        return self.logits(self.final_norm(x)), caches


def leaf_path(cfg: ModelConfig, name: str) -> tuple[str, int | None]:
    """(the reference leaf path, the unit index or None) of a parameter
    named ``name`` in a ``Transformer`` (``layers.<i>.<module path>``, or
    a top-level name)."""
    if not name.startswith("layers."):
        return name.replace(".", "/"), None
    _, i, rest = name.split(".", 2)
    i, n_unit = int(i), len(cfg.pattern_unit)
    rest = rest.replace(".", "/")
    if i < cfg.n_units * n_unit:
        u, pos = divmod(i, n_unit)
        return f"units/{pos}/{rest}", u
    return f"leftover/{i - cfg.n_units * n_unit}/{rest}", None


@dataclasses.dataclass
class StoredParams:
    """A rank's parameters under the executed ``prefill`` layout: its ZeRO
    block (``store_pspec``) of every reference leaf, ``blocks`` by leaf
    path (``models.convert.reference_leaves``' names), with each leaf's
    full ``shapes`` and storage ``specs``; ``shard`` the layout's
    ``Shard``.  Made by ``models.convert.shard_model`` or
    ``models.zoo.init_params(..., layout=)``.  ``gathered_bytes`` counts
    the bytes the gathers have landed on this rank."""

    cfg: ModelConfig
    layout: Layout
    shard: Shard
    blocks: dict
    shapes: dict
    specs: dict
    gathered_bytes: int = 0

    @property
    def device(self) -> torch.device:
        return next(iter(self.blocks.values())).device

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32

    def _gather(self, want: list) -> list:
        """The whole value of each (leaf path, unit index or None) of
        ``want`` (a unit leaf's layer at that index): every rank's pieces
        in one all-gather over the world a dtype (a piece is a block's
        slice at the unit, zeros where the block holds other units), each
        value put together from its blocks by one permute (``_assemble``)."""
        mesh = self.layout.mesh
        world = math.prod(mesh.shape)
        shards = [NamedSharding(mesh, self.specs[path]) for path, _ in want]
        pieces = []
        for (path, u), sh in zip(want, shards):
            b = self.blocks[path]
            if u is not None:
                units = sh.block(self.shapes[path], mesh.rank)[0]
                b = b[u - units.start] if units.start <= u < units.stop else b.new_zeros(b.shape[1:])
            pieces.append(b)
        whole = [None] * len(want)
        by_dtype: dict = {}  # one all-gather a dtype (w8a16: the codes apart)
        for j, p in enumerate(pieces):
            by_dtype.setdefault(p.dtype, []).append(j)
        for js in by_dtype.values():
            local = torch.cat([pieces[j].reshape(-1) for j in js])
            out = local.new_empty((world, local.numel()))
            dist.all_gather(list(out.unbind(0)), local)
            self.gathered_bytes += out.numel() * out.element_size()
            off = 0
            for j in js:
                (path, u), n = want[j], pieces[j].numel()
                whole[j] = self._assemble(out[:, off:off + n].reshape(world, *pieces[j].shape),
                                          self.specs[path], self.shapes[path], u)
                off += n
        return whole

    def _assemble(self, parts: torch.Tensor, spec, shape: tuple, u: int | None) -> torch.Tensor:
        """A leaf of ``shape`` under ``spec`` (its layer ``u``'s slice of a
        unit leaf) from every rank's piece, ``parts`` (world, *piece), in
        rank order: the mesh axes the spec leaves out replicate a block (the
        first copy is taken), the unit's holders are those whose block of
        the units holds ``u``, and each dimension's blocks are laid side by
        side in its axes' order.  A storage spec splits every dimension
        evenly, so the blocks tile the leaf."""
        names, sizes = tuple(self.layout.mesh.axis_names), tuple(self.layout.mesh.shape)
        size = dict(zip(names, sizes))
        entries = [_entry_axes(e) for e in spec] + [()] * (len(shape) - len(spec))
        fixed: dict = {}
        if u is not None:  # the coordinates of the ranks holding unit u
            idx = u // (shape[0] // math.prod(size[a] for a in entries[0]))
            for a in reversed(entries[0]):
                fixed[a], idx = idx % size[a], idx // size[a]
            entries, shape = entries[1:], shape[1:]
        named = {a for axes in entries for a in axes}
        g = parts.reshape(*sizes, *parts.shape[1:])
        g = g[tuple(slice(None) if a in named else fixed.get(a, 0) for a in names)]
        kept = [a for a in names if a in named]
        order = []
        for d, axes in enumerate(entries):
            order += [kept.index(a) for a in axes] + [len(kept) + d]
        return g.permute(order).reshape(shape)

    def _layer(self, i: int) -> nn.Module:
        """Layer i with its compute parameters gathered whole, but for the
        experts (the rank's block: ``experts`` on ``model``), and the
        layout's ``Shard`` set on the modules that execute it; a w8a16
        linear's codes and scales gathered as stored."""
        cfg, sh = self.cfg, self.shard
        layer = make_layer(cfg, cfg.layer_kinds[i], cfg.layer_windows[i], device=self.device)
        for name, m in layer.named_modules():  # w8a16: the stored leaves are codes and scales
            if isinstance(m, Linear) and f"{leaf_path(cfg, f'layers.{i}.{name}')[0]}/w_q" in self.shapes:
                m.set_w8a16(m.w.new_empty(0, dtype=torch.int8), m.w.new_empty(0))
        params = layer.state_dict(keep_vars=True)
        whole = self._gather([leaf_path(cfg, f"layers.{i}.{name}") for name in params])
        experts = sh.experts.block(cfg.n_experts) if cfg.n_experts else None
        for (name, p), w in zip(params.items(), whole):
            if name.split(".")[-1] in ("w_gate", "w_up", "w_down") and name.startswith("moe."):
                w = w[experts].clone()
            p.data = w
        for m in layer.modules():
            if hasattr(m, "shard"):
                m.shard = sh
        return layer

    @torch.inference_mode()
    def forward_prefill(self, tokens: torch.Tensor, prefix_embeds: torch.Tensor | None = None):
        """The prefill of the whole batch's ``tokens`` (B, T) (and
        ``prefix_embeds`` (B, P, D), sharded as the tokens are) on this
        rank's rows and sequence block.  Returns (the last position's
        logits (B_local, 1, V) float32, equal on every ``model`` rank; one
        (k, v) an attention layer, each the rank's (B_local, T block, KV,
        dh) block)."""
        cfg, sh, dt = self.cfg, self.shard, self.dtype
        b = tokens.shape[0]
        if b % sh.batch.size:
            raise ValueError(f"a batch of {b} does not split over {sh.batch.size} ranks")
        rows = sh.batch.block(b)
        (table,) = self._gather([("embed", None)])
        x = table[tokens[rows]].to(dt) * scalar(math.sqrt(cfg.d_model), dt)
        del table
        if cfg.frontend == "vision_stub" and prefix_embeds is not None:
            x = torch.cat([prefix_embeds[rows].to(dt), x], dim=1)
        t = x.shape[1]
        if t % sh.seq.size:
            raise ValueError(f"a sequence of {t} does not split over {sh.seq.size} ranks")
        seq = sh.seq.block(t)
        x = x[:, seq].contiguous()
        positions = torch.arange(seq.start, seq.stop, device=x.device)[None].expand(x.shape[0], -1)
        kvs = []
        for i in range(cfg.n_layers):
            layer = self._layer(i)
            if dt == torch.float32:
                x, kv, _ = layer(x, positions)
            else:
                x, kv, _ = torch.func.functional_call(layer, rounded_params(layer, dt),
                                                      (x, positions))
            if kv is not None:
                kvs.append(kv)
            del layer
        # the last position lives on the sequence's last rank: its value
        # plus the others' zeros, exactly
        last = x[:, -1:].float() if seq.stop == t else x.new_zeros((x.shape[0], 1, x.shape[2]),
                                                                   dtype=torch.float32)
        last = sh.seq.all_reduce(last).to(x.dtype)
        top = "embed" if cfg.tie_embeddings else "unembed"
        scale, w = self._gather([("final_norm/scale", None), (top, None)])
        hidden = rms_norm(last, scale, cfg.norm_eps)
        w = (w.T if cfg.tie_embeddings else w).to(dt)
        return torch.matmul(hidden.float(), w.float()), kvs


def chunked_xent(hidden: torch.Tensor, w_unembed: torch.Tensor, targets: torch.Tensor, *,
                 chunk_v: int = 32_768, ignore_id: int = -1):
    """Streaming cross-entropy over vocabulary chunks (no full float32
    logits), the reference's: hidden (B, T, D), w_unembed (D, V), targets
    (B, T) -> (loss_sum, n_valid).  Each chunk's logits are the product of
    hidden and the chunk's columns cast to hidden's dtype, in float32 (exact
    products, float32 sums); the last chunk is padded to ``chunk_v`` with
    -1e30 logits; a running max, sum of exponentials and the target's logit
    are carried across chunks."""
    b, t, _ = hidden.shape
    v = w_unembed.shape[1]
    chunk_v = min(chunk_v, v)
    hf = hidden.float()
    m = torch.full((b, t), -1e30, dtype=torch.float32, device=hidden.device)
    s = torch.zeros((b, t), dtype=torch.float32, device=hidden.device)
    tgt = torch.zeros((b, t), dtype=torch.float32, device=hidden.device)
    for base in range(0, v, chunk_v):
        wc = w_unembed[:, base:base + chunk_v].to(hidden.dtype).float()
        logits = torch.matmul(hf, wc)  # (B, T, <= chunk_v) float32
        if logits.shape[-1] < chunk_v:
            logits = F.pad(logits, (0, chunk_v - logits.shape[-1]), value=-1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(dim=-1)
        local = targets.long() - base
        hit = (local >= 0) & (local < chunk_v)
        got = torch.gather(logits, -1, local.clamp(0, chunk_v - 1)[..., None])[..., 0]
        tgt = torch.where(hit, got, tgt)
        m = m_new
    nll = m + torch.log(torch.clamp_min(s, 1e-30)) - tgt
    valid = targets != ignore_id
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def lm_loss(model: Transformer, batch: dict, *, remat: bool = True) -> torch.Tensor:
    """Mean next-token NLL plus the MoE aux terms (the reference's
    ``lm_loss``): ``batch`` holds tensors ``tokens`` and ``targets``
    (B, T) and, for the vision stub, ``prefix_embeds`` (B, P, D), whose
    positions get target -1 (no loss)."""
    prefix = batch.get("prefix_embeds")
    hidden, aux = model.forward_train(batch["tokens"], prefix, remat=remat)
    targets = batch["targets"]
    if model.cfg.frontend == "vision_stub" and prefix is not None:
        pad = torch.full(prefix.shape[:2], -1, dtype=targets.dtype, device=targets.device)
        targets = torch.cat([pad, targets], dim=1)
    loss_sum, n_valid = chunked_xent(hidden, model.unembed_matrix(), targets)
    return loss_sum / torch.clamp_min(n_valid, 1) + aux
