"""Weight carry-over between the reference's parameter tree and the port's
``Transformer``.

The reference (``repro.models.transformer.init_model``) stacks the layers
of each pattern position: ``params["units"][str(pos)]`` holds arrays with
a leading ``n_units`` axis, layer ``u * len(pattern_unit) + pos`` at index
``u`` (as ``layer_params_for`` reads it), and ``params["leftover"]`` the
``n_layers % len(pattern_unit)`` layers past the last whole unit.  The
port holds one module a layer in layer order.  Both sides are float32
masters, so the carry-over is exact in both directions.

A w8a16 tree (the reference's ``quantize_tree`` with its axes) carries
over both ways too: a linear's ``w_q`` / ``w_s`` leaves become the port
``Linear``'s buffers, stacked as ``(n_units, in, *out)`` and
``(n_units, *out)``.

For training, ``reference_leaves`` lays the model's float32 masters out
as the reference's leaves in place: each unit leaf becomes one stacked
tensor and the layers' parameters views of it, so an optimizer reads and
updates the reference's stacked leaves (Adafactor's update clipping and
the 8-bit moments' blocks span every unit of a leaf) with no copy.

``reference_axes`` gives the logical-axes tree of the reference's
``init_model(...)[1]`` (with ``quantize_axes`` applied to a w8a16 model)
keyed by the same leaf paths, for the sharding plans; it reads shapes
only, so a ``Transformer(cfg, device="meta")`` plans a full-width model
without memory.

The tree is given as numpy arrays (``jax.tree.map(np.asarray, params)``
on the reference's side); this module imports nothing of JAX.

A rank's parameters under an executed serving layout (``shard_model``
from a whole model, ``draw_rank_params`` from the init's generator):
under ``decode`` and ``long`` a ``Transformer`` holding the rank's
``param_pspec`` block of every parameter (the mLSTM's ``norm`` whole: it
is named ``embed`` but spans the 2d inner width, whole on every rank),
its modules told which axes their dimensions split over; under
``prefill`` a ``StoredParams`` holding the rank's ``store_pspec`` block
of every reference leaf.  ``draw_rank_params`` draws each leaf whole
with the one-device init's generator, in its order, keeps the block and
frees the leaf, so a rank's peak is one whole leaf and its values are
one device's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (
    Layout,
    NamedSharding,
    PartitionSpec as P,
    param_pspec,
    shard_of,
    store_pspec,
)
from repro_torch.models.attention import Attention
from repro_torch.models.layers import (Drawing, Linear, RMSNorm, ScaleRows, quantize_model,
                                       quantize_weight, rope_freq)
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import StoredParams, Transformer, leaf_path
from repro_torch.models.xlstm import SLSTM


def _layer_tree(tree: dict, cfg: ModelConfig, i: int) -> dict:
    """Layer i's sub-tree, sliced out of the stacked units or the leftovers."""
    n_unit = len(cfg.pattern_unit)
    if i < cfg.n_units * n_unit:
        u, pos = divmod(i, n_unit)
        return _map(lambda a: a[u], tree["units"][str(pos)])
    return tree["leftover"][i - cfg.n_units * n_unit]


def _map(fn, node):
    if isinstance(node, dict):
        return {k: _map(fn, v) for k, v in node.items()}
    return fn(node)


def _layer_items(layer: torch.nn.Module):
    """(path in the reference's layer tree, the port's tensor) pairs: the
    parameters and the w8a16 buffers.  The port's module and parameter
    names are the reference's keys (``norm1`` / ``attn`` / ``wq`` / ``w``
    or ``w_q`` and ``w_s``, ``moe`` / ``router`` / ``w_gate``, ``rglru`` /
    ``lam``, ``mlstm`` / ``norm`` / ``scale``, ``slstm`` / ``r_i``, ...);
    ``norm2`` exists only in the kinds that have it."""
    return [(tuple(name.split(".")), t) for name, t in layer.state_dict(keep_vars=True).items()]


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _copy(dst: torch.Tensor, src, what: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: reference shape {src.shape}, port shape {tuple(dst.shape)}")
    dst.data.copy_(torch.tensor(src).to(dst.dtype))


def _quantize_like(layer: torch.nn.Module, tree: dict) -> None:
    """Give each ``Linear`` whose reference sub-tree is w8a16 (``w_q``,
    ``w_s``) the buffers of those shapes, to be filled by ``_copy``."""
    for name, m in layer.named_modules():
        sub = _get(tree, tuple(name.split("."))) if name else tree
        if isinstance(m, Linear) and "w_q" in sub:
            m.set_w8a16(torch.empty(np.shape(sub["w_q"]), dtype=torch.int8, device=m.w.device),
                        torch.empty(np.shape(sub["w_s"]), dtype=torch.float32, device=m.w.device))


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> Transformer:
    """The reference's parameter tree (numpy arrays), float32 or w8a16, as
    the port's ``Transformer`` on ``device`` (``None``: the card)."""
    model = Transformer(cfg, generator=None, device=device)
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_norm.scale, tree["final_norm"]["scale"], "final_norm")
    if model.unembed is not None:
        _copy(model.unembed, tree["unembed"], "unembed")
    for i, layer in enumerate(model.layers):
        lt = _layer_tree(tree, cfg, i)
        _quantize_like(layer, lt)
        for path, p in _layer_items(layer):
            _copy(p, _get(lt, path), f"layer {i} {'/'.join(path)}")
    return model


def params_to_reference(model: Transformer) -> dict:
    """The port's weights as the reference's parameter tree (numpy, the
    units stacked), the inverse of ``params_from_reference``."""
    cfg = model.cfg
    n_unit = len(cfg.pattern_unit)

    def host(p):  # a copy: never an alias of a CPU model's storage, which training updates
        return p.detach().to("cpu", copy=True).numpy()

    tree = {"embed": host(model.embed), "final_norm": {"scale": host(model.final_norm.scale)},
            "units": {}, "leftover": []}
    if model.unembed is not None:
        tree["unembed"] = host(model.unembed)
    for pos in range(n_unit if cfg.n_units else 0):
        unit: dict = {}
        layers = [model.layers[u * n_unit + pos] for u in range(cfg.n_units)]
        for path, _ in _layer_items(layers[0]):
            _set(unit, path, np.stack([host(dict(_layer_items(l))[path]) for l in layers]))
        tree["units"][str(pos)] = unit
    for layer in model.layers[cfg.n_units * n_unit:]:
        leaf: dict = {}
        for path, p in _layer_items(layer):
            _set(leaf, path, host(p))
        tree["leftover"].append(leaf)
    return tree


def leaf_params(model: Transformer, *, buffers: bool = False) -> dict[str, list[torch.Tensor]]:
    """Each reference leaf's path (``"embed"``, ``"final_norm/scale"``,
    ``"units/<pos>/attn/wq/w"``, ``"leftover/<i>/norm1/scale"``, ...) and
    the port's parameters it holds — a unit leaf's layers in unit order —
    in the reference's flattening order (JAX's sorted dict keys, list
    entries by index).  With ``buffers``, a w8a16 model's ``w_q`` /
    ``w_s`` too."""
    cfg = model.cfg
    n_unit = len(cfg.pattern_unit)
    named = ((lambda m: m.state_dict(keep_vars=True).items()) if buffers
             else (lambda m: m.named_parameters()))
    out = [(("embed",), [model.embed]), (("final_norm", "scale"), [model.final_norm.scale])]
    if model.unembed is not None:
        out.append((("unembed",), [model.unembed]))
    for pos in range(n_unit if cfg.n_units else 0):
        layers = [dict(named(model.layers[u * n_unit + pos])) for u in range(cfg.n_units)]
        out += [(("units", str(pos), *name.split(".")), [ps[name] for ps in layers])
                for name in layers[0]]
    for i, layer in enumerate(model.layers[cfg.n_units * n_unit:]):
        out += [(("leftover", i, *name.split(".")), [p]) for name, p in named(layer)]
    out.sort(key=lambda kv: kv[0])
    return {"/".join(map(str, path)): ps for path, ps in out}


def reference_leaves(model: Transformer) -> dict[str, torch.Tensor]:
    """The model's float32 masters as the reference's leaves (``leaf_params``'
    paths and order), a unit leaf stacked (n_units, ...).  The first call
    moves each unit leaf's layers into one stacked tensor, one leaf at a
    time, and makes the layers' parameters views of it; every call returns
    those same tensors, so an update written to a leaf is the model's."""
    leaves = model.__dict__.get("_reference_leaves")
    if leaves is None:
        leaves = {}
        with torch.no_grad():
            for path, ps in leaf_params(model).items():
                if path.startswith("units/"):
                    stacked = torch.stack([p.detach() for p in ps])
                    for u, p in enumerate(ps):
                        p.data = stacked[u]
                    leaves[path] = stacked
                else:
                    leaves[path] = ps[0].detach()
        model.__dict__["_reference_leaves"] = leaves
    return leaves


# ------------------------------------------------------------ logical axes
def _ffn_linears(prefix: str) -> dict:
    return {f"{prefix}/gate": (("embed",), ("ffn",)), f"{prefix}/up": (("embed",), ("ffn",)),
            f"{prefix}/down": (("ffn",), ("embed",))}


# a linear's module path in a layer -> (input axes, output axes), as each
# kind's reference ``init_*`` passes them to ``init_linear``
_LINEAR_AXES = {
    "attn/wq": (("embed",), ("heads", "head_dim")),
    "attn/wk": (("embed",), ("kv_heads", "head_dim")),
    "attn/wv": (("embed",), ("kv_heads", "head_dim")),
    "attn/wo": (("heads",), ("embed",)),
    **_ffn_linears("ffn"), **_ffn_linears("moe/shared"), **_ffn_linears("slstm/ffn"),
    "moe/router": (("embed",), ("experts",)),
    "rglru/w_rec": (("embed",), ("lru",)), "rglru/w_gate": (("embed",), ("lru",)),
    "rglru/w_out": (("lru",), ("embed",)), "rglru/w_a": (("lru",), ("lru",)),
    "rglru/w_i": (("lru",), ("lru",)),
    "mlstm/w_up": (("embed",), ("inner",)), "mlstm/w_gate": (("embed",), ("inner",)),
    "mlstm/wq": (("inner",), ("heads", "head_dim")), "mlstm/wk": (("inner",), ("heads", "head_dim")),
    "mlstm/w_i": (("inner",), ("heads",)), "mlstm/w_f": (("inner",), ("heads",)),
    "mlstm/w_out": (("inner",), ("embed",)),
    **{f"slstm/w_{g}": (("embed",), ("heads", "head_dim")) for g in "ifzo"},
}
# the other leaves of a layer: norms' scales, raw tensors
_LEAF_AXES = {
    "moe/w_gate": ("experts", "embed", "ffn"), "moe/w_up": ("experts", "embed", "ffn"),
    "moe/w_down": ("experts", "ffn", "embed"),
    "rglru/lam": ("lru",), "rglru/conv_w": ("conv", "lru"), "rglru/conv_b": ("lru",),
    "mlstm/conv_w": ("conv", "inner"), "mlstm/conv_b": ("inner",),
    **{f"slstm/r_{g}": ("heads", "head_dim", "head_dim") for g in "ifzo"},
}


def _layer_leaf_axes(path: tuple, stacked: bool) -> tuple:
    """The logical axes of a layer's leaf at ``path`` (its keys in the
    layer), with the leading ``"layers"`` axis of a stacked unit leaf.  A
    w8a16 ``w_s`` drops the first axis of its weight's axes, stacked or
    not, as the reference's ``quantize_axes`` does."""
    lead = ("layers",) if stacked else ()
    if path[-1] == "scale":  # every norm's scale is ("embed",), as init_norm names it
        return lead + ("embed",)
    module, leaf = "/".join(path[:-1]), path[-1]
    if module in _LINEAR_AXES and leaf in ("w", "w_q", "w_s", "b"):
        in_axes, out_axes = _LINEAR_AXES[module]
        w = lead + in_axes + out_axes
        return {"w": w, "w_q": w, "w_s": w[1:], "b": lead + out_axes}[leaf]
    key = "/".join(path)
    if key not in _LEAF_AXES:
        raise KeyError(f"reference_axes: no logical axes for the layer leaf {key!r}")
    return lead + _LEAF_AXES[key]


def reference_axes(model: Transformer) -> dict[str, tuple]:
    """The reference's logical-axes tree of ``model`` (``init_model``'s
    second result; ``quantize_axes``' tree for a w8a16 model): each leaf's
    path, as ``reference_leaves`` names it, to its axes tuple, in the
    reference's flattening order.  Reads shapes and names only: a model on
    the meta device plans a full-width arch."""
    cfg = model.cfg
    n_unit = len(cfg.pattern_unit)
    out = [(("embed",), ("vocab", "embed")), (("final_norm", "scale"), ("embed",))]
    if model.unembed is not None:
        out.append((("unembed",), ("embed", "vocab")))
    for pos in range(n_unit if cfg.n_units else 0):
        out += [(("units", str(pos), *path), _layer_leaf_axes(path, stacked=True))
                for path, _ in _layer_items(model.layers[pos])]
    for i, layer in enumerate(model.layers[cfg.n_units * n_unit:]):
        out += [(("leftover", i, *path), _layer_leaf_axes(path, stacked=False))
                for path, _ in _layer_items(layer)]
    out.sort(key=lambda kv: kv[0])
    return {"/".join(map(str, path)): axes for path, axes in out}


# ------------------------------------------------- a rank's blocks under a layout
def _tensors(model: Transformer) -> dict:
    """The model's parameters and w8a16 buffers, by name."""
    return dict(model.state_dict(keep_vars=True))


def compute_specs(model: Transformer, layout: Layout) -> dict:
    """Each tensor's compute spec (``param_pspec``), by its name in
    ``model``; the mLSTM's ``norm`` scale whole (the module docstring)."""
    out = {"embed": param_pspec(("vocab", "embed"), layout),
           "final_norm.scale": param_pspec(("embed",), layout)}
    if model.unembed is not None:
        out["unembed"] = param_pspec(("embed", "vocab"), layout)
    for i, layer in enumerate(model.layers):
        for path, _ in _layer_items(layer):
            spec = param_pspec(_layer_leaf_axes(path, stacked=False), layout)
            out[f"layers.{i}." + ".".join(path)] = P() if path[0] == "mlstm" and path[1] == "norm" else spec
    return out


def scale_rows_spec(cfg: ModelConfig, layout: Layout, name: str):
    """(the compute spec of the stacked leaf, the unit) for a w8a16 scale
    ``name`` of a layer in a stacked unit when that spec splits the units
    over more than one rank (the reference's ``quantize_axes`` quirk,
    ``layers.ScaleRows``); else None."""
    if not name.endswith(".w_s") or layout.kind == "prefill":
        return None
    _, u = leaf_path(cfg, name)
    if u is None:
        return None
    spec = param_pspec(_layer_leaf_axes(tuple(name.split(".", 2)[2].split(".")), stacked=True),
                       layout)
    first = spec[0] if len(spec) else None
    axes = (first,) if isinstance(first, str) else tuple(first or ())
    sizes = dict(zip(layout.mesh.axis_names, layout.mesh.shape))
    return (spec, u) if math.prod(sizes[a] for a in axes) > 1 else None


def _pieces(meta: Transformer, layout: Layout) -> tuple[dict, tuple | None]:
    """(each tensor's slices of this rank's piece, by name: its compute
    block (decode, long) — for a scale under ``scale_rows_spec`` its
    unit's row of the stacked block, None where the block holds other
    units — or its layer's slice of the stacked leaf's storage block,
    None where the block holds other units (prefill); the storage plan,
    ``_stored_plan``, under prefill), from a model of whole shapes."""
    mesh = layout.mesh
    tensors = _tensors(meta)
    if layout.kind != "prefill":
        out = {}
        for name, spec in compute_specs(meta, layout).items():
            shape = tuple(tensors[name].shape)
            rows = scale_rows_spec(meta.cfg, layout, name)
            if rows is None:
                out[name] = NamedSharding(mesh, spec).block(shape, mesh.rank)
                continue
            stacked, u = rows
            blk = NamedSharding(mesh, stacked).block((meta.cfg.n_units,) + shape, mesh.rank)
            out[name] = blk[1:] if blk[0].start <= u < blk[0].stop else None
        return out, None
    shapes, specs = plan = _stored_plan(meta, layout)
    out = {}
    for name in tensors:
        path, u = leaf_path(meta.cfg, name)
        blk = NamedSharding(mesh, specs[path]).block(shapes[path], mesh.rank)
        out[name] = blk if u is None else (blk[1:] if blk[0].start <= u < blk[0].stop else None)
    return out, plan


def _stored_plan(meta: Transformer, layout: Layout) -> tuple[dict, dict]:
    """(each reference leaf's full shape, its storage spec), by path."""
    shapes = {}
    for path, ps in leaf_params(meta, buffers=True).items():
        shape = tuple(ps[0].shape)
        shapes[path] = (len(ps),) + shape if path.startswith("units/") else shape
    axes = reference_axes(meta)
    return shapes, {path: store_pspec(shapes[path], axes[path], layout) for path in shapes}


def _cut(t: torch.Tensor, blk) -> None:
    """``t`` holding its piece ``blk`` (a copy), or nothing (None)."""
    t.data = t.data[blk].clone() if blk is not None else t.data.new_empty(0)


def _finish(model: Transformer, layout: Layout, pieces: dict, plan: tuple | None):
    """The rank's parameters from a model whose tensors hold their pieces
    (``_pieces``): the model itself, its modules told their splits and
    the stacked scales' rows assembled (decode, long), or a
    ``StoredParams`` of the stacked blocks (prefill)."""
    shard = shard_of(layout, "a rank's parameters")
    mesh = layout.mesh
    if layout.kind != "prefill":
        d = model.cfg.d_model
        if d % shard.embed.size:
            raise ValueError(f"d_model {d} does not split over {shard.embed.size} ranks")
        specs = compute_specs(model, layout)

        def split(spec):  # the Axis a leaf's first dimension splits over
            entry = spec[0] if len(spec) else None
            if entry is None:
                return None
            if entry not in ("model", ("model",)):
                raise NotImplementedError(f"a parameter split over {entry} is not executed")
            return shard.model

        model.shard = shard
        rows: dict = {}  # (pattern position, module path) -> the units' Linears
        for name, m in model.named_modules():
            if isinstance(m, Linear):
                m.reduce = split(specs[f"{name}.w" if m.w is not None else f"{name}.w_q"])
                if m.w is None and scale_rows_spec(model.cfg, layout, f"{name}.w_s") is not None:
                    i, rest = name.split(".", 2)[1:]
                    u, pos = divmod(int(i), len(model.cfg.pattern_unit))
                    rows.setdefault((pos, rest), []).append((u, name, m))
                    model.scale_rows.setdefault(int(i), []).append(m)
            elif isinstance(m, RMSNorm):
                m.split = split(specs[f"{name}.scale"])
            elif isinstance(m, (Attention, MoE, SLSTM)):
                m.shard = shard
        for lins in rows.values():  # one tensor of the rank's rows, shared by the units
            lins.sort(key=lambda x: x[0])
            held = [m.w_s for _, name, m in lins if pieces[f"{name}.w_s"] is not None]
            block = (torch.stack(held) if held
                     else lins[0][2].w_s.new_empty((0,) + tuple(lins[0][2].w_q.shape[1:])))
            for u, _, m in lins:
                m.register_buffer("w_s", block)
                m.scale_rows = ScaleRows(unit=u, units=model.cfg.n_units, axis=shard.model)
        return model
    shapes, specs = plan
    held: dict = {}
    for name, t in _tensors(model).items():
        if pieces[name] is not None:
            path, u = leaf_path(model.cfg, name)
            held.setdefault(path, []).append((u, t.data))
    blocks = {}
    for path, got in held.items():
        got.sort(key=lambda x: -1 if x[0] is None else x[0])
        blocks[path] = got[0][1] if got[0][0] is None else torch.stack([t for _, t in got])
    want = {p for p in shapes}
    if set(blocks) != want:
        raise RuntimeError(f"stored blocks: missing {sorted(want - set(blocks))[:4]}")
    return StoredParams(model.cfg, layout, shard, blocks, shapes, specs)


def shard_model(model: Transformer, layout: Layout):
    """This rank's parameters of a whole ``model`` (float32 or w8a16)
    under a serving layout on a live mesh (the module docstring).  Under
    decode and long the model's tensors are cut to their blocks in
    place."""
    shard_of(layout, "shard_model")
    pieces, plan = _pieces(model, layout)
    with torch.no_grad():
        for name, t in _tensors(model).items():
            _cut(t, pieces[name])
    return _finish(model, layout, pieces, plan)


def _meta_model(cfg: ModelConfig, w8a16: bool) -> Transformer:
    meta = Transformer(cfg, device="meta")
    return quantize_model(meta) if w8a16 else meta


def draw_rank_params(cfg: ModelConfig, generator: torch.Generator, layout: Layout, device=None,
                     *, w8a16: bool = False):
    """This rank's parameters under a serving layout, drawn leaf by leaf
    from ``generator`` in the one-device init's order (``layers.Drawing``):
    each leaf drawn whole on ``device`` (default: the mesh's), cut to
    the rank's piece and freed; the leaves the init does not draw (norm
    scales, biases) are made whole and cut.  The values are those of
    ``Transformer(cfg, generator=...)`` on one device, and with
    ``w8a16`` those of ``quantize_model`` of it: each linear's weight is
    quantised whole as it is drawn, then its codes and scales are cut."""
    shard_of(layout, "init_params")
    device = layout.mesh.device if device is None else device
    order: list = []
    meta = Transformer(cfg, device="meta", generator=Drawing(
        torch.Generator(), lambda w: order.append(w.untyped_storage()._cdata) or w))
    by_storage = {p.untyped_storage()._cdata: name for name, p in meta.named_parameters()}
    names = [by_storage[c] for c in order]
    linears = {name for name, m in meta.named_modules() if isinstance(m, Linear)}
    pieces, plan = _pieces(quantize_model(meta) if w8a16 else meta, layout)
    turn = iter(names)
    quantized: dict = {}

    def keep(w: torch.Tensor) -> torch.Tensor:
        name = next(turn)
        mod = name[:-2]
        if w8a16 and name.endswith(".w") and mod in linears:
            q, s = quantize_weight(w)
            quantized[mod] = tuple(t[blk].clone() if blk is not None else t.new_empty(0)
                                   for t, blk in ((q, pieces[f"{mod}.w_q"]),
                                                  (s, pieces[f"{mod}.w_s"])))
            return w.new_empty(0)
        blk = pieces[name]
        return w[blk].clone() if blk is not None else w.new_empty(0)

    model = Transformer(cfg, generator=Drawing(generator, keep), device=device)
    for name, m in model.named_modules():
        if name in quantized:
            m.set_w8a16(*quantized[name])
    drawn_names = set(names)
    with torch.no_grad():
        for name, t in _tensors(model).items():
            if name not in drawn_names and not (name.endswith((".w_q", ".w_s"))
                                                and name[:-4] in quantized):
                _cut(t, pieces[name])
    return _finish(model, layout, pieces, plan)


def empty_rank_params(cfg: ModelConfig, layout: Layout, *, device, dtype: torch.dtype,
                      w8a16: bool = False):
    """This rank's parameters under a serving layout as uninitialised
    tensors of its pieces' shapes on ``device`` (``"meta"`` to plan): the
    floating tensors in ``dtype`` but the w8a16 scales (float32, as the
    reference's ``quantize_tree`` keeps them), the codes int8.  Nothing
    is drawn, so a full-width arch costs only its rank's bytes."""
    shard_of(layout, "empty_rank_params")
    model = _meta_model(cfg, w8a16)
    pieces, plan = _pieces(model, layout)
    device = torch.device(device)
    for name, t in _tensors(model).items():
        blk = pieces[name]
        shape = tuple(t[blk].shape) if blk is not None else (0,)
        dt = dtype if t.dtype.is_floating_point and not name.endswith(".w_s") else t.dtype
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        new = torch.empty(shape, dtype=dt, device=device)
        if leaf in mod._parameters:  # a new tensor: a meta tensor's storage cannot be replaced
            mod._parameters[leaf] = torch.nn.Parameter(new, requires_grad=False)
        else:
            mod._buffers[leaf] = new
    for m in model.modules():  # the rotary frequencies: not a parameter, made anew
        if isinstance(m, Attention):
            m.register_buffer("freq", rope_freq(m.cfg.head_dim, m.cfg.rope_theta, device),
                              persistent=False)
    return _finish(model, layout, pieces, plan)
