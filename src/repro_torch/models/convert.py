"""Weight carry-over between the reference's parameter tree and the port's
``Transformer``.

The reference (``repro.models.transformer.init_model``) stacks the layers
of each pattern position: ``params["units"][str(pos)]`` holds arrays with
a leading ``n_units`` axis, layer ``u * len(pattern_unit) + pos`` at index
``u`` (as ``layer_params_for`` reads it), and ``params["leftover"]`` the
``n_layers % len(pattern_unit)`` layers past the last whole unit.  The
port holds one module a layer in layer order.  Both sides are float32
masters, so the carry-over is exact in both directions.

The tree is given as numpy arrays (``jax.tree.map(np.asarray, params)``
on the reference's side); this module imports nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer


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
    """(path in the reference's layer tree, the port's parameter) pairs:
    the port's module and parameter names are the reference's keys
    (``norm1`` / ``attn`` / ``wq`` / ``w``, ``moe`` / ``router`` / ``w_gate``,
    ``rglru`` / ``lam``, ``mlstm`` / ``norm`` / ``scale``, ``slstm`` /
    ``r_i``, ...); ``norm2`` exists only in the kinds that have it."""
    return [(tuple(name.split(".")), p) for name, p in layer.named_parameters()]


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _copy(dst: torch.nn.Parameter, src, what: str) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: reference shape {src.shape}, port shape {tuple(dst.shape)}")
    dst.data.copy_(torch.from_numpy(np.ascontiguousarray(src, dtype=np.float32)))


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> Transformer:
    """The reference's parameter tree (numpy arrays) as the port's
    ``Transformer`` on ``device`` (``None``: the card)."""
    model = Transformer(cfg, generator=None, device=device)
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_norm.scale, tree["final_norm"]["scale"], "final_norm")
    if model.unembed is not None:
        _copy(model.unembed, tree["unembed"], "unembed")
    for i, layer in enumerate(model.layers):
        lt = _layer_tree(tree, cfg, i)
        for path, p in _layer_items(layer):
            _copy(p, _get(lt, path), f"layer {i} {'/'.join(path)}")
    return model


def params_to_reference(model: Transformer) -> dict:
    """The port's weights as the reference's parameter tree (numpy, the
    units stacked), the inverse of ``params_from_reference``."""
    cfg = model.cfg
    n_unit = len(cfg.pattern_unit)

    def host(p):
        return p.detach().cpu().numpy()

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
