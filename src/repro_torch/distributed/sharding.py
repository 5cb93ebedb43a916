"""Logical-axis sharding rules (MaxText style) for every execution layout.

Port of ``repro.distributed.sharding``.  Parameters and activations carry
*logical* axis names ("embed", "ffn", "act_seq", ...); a ``Layout`` maps
them to mesh axes for one execution mode, so a layout change moves the
whole model without touching model code.

Layouts (the reference's):

* ``train`` / ``prefill`` -- data x sequence parallelism: activations
  sharded batch -> ``data``, sequence -> ``model``; compute parameters
  replicated, expert weights on ``model``;
* ``decode`` -- tensor parallelism over ``model`` through the d_model
  axis, the KV cache sharded over its sequence on ``model``;
* ``long`` -- decode at batch 1: the cache sequence over ``data`` x
  ``model``.

Storage specs ("ZeRO"): master parameters and optimizer state are stored
sharded over every free mesh axis, each placed greedily on the largest
dimension it divides (ties to the lower index, as Python's stable
``sorted`` orders them).

What differs from the reference is who carries a spec out.  In the
reference, XLA partitions one program by these specs and ``lshard``
constrains activations inside it.  In the port a spec is a plan that an
executor reads: ``train.train_step`` stores each leaf's shard and
gathers, reduces and slices by the specs, and places the activations
itself (the batch over ``act_batch``, the loss positions over
``act_seq``), and the serving steps (``serve.prefill`` /
``serve.decode``) run the ``prefill``, ``decode`` and ``long`` layouts
with collectives written out by hand at the points the models name
(``Shard``).  So ``lshard`` is the identity here.  ``NamedSharding``
holds a spec on a mesh and slices a full tensor to a rank's block, or
gathers the blocks back.  A dimension that does not divide by its axes
is split as XLA splits it: blocks of the ceiling size, the last ones
short (or empty), ``shard_shape`` the padded block.  A spec's meaning
needs only the mesh's ``axis_names`` and ``shape``: a live
``launch.mesh.Mesh`` and an ``AbstractMesh`` (which joins no world)
plan alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

# Activation logical axes.  "act_kv_seq" / "act_full_seq" are deliberately
# unmapped (None) in the 2-D layouts: mapping them forces the all-gather of
# full-length K/V (or a full sequence for strictly sequential recurrences).
# "act_lru" channel-shards linear recurrences instead of sequence-sharding.
_ACT_RULES = {
    "train": {"act_batch": ("data",), "act_seq": ("model",), "act_lru": ("model",),
              "experts": ("model",)},
    "prefill": {"act_batch": ("data",), "act_seq": ("model",), "act_lru": ("model",),
                "experts": ("model",)},
    "decode": {"act_batch": ("data",), "cache_seq": ("model",), "embed": ("model",),
               "experts": ("model",)},
    "long": {"cache_seq": ("data", "model"), "embed": ("model",), "experts": ("model",)},
}
# Layout variants (per-arch overrides): "dp_only" folds the model axis into
# batch parallelism, for archs with strictly sequential recurrences (xLSTM's
# sLSTM) where sequence sharding cannot apply.
_ACT_RULES_DP_ONLY = {
    "train": {"act_batch": ("data", "model")},
    "prefill": {"act_batch": ("data",), "act_seq": ("model",), "act_lru": ("model",)},
}
# Parameter logical axes (compute specs)
_PARAM_RULES = {
    "train": {"experts": ("model",)},
    "prefill": {"experts": ("model",)},
    "decode": {"embed": ("model",), "experts": ("model",)},
    "long": {"embed": ("model",), "experts": ("model",)},
}


class PartitionSpec(tuple):
    """A spec a dimension: ``None`` (replicated), a mesh axis name, or a
    tuple of names (the first the major one), as ``jax.sharding.
    PartitionSpec`` holds them.  Immutable; equal to the tuple of its
    entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Layout:
    kind: str | None  # train | prefill | decode | long | None
    mesh: Any  # a launch.mesh.Mesh or AbstractMesh, or None
    multi_pod: bool = False
    variant: str = "default"  # default | dp_only

    def _expand(self, axes_map: dict, name: str):
        got = axes_map.get(name)
        if got is None:
            return None
        if self.multi_pod:
            # pod joins the batch-parallel group in train / prefill / decode
            # and the sequence shard group in long-context decode; dp_only
            # already folds model into batch (256-way), and a global batch of
            # 256 cannot split 512 ways, so pod stays out of it there
            if (name == "act_batch" and self.kind in ("train", "prefill", "decode")
                    and self.variant != "dp_only"):
                got = ("pod",) + tuple(got)
            if name == "cache_seq" and self.kind == "long":
                got = ("pod",) + tuple(got)
        return tuple(got)

    def act_axes(self, name: str):
        if self.kind is None:
            return None
        rules = _ACT_RULES[self.kind]
        if self.variant == "dp_only" and self.kind in _ACT_RULES_DP_ONLY:
            rules = _ACT_RULES_DP_ONLY[self.kind]
        return self._expand(rules, name)

    def param_axes(self, name: str):
        if self.kind is None:
            return None
        return self._expand(_PARAM_RULES[self.kind], name)


def make_layout(kind: str | None, mesh, multi_pod: bool = False,
                variant: str = "default") -> Layout:
    return Layout(kind=kind, mesh=mesh, multi_pod=multi_pod, variant=variant)


NULL_LAYOUT = Layout(kind=None, mesh=None)


def _dedup(spec_list):
    """A mesh axis may appear only once in a spec; keep its first use."""
    seen: set = set()
    out = []
    for entry in spec_list:
        if entry is None:
            out.append(None)
            continue
        entry = tuple(a for a in entry if a not in seen)
        seen.update(entry)
        out.append(entry if entry else None)
    return out


def _spec(layout: Layout, names, lookup) -> PartitionSpec:
    return P(*_dedup([lookup(n) for n in names]))


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def lshard(x: torch.Tensor, layout: Layout | None, names) -> torch.Tensor:
    """The identity.  The reference constrains an activation to its
    layout's mapping here so that XLA partitions the program; the port
    has no partitioner: the executor (``train.train_step``) places the
    batch and the loss positions itself.  Checks the rank of ``x``
    against ``names`` as the reference does."""
    if layout is not None and layout.mesh is not None and layout.kind is not None:
        if x.dim() != len(names):
            raise ValueError(f"lshard: {tuple(x.shape)} against {names}")
    return x


def act_pspec(names, layout: Layout) -> PartitionSpec:
    """The spec the reference's ``lshard`` gives an activation with
    logical ``names``; the port's executor places data by it."""
    if layout.mesh is None or layout.kind is None:
        return P()
    return _spec(layout, names, layout.act_axes)


def param_pspec(names, layout: Layout) -> PartitionSpec:
    """Compute-time spec of a parameter with logical ``names``."""
    if layout.mesh is None or layout.kind is None:
        return P()
    return _spec(layout, names, layout.param_axes)


def store_pspec(shape, names, layout: Layout) -> PartitionSpec:
    """Storage (ZeRO) spec: the compute spec plus every free mesh axis
    placed greedily on the largest dimension it divides.  For master
    parameters and optimizer state."""
    if layout.mesh is None or layout.kind is None:
        return P()
    shape = tuple(int(s) for s in shape)
    base = _dedup([layout.param_axes(n) for n in names])
    used = {a for entry in base if entry for a in entry}
    free = [a for a in layout.mesh.axis_names if a not in used]
    sizes = _axis_sizes(layout.mesh)
    factor = [math.prod(sizes[a] for a in (entry or ())) for entry in base]
    spec = [list(entry) if entry else [] for entry in base]
    for ax in free:
        s = sizes[ax]
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):  # stable: ties to the lower index
            if shape[i] % (factor[i] * s) == 0 and shape[i] // (factor[i] * s) >= 1:
                spec[i].append(ax)
                factor[i] *= s
                break
    return P(*_dedup([tuple(e) if e else None for e in spec]))


def is_axes_leaf(t) -> bool:
    """A logical-axes tuple (names or None), the leaf of an axes tree."""
    return isinstance(t, tuple) and all(isinstance(x, (str, type(None))) for x in t)


def map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree (nested dicts, lists and
    tuples whose leaves are axes tuples) and trees of the same structure;
    returns a tree of the axes tree's structure."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, a, *(t[k] for t in trees)) for k, a in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(map_axes(fn, a, *(t[i] for t in trees))
                               for i, a in enumerate(axes_tree))
    raise TypeError(f"map_axes: {type(axes_tree).__name__} in an axes tree")


def tree_pspecs(axes_tree, params_tree, layout: Layout, stored: bool):
    """(axes tree, params tree) -> a tree of specs: storage specs from the
    leaves' shapes when ``stored``, else compute specs."""

    def one(axes, leaf):
        if stored:
            return store_pspec(tuple(leaf.shape), axes, layout)
        return param_pspec(axes, layout)

    return map_axes(one, axes_tree, params_tree)


# ------------------------------------------------------------- execution
def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def rank_coords(mesh, rank: int) -> dict:
    """{axis: coordinate} of ``rank`` (ranks row-major over the shape)."""
    return dict(zip(mesh.axis_names, (int(c) for c in np.unravel_index(rank, mesh.shape))))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``spec`` on ``mesh``: a rank holds, along each dimension, the block
    its coordinates on that dimension's axes select (the first axis of an
    entry the major one), as ``jax.sharding.NamedSharding`` lays blocks
    out on devices.  Axes a spec does not name replicate the block."""

    mesh: Any
    spec: PartitionSpec

    def _entries(self, ndim: int) -> list[tuple]:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than {ndim} dimensions")
        return [_entry_axes(e) for e in self.spec] + [()] * (ndim - len(self.spec))

    def replicated(self) -> bool:
        return not any(_entry_axes(e) for e in self.spec)

    def full_shape(self, shard_shape) -> tuple:
        """The full tensor's shape from a block's."""
        sizes = _axis_sizes(self.mesh)
        return tuple(n * math.prod(sizes[a] for a in axes)
                     for n, axes in zip(shard_shape, self._entries(len(shard_shape))))

    def shard_shape(self, shape) -> tuple:
        """A block's shape: each dimension over its axes' product, rounded
        up (XLA's padded block where the dimension does not divide)."""
        sizes = _axis_sizes(self.mesh)
        return tuple(-(-n // math.prod(sizes[a] for a in axes))
                     for n, axes in zip(shape, self._entries(len(shape))))

    def block(self, shape, rank: int) -> tuple:
        """``rank``'s block of a full tensor of ``shape``, as slices: the
        ``shard_shape`` block at the rank's index, cut at the tensor's
        end (so the last blocks of an uneven dimension are short or
        empty)."""
        sizes, coords = _axis_sizes(self.mesh), rank_coords(self.mesh, rank)
        out = []
        for n, m, axes in zip(shape, self.shard_shape(shape), self._entries(len(shape))):
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + coords[a]
            out.append(slice(min(idx * m, n), min((idx + 1) * m, n)))
        return tuple(out)

    def owns(self, rank: int) -> bool:
        """Whether ``rank`` is the first holder of its block: coordinate 0
        on every axis the spec does not name.  Summing a quantity over
        the owners counts each element once."""
        named = {a for e in self.spec for a in _entry_axes(e)}
        coords = rank_coords(self.mesh, rank)
        return all(coords[a] == 0 for a in self.mesh.axis_names if a not in named)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a view)."""
        return full[self.block(tuple(full.shape), self.mesh.rank)]

    def gather(self, local: torch.Tensor, shape) -> torch.Tensor:
        """The full tensor of ``shape`` from every rank's block: one
        ``all_gather`` over the world (every rank must call it)."""
        shape = tuple(shape)
        world = math.prod(self.mesh.shape)
        if world == 1 or self.replicated():
            return local.clone()
        padded = local.new_zeros(self.shard_shape(shape))  # a short block, padded
        padded[tuple(slice(0, n) for n in local.shape)] = local
        parts = [torch.empty_like(padded) for _ in range(world)]
        dist.all_gather(parts, padded)
        full = local.new_empty(shape)
        for r, part in enumerate(parts):
            blk = self.block(shape, r)
            full[blk] = part[tuple(slice(0, b.stop - b.start) for b in blk)]
        return full


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of specs (NamedTuples, dicts,
    lists and tuples whose leaves are ``PartitionSpec``) and trees of the
    same structure; returns a tree of the specs tree's structure."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, *trees)
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, getattr(specs, f), *(getattr(t, f) for t in trees))
                             for f in specs._fields))
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, v, *(t[i] for t in trees)) for i, v in enumerate(specs))
    raise TypeError(f"map_specs: {type(specs).__name__} in a specs tree")


def named_shardings(mesh, specs):
    """A tree of ``NamedSharding`` on ``mesh`` from a tree of specs."""
    return map_specs(lambda spec: NamedSharding(mesh, spec), specs)


# ------------------------------------------------ executing a serving layout
@dataclasses.dataclass(frozen=True)
class Axis:
    """Mesh axes as an executor runs collectives over them: the process
    group of this rank's line along them (the first axis the major one),
    this rank's index on that line and its length.  On a line of one
    rank every collective is the identity."""

    group: Any
    index: int
    size: int

    def block(self, n: int) -> slice:
        """This rank's block of a dimension of ``n`` split over the line:
        ceiling-sized blocks, the last ones cut at ``n`` (XLA's split)."""
        m = -(-n // self.size)
        return slice(min(self.index * m, n), min((self.index + 1) * m, n))

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (``"sum"``) or maximised (``"max"``) over the line,
        in place on a contiguous ``x``; returns it."""
        if self.size == 1:
            return x
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) joined along ``dim`` in line order."""
        if self.size == 1:
            return x
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` summed over the line, and this rank's block of ``dim`` of
        the sum (``dim`` divides by the line)."""
        if self.size == 1:
            return x
        if x.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter: dimension {x.shape[dim]} over {self.size} ranks")
        parts = [c.contiguous() for c in x.chunk(self.size, dim=dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=self.group)
        return out


ONE = Axis(group=None, index=0, size=1)


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a rank executes a serving layout on a live mesh (``data``,
    ``model``, or ``pod``, ``data``, ``model``): ``kind`` (``prefill``, ``decode`` or ``long``), ``model``
    the mesh's ``model`` axis, ``batch`` the axes the rows split
    over (``act_batch``), ``seq`` those the prefill's sequence splits
    over (``act_seq``), ``cache`` those the KV cache's sequence splits
    over (``cache_seq``: ``model`` in decode, the world in row-major
    order in ``long``), ``embed`` those d_model splits over (the
    parameters' ``embed``), ``experts`` those the experts split over.
    Axes a layout leaves unmapped are ``ONE``."""

    kind: str
    model: Axis
    batch: Axis
    seq: Axis
    cache: Axis
    embed: Axis
    experts: Axis


SERVING_KINDS = ("prefill", "decode", "long")
_AXES_3D = ("pod", "data", "model")


def shard_of(layout: Layout, what: str) -> Shard:
    """The ``Shard`` a serving layout on a live mesh executes: a (``data``,
    ``model``) mesh, or with ``multi_pod`` a (``pod``, ``data``,
    ``model``) one, whose (``pod``, ``data``) plane carries the batch and
    whose whole world carries ``long``'s cache.  Raises on an
    ``AbstractMesh``, a layout kind other than ``prefill``, ``decode``
    or ``long``, a mesh whose axes do not match ``multi_pod``, or a
    mapping other than the reference's rules give."""
    mesh = layout.mesh
    if not hasattr(mesh, "rank"):
        raise ValueError(f"{what}: {type(mesh).__name__} joins no world: it plans, it cannot "
                         "execute; pass a launch.mesh.Mesh")
    if layout.kind not in SERVING_KINDS:
        raise NotImplementedError(f"{what}: the {layout.kind!r} layout is not a serving layout; "
                                  f"a serving step executes {SERVING_KINDS}")
    names = tuple(mesh.axis_names)
    if names != (_AXES_3D if layout.multi_pod else _AXES_3D[1:]):
        raise NotImplementedError(f"{what}: a layout with multi_pod={layout.multi_pod} executes "
                                  f"on a {_AXES_3D if layout.multi_pod else _AXES_3D[1:]} mesh, "
                                  f"not {names}")
    axes = {None: ONE, names: Axis(dist.group.WORLD, mesh.rank, math.prod(mesh.shape))}
    for a in names:
        axes[(a,)] = Axis(mesh.group(a), mesh.index(a), mesh.size(a))
    if layout.multi_pod:
        axes[_AXES_3D[:2]] = Axis(mesh.group(_AXES_3D[:2]),
                                  mesh.index("pod") * mesh.size("data") + mesh.index("data"),
                                  mesh.size("pod") * mesh.size("data"))

    def of(names, name):
        if names not in axes:
            raise NotImplementedError(f"{what}: {name} over {names} is not executed")
        return axes[names]

    act, par = layout.act_axes, layout.param_axes
    return Shard(kind=layout.kind, model=axes[("model",)],
                 batch=of(act("act_batch"), "act_batch"),
                 seq=of(act("act_seq") if layout.kind == "prefill" else None, "act_seq"),
                 cache=of(act("cache_seq") if layout.kind != "prefill" else None, "cache_seq"),
                 embed=of(par("embed"), "embed"), experts=of(par("experts"), "experts"))
