"""Checkpointing with async writes and atomic publishing.

Port of ``repro.checkpoint.checkpointer`` in its format, so each package
restores the other's checkpoints:

  * ``save`` writes a step directory ``step_<10 digits>``: one ``.npy``
    a leaf, named by its path with ``/`` turned into ``__``, and a
    ``manifest.json`` ({"step", "leaves": {path: {"file", "shape",
    "dtype"}}}), first into ``<dir>.tmp`` and then published by an atomic
    rename; with ``async_write`` a background thread writes while
    training goes on, one write in flight at a time (``wait`` joins it);
  * ``keep`` retention: after each write only the newest ``keep`` steps
    stay; ``latest_step`` / ``all_steps`` list the published ones;
  * ``restore(template)`` rebuilds the template's structure from disk.

A sharded tree (a ZeRO ``TrainState`` on a mesh, its ``NamedSharding``
tree as ``shardings``) is saved whole: ``save`` gathers each leaf from
every rank's block and rank 0 writes the same files as an unsharded
save, so a checkpoint is the same whatever the mesh.
``restore(..., shardings=)`` reads each full leaf and keeps this rank's
block, re-sharding onto the live mesh (the reference's elastic restore).

A tree is nested dicts, lists, tuples and NamedTuples (fields by name)
of tensors or numpy arrays; a leaf's path joins the keys with ``/``, as
the reference's ``tree_flatten_with_path`` names it.  ``save`` copies
every leaf to the host before it returns, so training may update the
tensors in place while the write goes on.  ``restore`` builds new
tensors.  A port ``TrainState`` is saved as
``train.train_step.state_tree`` lays it out (the reference's paths and
shapes), so each package restores the other's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3
    async_write: bool = True


def _children(node) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node; None for a leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree) -> dict[str, Any]:
    """{path: leaf}, the path's keys joined by ``/``."""
    out = {}

    def walk(node, prefix):
        children = _children(node)
        if children is None:
            out["/".join(prefix)] = node
            return
        for key, child in children:
            walk(child, prefix + [key])

    walk(tree, [])
    return out


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf``: never an alias of a CPU tensor, which
    training goes on updating in place while a background write runs."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class Checkpointer:
    def __init__(self, config: CheckpointConfig):
        self.config = config
        os.makedirs(config.directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool | None = None,
             shardings: Any | None = None) -> None:
        """Copy every leaf to the host, then write step ``step`` (in the
        background unless ``blocking``; default: ``not async_write``).

        ``shardings``: ``tree``'s leaves are this rank's blocks and
        ``shardings`` their ``NamedSharding`` tree; every rank of the mesh
        calls ``save``, each leaf is gathered whole (collectives), and
        rank 0 writes.  A blocking sharded save ends in a barrier, so
        every rank may read the step once it returns."""
        leaves = flatten_with_paths(tree)
        mesh = None
        if shardings is not None:
            flat_sh = flatten_with_paths(shardings)
            leaves = {k: flat_sh[k].gather(v, flat_sh[k].full_shape(tuple(v.shape)))
                      for k, v in leaves.items()}
            mesh = next(iter(flat_sh.values())).mesh
        blocking = (not self.config.async_write) if blocking is None else blocking
        if mesh is not None and mesh.rank != 0:
            if blocking:
                dist.barrier()
            return
        host_leaves = {k: _host(v) for k, v in leaves.items()}
        self.wait()  # one in-flight write at a time
        if blocking:
            self._write(step, host_leaves)
            if mesh is not None:
                dist.barrier()
        else:
            self._thread = threading.Thread(target=self._write, args=(step, host_leaves),
                                            name="checkpoint-writer", daemon=True)
            self._thread.start()

    def _dir(self, step: int) -> str:
        return os.path.join(self.config.directory, f"step_{step:010d}")

    def _write(self, step: int, host_leaves: dict) -> None:
        final = self._dir(step)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for key, arr in host_leaves.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        """Join the write in flight, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.config.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.config.directory)
                      if name.startswith("step_") and not name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, *, step: int | None = None,
                shardings: Any | None = None) -> Any:
        """``template``'s structure rebuilt from step ``step`` (default: the
        latest).  Tensor leaves come back as new tensors on their template
        leaf's device in the saved dtype, numpy leaves as numpy.
        ``shardings`` (a tree of ``NamedSharding`` matching ``template``,
        whose leaves are then this rank's blocks): each full leaf is read
        and this rank's block kept, on whatever mesh saved it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.config.directory}")
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        flat_sh = flatten_with_paths(shardings) if shardings is not None else {}

        def load(key: str, like):
            info = manifest["leaves"][key]
            arr = np.load(os.path.join(d, info["file"]))
            if key in flat_sh:
                if flat_sh[key].shard_shape(arr.shape) != tuple(like.shape):
                    raise ValueError(f"checkpoint {d}: {key} of shape {arr.shape} has blocks of "
                                     f"{flat_sh[key].shard_shape(arr.shape)} on this mesh, the "
                                     f"template {tuple(like.shape)}")
                block = flat_sh[key].shard(torch.from_numpy(arr))
                return block.clone(memory_format=torch.contiguous_format).to(like.device)
            if tuple(arr.shape) != tuple(np.shape(like)):
                raise ValueError(f"checkpoint {d}: {key} has shape {arr.shape}, the template "
                                 f"{tuple(np.shape(like))}")
            if isinstance(like, torch.Tensor):
                return torch.from_numpy(arr).to(like.device)
            return arr

        def build(node, prefix):
            children = _children(node)
            if children is None:
                return load("/".join(prefix), node)
            rebuilt = [build(child, prefix + [key]) for key, child in children]
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*rebuilt)
            if isinstance(node, dict):
                return dict(zip(node.keys(), rebuilt))
            return type(node)(rebuilt)

        return build(template, [])
