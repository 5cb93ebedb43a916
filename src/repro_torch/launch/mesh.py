"""Process-group meshes over ``torch.distributed``.

Port of ``repro.launch.mesh``.  Where the reference builds a
``jax.sharding.Mesh`` over devices, the port's ``Mesh`` is one process
per rank: its axis names (``data``, ``model``, or ``pod``, ``data``,
``model``), its shape, this rank's coordinates, and one process group
per axis line.  Ranks are laid out row-major over the shape, as
``jax.make_mesh`` lays out devices.

Every rank creates every group, in the same order, and keeps the ones it
belongs to: ``dist.new_group`` is a collective over the whole world, and
a rank that creates only its own groups hangs the others.
``init_process_group`` gets the caller's timeout, so a hang fails at its
deadline.

The backend is the caller's choice (``gloo`` or ``nccl``) and never
switches on its own.  ``gloo`` takes CPU and CUDA tensors (the latter
staged through the host), so several ranks can share one card; ``nccl``
takes CUDA tensors only and refuses two ranks on one device.

``spawn_local`` runs a function on every rank of a mesh, one process per
rank on this host, and returns each rank's result.  ``AbstractMesh`` has
axis names and a shape and joins no world: the counterpart of the
reference's mesh over placeholder devices (its dry run), on which the
sharding plans (``distributed.sharding``) are computed for the
production meshes without 256 processes.  Importing this module starts
nothing.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int
    coords: tuple[int, ...]  # this rank's index along each axis
    groups: dict  # axis name -> the process group of this rank's line along it
    device: torch.device

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis):
        """The process group of the ranks that differ from this one only
        along ``axis`` (a name, or on a 3-D mesh the pair (``pod``,
        ``data``)), ranked by their coordinates on it, the first axis
        major."""
        return self.groups[axis]

    def reshape(self, shape) -> "Mesh":
        """A mesh of another ``shape`` over the same world and axis names
        (a 2-D world run as (1, 4) and then (2, 2), say): every rank of
        the world must call it, with the same shape, in the same order,
        since it creates every group of the new shape."""
        shape = tuple(int(s) for s in shape)
        if math.prod(shape) != math.prod(self.shape) or len(shape) != len(self.shape):
            raise ValueError(f"mesh {self.shape} cannot be reshaped to {shape}")
        coords, groups = _axis_groups(shape, self.axis_names, self.rank)
        return Mesh(self.axis_names, shape, self.rank, coords, groups, self.device)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and a shape, no processes: for planning only.  A spec's
    meaning needs just these two (``distributed.sharding``); an executor
    that moves data raises on it."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axes {self.axis_names} differ in length")


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production meshes as an ``AbstractMesh``: 16 x 16
    (``data``, ``model``) or 2 x 16 x 16 (``pod``, ``data``, ``model``)."""
    if multi_pod:
        return AbstractMesh(AXES_3D, (2, 16, 16))
    return AbstractMesh(AXES_2D, (16, 16))


def make_mesh(shape, axis_names, *, backend: str, store, rank: int, world_size: int,
              device, timeout_s: float = 60.0) -> Mesh:
    """Join the world (``init_process_group`` on ``store``) and build the
    mesh's groups.  Every rank of the world must call this with the same
    shape, axes and backend."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in length")
    if math.prod(shape) != world_size:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the world has {world_size}")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for a CPU mesh")
        if device.index is None:  # a bare "cuda": the current device
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("nccl moves CUDA tensors only: use a CUDA device or gloo")
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    coords, groups = _axis_groups(shape, axis_names, rank)
    return Mesh(axis_names, shape, rank, coords, groups, device)


def _axis_groups(shape: tuple, axis_names: tuple, rank: int) -> tuple[tuple, dict]:
    """(``rank``'s coordinates, its group along each axis, and on a 3-D
    mesh along the (``pod``, ``data``) plane, ``pod``-major: the batch
    axes of the multi-pod layouts): every group of the shape created, in
    one order, by every rank of the world."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    lines = [(name, np.moveaxis(ranks, a, -1).reshape(-1, shape[a]).tolist())
             for a, name in enumerate(axis_names)]
    if tuple(axis_names) == AXES_3D:
        lines.append((AXES_3D[:2], ranks.reshape(-1, shape[2]).T.tolist()))
    groups = {}
    for name, members in lines:
        for line in members:
            g = dist.new_group(line)  # every rank, every group, one order
            if rank in line:
                groups[name] = g
    return coords, groups


def make_production_mesh(*, multi_pod: bool = False, backend: str, store, rank: int,
                         world_size: int, device, timeout_s: float = 60.0) -> Mesh:
    """The reference's production meshes: 16 x 16 (``data``, ``model``) or
    2 x 16 x 16 (``pod``, ``data``, ``model``); raises unless the world
    has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    if world_size != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the world has {world_size}")
    return make_mesh(shape, AXES_3D if multi_pod else AXES_2D, backend=backend, store=store,
                     rank=rank, world_size=world_size, device=device, timeout_s=timeout_s)


def make_local_mesh(*, backend: str, store, rank: int, world_size: int, device,
                    timeout_s: float = 60.0) -> Mesh:
    """Every rank of the world on the ``model`` axis: (1, world_size)."""
    return make_mesh((1, world_size), AXES_2D, backend=backend, store=store, rank=rank,
                     world_size=world_size, device=device, timeout_s=timeout_s)


def _rank_main(rank, shape, axis_names, backend, device, store_path, timeout_s, fn, args,
               results, done) -> None:
    """One rank: join the mesh, run ``fn(mesh, *args)``, report, and leave
    the world only once the parent has every rank's report (a rank that
    tears down early can cut a peer's last collective short)."""
    try:
        store = dist.FileStore(store_path, math.prod(shape))
        mesh = make_mesh(shape, axis_names, backend=backend, store=store, rank=rank,
                         world_size=math.prod(shape), device=device, timeout_s=timeout_s)
        payload = pickle.dumps(fn(mesh, *args))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, payload))
    done.wait(timeout_s)
    dist.destroy_process_group()


def spawn_local(fn: Callable[..., Any], shape, *, backend: str, device, timeout_s: float,
                args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh, one
    process per rank on this host, and return the results in rank order.
    A 2-D shape is (``data``, ``model``), a 3-D one (``pod``, ``data``,
    ``model``).

    Processes start with the ``spawn`` method (a parent holding a CUDA
    context cannot ``fork``), so ``fn`` must be importable by name and
    ``args`` and the results picklable; each child imports the caller's
    main module again, which must keep its work under a ``__main__``
    guard.  Keep ``args`` small (paths, not arrays): a child's start
    blocks until it has read them.  Every rank uses ``device``.  The
    whole run has ``timeout_s``: a rank that raises fails it at once (its
    traceback in the error), a rank that hangs or dies fails it at the
    deadline or when it exits, and every process is stopped before this
    returns or raises.
    """
    shape = tuple(int(s) for s in shape)
    axis_names = {2: AXES_2D, 3: AXES_3D}.get(len(shape))
    if axis_names is None:
        raise ValueError(f"a mesh has 2 or 3 axes, not {len(shape)}")
    world = math.prod(shape)
    ctx = mp.get_context("spawn")
    results, done = ctx.Queue(), ctx.Event()
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        procs = [ctx.Process(target=_rank_main, name=f"mesh-rank-{r}", daemon=True,
                             args=(r, shape, axis_names, backend, str(device),
                                   os.path.join(tmp, "store"), timeout_s, fn, args,
                                   results, done))
                 for r in range(world)]
        got: dict[int, Any] = {}
        deadline = time.perf_counter() + timeout_s
        try:
            for p in procs:
                p.start()
            while len(got) < world:
                left = deadline - time.perf_counter()
                if left <= 0:
                    missing = sorted(set(range(world)) - set(got))
                    raise TimeoutError(f"mesh {shape}: ranks {missing} did not finish "
                                       f"within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"mesh {shape}: rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} before reporting")
                    continue
                if not ok:
                    raise RuntimeError(f"mesh {shape}: rank {rank} failed:\n{payload}")
                got[rank] = pickle.loads(payload)
            done.set()
            for p in procs:
                p.join(timeout=max(deadline - time.perf_counter(), 5.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(world)]
