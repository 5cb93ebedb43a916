"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell,
traced on the meta device in a fake world of the production mesh's size.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell on 256 or 512 placeholder devices and reads the
compiled program's memory, cost and collectives.  The port has no
compiler: ``plan_cell`` joins a fake world (PyTorch's ``fake`` c10d
backend: every collective returns at once, nothing moves) of 16 x 16 or
2 x 16 x 16 ranks as one of them, builds that rank's blocks of the
state, parameters and caches as empty tensors on the meta device (never
drawn: a full-width arch costs nothing), runs one step of the port's own
executor (``make_train_step`` / ``make_prefill_step`` /
``make_serve_step`` under the cell's layout, or the retrieve step) under
``launch.op_analysis`` and reports what that step does: the flops, the
unfused HBM bytes and the collectives it really issues, charged by the
reference's ring rule.

Each cell's report has the reference's keys where a counterpart exists:
``arch``, ``shape``, ``mesh``, ``multi_pod``, ``n_devices``, ``layout``,
``variant``, ``flops_per_device``, ``hbm_bytes_per_device``,
``collective_bytes_per_device``, ``collective_bytes_total``,
``collective_counts``, ``params_total``, ``params_active``,
``argument_size_in_bytes`` and ``output_size_in_bytes``; ``trace_s``
replaces ``lower_s`` / ``compile_s``.  The argument bytes are computed
from the specs for every rank (the reference's ``input_shardings`` and
the state's, parameters' and caches' specs, each block as the port
holds it) and the largest is reported, since uneven blocks make ranks
differ; the traced rank's are ``argument_size_in_bytes_rank``.  The meta
device has no allocator, so there is no ``temp_size_in_bytes`` (null).
With ``device="cuda"`` the same rank's step runs on the card in the same
fake world, on uninitialised blocks (integers zeroed, so every index is
in range), and the report adds ``peak_bytes``
(``torch.cuda.max_memory_allocated``, the counterpart of
``memory_analysis()``'s sizes) and ``step_s``: one rank, collectives
skipped.

As the reference: ``OPT_FOR`` and ``VARIANT_FOR``, ``long`` for
``long_500k``, bf16 parameters for prefill and decode, and w8a16 decode
(``long_500k`` too) under ``REPRO_W_INT8=1``.  A world is one per
process: the CLI plans each cell in a spawned child of its own on a
deadline of ``CELL_TIMEOUT_S`` (``in_child``), as many at once as the
host has cores (one at a time with ``--device cuda``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --retrieval --both-meshes
  ... --device cuda    # the same rank's step on the card
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, shapes_for
from repro_torch.distributed.sharding import (
    Layout, NamedSharding, PartitionSpec as P, _entry_axes, make_layout, map_specs, param_pspec)
from repro_torch.launch.mesh import AXES_2D, AXES_3D, Mesh, _axis_groups
from repro_torch.launch.op_analysis import OpMeter
from repro_torch.models.convert import (
    _meta_model, _stored_plan, empty_rank_params, leaf_params, reference_axes, reference_leaves)
from repro_torch.models.transformer import Transformer
from repro_torch.optim import OptConfig, opt_init
from repro_torch.serve.decode import cache_pspecs, make_serve_step
from repro_torch.serve.prefill import make_prefill_step
from repro_torch.train.train_step import (
    TrainHParams, TrainState, make_train_state_specs, make_train_step)

# Per-arch optimizer and training layout variant: the reference's
OPT_FOR = {"llama4-maverick-400b-a17b": "adafactor"}
VARIANT_FOR = {"xlstm-350m": "dp_only"}
# the retrieval cell: the reference's lower_retrieval (BigANN-100M)
RETRIEVAL_C, RETRIEVAL_K, RETRIEVAL_R, RETRIEVAL_RMAX = 32, 256, 96, 16
# the CLI's deadline a cell (a child each): the slowest cell, xlstm-350m's
# prefill_32k, traced in 3,443 s on an 8-core CPU
CELL_TIMEOUT_S = 7200.0


def production_shape(multi_pod: bool) -> tuple[tuple, tuple]:
    return ((2, 16, 16), AXES_3D) if multi_pod else ((16, 16), AXES_2D)


def fake_mesh(shape, axis_names, *, rank: int = 0, device="meta") -> Mesh:
    """This process as ``rank`` of a fake world of ``prod(shape)`` ranks
    (joined on the first call), with every group of the mesh made.  A
    process holds one world: another size raises."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this torch has no fake process group (torch.testing._internal."
                           "distributed.fake_pg): the dry run needs it") from e
    shape, world = tuple(int(s) for s in shape), math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError(f"this process is rank {dist.get_rank()} of a "
                               f"{dist.get_backend()} world of {dist.get_world_size()}; a plan of "
                               f"rank {rank} of {world} runs in a process of its own (in_child)")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    coords, groups = _axis_groups(shape, tuple(axis_names), rank)
    return Mesh(tuple(axis_names), shape, rank, coords, groups, device)


# ------------------------------------------------------- argument bytes by spec
def block_numels(mesh, shape, spec) -> np.ndarray:
    """Each rank's element count of its block of a tensor of ``shape``
    under ``spec`` (``NamedSharding.block``: ceiling blocks, the last
    short or empty), for every rank at once."""
    names, sizes = tuple(mesh.axis_names), tuple(mesh.shape)
    world = math.prod(sizes)
    coords = np.stack(np.unravel_index(np.arange(world), sizes), axis=1)
    entries = [_entry_axes(e) for e in spec] + [()] * (len(shape) - len(spec))
    out = np.ones(world, np.int64)
    for n, axes in zip(shape, entries):
        idx = np.zeros(world, np.int64)
        for a in axes:
            idx = idx * sizes[names.index(a)] + coords[:, names.index(a)]
        m = -(-n // math.prod(sizes[names.index(a)] for a in axes))
        out *= np.clip(n - idx * m, 0, m)
    return out


def spec_bytes(mesh, items) -> np.ndarray:
    """Every rank's bytes of ``items`` ((shape, dtype, spec) a tensor)."""
    total = np.zeros(math.prod(mesh.shape), np.int64)
    for shape, dtype, spec in items:
        total += block_numels(mesh, tuple(shape), spec) * torch.empty((), dtype=dtype).element_size()
    return total


def train_state_items(cfg: ModelConfig, layout: Layout, opt_name: str) -> list:
    """(shape, dtype, spec) of every leaf of the train state under
    ``make_train_state_specs``: float32 masters and the optimizer's state."""
    meta = Transformer(cfg, device="meta")
    leaves = reference_leaves(meta)
    specs = make_train_state_specs(leaves, reference_axes(meta), layout, opt_name)
    state = TrainState(params=leaves, opt=opt_init(leaves, OptConfig(name=opt_name)),
                       step=torch.zeros((), dtype=torch.int32, device="meta"))
    items = []
    map_specs(lambda spec, t: items.append((tuple(t.shape), t.dtype, spec)), specs, state)
    return items


def _batch_items(cfg: ModelConfig, shape: ShapeConfig, layout: Layout) -> list:
    """(shape, dtype, spec) of a train or prefill batch: the reference's
    ``input_specs`` under its ``input_shardings``."""
    b, t = shape.global_batch, shape.seq_len
    ab, seq = layout.act_axes("act_batch"), layout.act_axes("act_seq")
    names = ("tokens", "targets") if shape.kind == "train" else ("tokens",)
    p = cfg.n_prefix_embeds if cfg.frontend == "vision_stub" else 0
    items = [((b, t - p), torch.int32, P(ab, seq)) for _ in names]
    if p:
        items.append(((b, p, cfg.d_model), torch.bfloat16, P(ab, seq, None)))
    return items


def _param_items(cfg: ModelConfig, layout: Layout, *, stored: bool, w8a16: bool) -> list:
    """(shape, dtype, spec) of every reference leaf of the bf16 parameters
    (w8a16: int8 codes, float32 scales) under the storage or compute
    specs."""
    meta = _meta_model(cfg, w8a16)
    shapes, specs = _stored_plan(meta, layout)
    if not stored:
        specs = {k: param_pspec(ax, layout) for k, ax in reference_axes(meta).items()}
    dtypes = {k: ps[0].dtype for k, ps in leaf_params(meta, buffers=True).items()}
    return [(shapes[k], torch.bfloat16 if dtypes[k] == torch.float32 and not k.endswith("w_s")
             else dtypes[k], specs[k]) for k in shapes]


def _cache_items(cfg: ModelConfig, shape: ShapeConfig, layout: Layout) -> list:
    """(shape, dtype, spec) of one device's bf16 caches at the cell's
    batch and length under ``cache_pspecs``."""
    whole = Transformer(cfg, device="meta").init_caches(shape.global_batch, shape.seq_len,
                                                       torch.bfloat16)
    items = []
    for spec, cache in zip(cache_pspecs(cfg, layout), whole):
        items += [(tuple(t.shape), t.dtype, spec[k]) for k, t in cache.items()]
    return items


# ----------------------------------------------------------------- one cell
def _empty(shape, dtype, device) -> torch.Tensor:
    """Uninitialised, but integers zeroed off the meta device (an index is
    then in range)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.zero_() if t.device.type != "meta" and not dtype.is_floating_point else t


def _tree_bytes(x, seen=None) -> int:
    """The bytes of the tensors in ``x`` (a tensor, a module's state, or
    dicts, lists and tuples of them), each tensor counted once."""
    seen = set() if seen is None else seen
    if isinstance(x, torch.nn.Module):
        x = list(x.state_dict(keep_vars=True).values())
    if isinstance(x, torch.Tensor):
        if id(x) in seen:
            return 0
        seen.add(id(x))
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tree_bytes(v, seen) for v in x)
    return 0


def layout_of(shape: ShapeConfig, arch: str, mesh, multi_pod: bool) -> Layout:
    """The reference's layout choice for a cell."""
    kind = "long" if shape.name == "long_500k" else shape.kind
    variant = VARIANT_FOR.get(arch, "default") if shape.kind == "train" else "default"
    return make_layout(kind, mesh, multi_pod=multi_pod, variant=variant)


def w8a16_on(shape: ShapeConfig, w8a16: bool | None) -> bool:
    """w8a16 weights: decode cells only, ``REPRO_W_INT8=1`` unless given."""
    if w8a16 is None:
        w8a16 = os.environ.get("REPRO_W_INT8", "0") == "1"
    return bool(w8a16) and shape.kind == "decode"


def cell_items(cfg: ModelConfig, shape: ShapeConfig, layout: Layout, *,
               opt_name: str = "adamw", w8a16: bool = False) -> tuple[list, list]:
    """(the held items: the train state, or the bf16 parameters and the
    caches; the input items: the batch, or the tokens and ``pos``), each
    (shape, dtype, spec), of one cell: specs only, so an ``AbstractMesh``
    plans them too."""
    if shape.kind == "train":
        return train_state_items(cfg, layout, opt_name), _batch_items(cfg, shape, layout)
    if shape.kind == "prefill":
        return (_param_items(cfg, layout, stored=True, w8a16=False),
                _batch_items(cfg, shape, layout))
    ab = layout.act_axes("act_batch")
    return (_param_items(cfg, layout, stored=False, w8a16=w8a16) + _cache_items(cfg, shape, layout),
            [((shape.global_batch, 1), torch.int32, P(ab, None)), ((), torch.int32, P())])


def cell_step(cfg: ModelConfig, shape: ShapeConfig, layout: Layout, *, opt_name: str = "adamw",
              w8a16: bool = False):
    """(the step, its arguments, the tensors the rank holds) of one cell on
    ``layout``'s mesh, live or fake: this rank's blocks as empty tensors
    on the mesh's device."""
    mesh, dev = layout.mesh, layout.mesh.device
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        hp = TrainHParams(opt=OptConfig(name=opt_name))
        meta = Transformer(cfg, device="meta")
        leaves = reference_leaves(meta)
        specs = make_train_state_specs(leaves, reference_axes(meta), layout, opt_name)
        whole = TrainState(params=leaves, opt=opt_init(leaves, hp.opt),
                           step=torch.zeros((), dtype=torch.int32, device="meta"))
        state = map_specs(lambda spec, x: _empty(block_shape(mesh, x.shape, spec), x.dtype, dev),
                          specs, whole)
        batch = {k: _empty(s, dt, dev) for k, (s, dt, _) in
                 zip(("tokens", "targets", "prefix_embeds"), _batch_items(cfg, shape, layout))}
        step = make_train_step(cfg, hp, layout=layout, grad_specs=specs.params)
        return step, (state, batch), state
    if shape.kind == "prefill":
        params = empty_rank_params(cfg, layout, device=dev, dtype=torch.bfloat16)
        batch = {k: _empty(s, dt, dev) for k, (s, dt, _) in
                 zip(("tokens", "prefix_embeds"), _batch_items(cfg, shape, layout))}
        return make_prefill_step(cfg, layout=layout), (params, batch), params.blocks
    model = empty_rank_params(cfg, layout, device=dev, dtype=torch.bfloat16, w8a16=w8a16)
    caches = model.init_caches(b, t, torch.bfloat16)
    tokens = _empty((model.rows(b), 1), torch.int32, dev)
    return make_serve_step(cfg, layout=layout), (model, caches, tokens, t - 1), (model, caches)


def block_shape(mesh, shape, spec) -> tuple:
    """This rank's block shape of a tensor of ``shape`` under ``spec``."""
    return tuple(b.stop - b.start for b in NamedSharding(mesh, spec).block(tuple(shape), mesh.rank))


def run_step(step, args, device) -> tuple[dict, object, dict]:
    """(the step's op report, its output, the card's readings): the step
    run once under ``OpMeter``; on the card timed after a sync, its peak
    memory read."""
    dev = torch.device(device)
    card = {}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with OpMeter() as meter:
        out = step(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        card = {"step_s": time.perf_counter() - t0, "peak_bytes": torch.cuda.max_memory_allocated(),
                "step_note": "one rank, collectives skipped (fake process group)"}
    return meter.report(), out, card


def plan_on_mesh(cfg: ModelConfig, shape: ShapeConfig, layout: Layout, *,
                 opt_name: str = "adamw", w8a16: bool = False) -> dict:
    """One cell's report (the module docstring) for this process's rank of
    ``layout``'s mesh, live or fake."""
    mesh = layout.mesh
    t0 = time.perf_counter()
    held_items, input_items = cell_items(cfg, shape, layout, opt_name=opt_name, w8a16=w8a16)
    arg = spec_bytes(mesh, held_items + input_items)
    step, args, held = cell_step(cfg, shape, layout, opt_name=opt_name, w8a16=w8a16)
    held_bytes = _tree_bytes(held)
    rep, out, card = run_step(step, args, mesh.device)
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": list(mesh.shape),
        "multi_pod": layout.multi_pod, "n_devices": math.prod(mesh.shape), "layout": layout.kind,
        "variant": layout.variant, "w8a16": w8a16, "device": mesh.device.type, "rank": mesh.rank,
        "trace_s": time.perf_counter() - t0,
        "flops_per_device": rep["flops"], "hbm_bytes_per_device": rep["hbm_bytes"],
        "collective_bytes_per_device": rep["collective_bytes"],
        "collective_bytes_total": rep["collective_total"],
        "collective_counts": rep["collective_counts"], "kernel_bytes": rep["kernel_bytes"],
        "params_total": cfg.param_count(), "params_active": cfg.active_param_count(),
        "argument_size_in_bytes": int(arg.max()),
        "argument_size_in_bytes_rank": int(arg[mesh.rank]),
        "argument_size_in_bytes_min": int(arg.min()),
        "held_bytes": held_bytes, "held_bytes_plan": int(spec_bytes(mesh, held_items)[mesh.rank]),
        "output_size_in_bytes": _tree_bytes(out), "temp_size_in_bytes": None,
        **card,
    }


def plan_cell(arch: str, shape, *, multi_pod: bool = False, device="meta", rank: int = 0,
              w8a16: bool | None = None) -> dict:
    """The counterpart of the reference's ``lower_cell``: rank ``rank``'s
    step of ``arch`` at ``shape`` (a ``ShapeConfig`` or its name) on a
    production mesh, traced in a fake world of its size (joined by this
    process; see ``fake_mesh``)."""
    cfg = get_config(arch)
    if isinstance(shape, str):
        shape = next(s for s in shapes_for(cfg) if s.name == shape)
    mesh = fake_mesh(*production_shape(multi_pod), rank=rank, device=device)
    layout = layout_of(shape, arch, mesh, multi_pod)
    return plan_on_mesh(cfg, shape, layout, opt_name=OPT_FOR.get(arch, "adamw"),
                        w8a16=w8a16_on(shape, w8a16))


# ------------------------------------------------------------ the retrieval cell
def retrieval_step(mesh, *, multi_pod: bool, n: int, dim: int, batch: int, mode: str):
    """(the retrieve step, this rank's arguments, every rank's argument
    bytes): the reference's ``lower_retrieval`` inputs, codes held as
    int32 (its Table 2 layout), the records sharded over ``model`` (16
    ways on the production meshes)."""
    from repro_torch.core.distributed_search import DistSearchConfig, make_retrieve_step

    dev = mesh.device
    shards = mesh.size("model")
    rows = -(-n // shards)
    cfg = DistSearchConfig(search_l=100, beam_width=8, n_hops=48, mode=mode)
    step = make_retrieve_step(mesh, cfg, rows_per_shard=rows, multi_pod=multi_pod)
    c, k, r, rmax = RETRIEVAL_C, RETRIEVAL_K, RETRIEVAL_R, RETRIEVAL_RMAX
    ab = ("pod", "data") if multi_pod else ("data",)
    f32, i32 = torch.float32, torch.int32
    items = [((batch, dim), f32, P(ab)), ((batch, c, k), f32, P(ab)), ((n, c), i32, P()),
             ((n, rmax), i32, P()), ((n,), i32, P()), ((rows * shards, dim), f32, P("model")),
             ((rows * shards, r), i32, P("model")), ((), i32, P()), ((batch,), i32, P(ab))]
    args = []
    for shape, dt, spec in items:
        args.append(_empty(block_shape(mesh, shape, spec), dt, dev))
    return step, tuple(args), spec_bytes(mesh, items), cfg


def plan_retrieval(*, multi_pod: bool = False, n: int = 100_000_000, dim: int = 128,
                   batch: int = 256, mode: str = "gate", device="meta", rank: int = 0) -> dict:
    """The counterpart of the reference's ``lower_retrieval``: rank
    ``rank``'s distributed GateANN retrieve step at BigANN-100M scale on
    a production mesh, traced in a fake world of its size."""
    mesh = fake_mesh(*production_shape(multi_pod), rank=rank, device=device)
    return plan_retrieval_on_mesh(mesh, multi_pod=multi_pod, n=n, dim=dim, batch=batch, mode=mode)


def plan_retrieval_on_mesh(mesh, *, multi_pod: bool, n: int, dim: int, batch: int,
                           mode: str) -> dict:
    """The retrieval cell's report for this process's rank of ``mesh``,
    live or fake."""
    t0 = time.perf_counter()
    step, args, arg, cfg = retrieval_step(mesh, multi_pod=multi_pod, n=n, dim=dim, batch=batch,
                                          mode=mode)
    rep, out, card = run_step(step, args, mesh.device)
    return {
        "arch": f"gateann-retrieval-{mode}", "shape": f"bigann{n // 1_000_000}m_b{batch}",
        "mesh": list(mesh.shape), "multi_pod": multi_pod, "n_devices": math.prod(mesh.shape),
        "device": mesh.device.type, "rank": mesh.rank, "trace_s": time.perf_counter() - t0,
        "flops_per_device": rep["flops"], "hbm_bytes_per_device": rep["hbm_bytes"],
        "collective_bytes_per_device": rep["collective_bytes"],
        "collective_bytes_total": rep["collective_total"],
        "collective_counts": rep["collective_counts"], "kernel_bytes": rep["kernel_bytes"],
        "n_hops": cfg.n_hops, "beam_width": cfg.beam_width,
        "argument_size_in_bytes": int(arg.max()), "argument_size_in_bytes_rank": int(arg[mesh.rank]),
        "argument_size_in_bytes_min": int(arg.min()), "held_bytes": _tree_bytes(args),
        "held_bytes_plan": int(arg[mesh.rank]),
        "output_size_in_bytes": _tree_bytes(out), "temp_size_in_bytes": None, **card,
    }


# --------------------------------------------------------------------- the CLI
def _child(fn, args, kwargs, results) -> None:
    try:
        results.put((True, fn(*args, **kwargs)))
    except BaseException:
        results.put((False, traceback.format_exc()))


def in_child(fn, *args, timeout_s: float, **kwargs):
    """``fn(*args, **kwargs)`` in a spawned process (a world of its own),
    its result back; raises with the child's traceback if it fails, or at
    the deadline, and the process is stopped either way.  ``fn`` must be
    importable by name."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=_child, args=(fn, args, kwargs, results), daemon=True)
    proc.start()
    try:
        deadline = time.perf_counter() + timeout_s
        while True:
            try:
                ok, got = results.get(timeout=1.0)
                break
            except queue.Empty:
                if time.perf_counter() > deadline:
                    raise TimeoutError(f"{fn.__name__} did not finish within {timeout_s} s")
                if proc.exitcode is not None:
                    raise RuntimeError(f"{fn.__name__}: the child exited with code {proc.exitcode}")
        if not ok:
            raise RuntimeError(f"{fn.__name__} failed in its child:\n{got}")
        return got
    finally:
        if proc.is_alive():
            proc.join(timeout=5.0)
        if proc.is_alive():
            proc.kill()
            proc.join()
        results.close()


def mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, device: str) -> dict:
    """One cell's report (an LM cell or a retrieval cell), planned in this
    process."""
    if arch.startswith("gateann-retrieval-"):
        return plan_retrieval(multi_pod=multi_pod, mode=arch.rsplit("-", 1)[1], device=device)
    return plan_cell(arch, shape_name, multi_pod=multi_pod, device=device)


def write_cell(tag: str, arch: str, shape_name: str, multi_pod: bool, out_dir: str,
               device: str) -> bool:
    """One cell planned in a child of its own (its world) on the
    ``CELL_TIMEOUT_S`` deadline: its JSON written under ``out_dir``, or
    the child's traceback or the deadline's beside it as ``.FAILED``.
    True when the cell was planned."""
    try:
        rep = in_child(run_cell, arch, shape_name, multi_pod, device, timeout_s=CELL_TIMEOUT_S)
    except Exception:  # recorded in .FAILED; main then exits 1
        with open(os.path.join(out_dir, tag + ".FAILED"), "w") as f:
            f.write(traceback.format_exc())
        print(f"FAILED: {tag}", flush=True)
        return False
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rep, f, indent=2)
    print(f"{tag}: flops/dev={rep['flops_per_device']:.3e} "
          f"coll/dev={rep['collective_bytes_total']:.3e} "
          f"args/dev={rep['argument_size_in_bytes'] / 2**30:.2f} GiB "
          f"trace={rep['trace_s']:.1f}s", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS) + [None])
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default="meta", choices=("meta", "cuda"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.retrieval:
        cells = [(f"gateann-retrieval-{m}", "bigann100m_b256") for m in ("gate", "post")]
    else:
        archs = list(ARCH_IDS) if args.all or args.arch is None else [args.arch]
        cells = [(a, s.name) for a in archs for s in shapes_for(get_config(a))
                 if not args.shape or s.name == args.shape]
    todo = []
    for multi_pod in ([False, True] if args.both_meshes else [args.multi_pod]):
        for arch, shape_name in cells:
            tag = f"{arch}__{shape_name}__{mesh_tag(multi_pod)}"
            if os.path.exists(os.path.join(args.out, tag + ".json")):
                print(f"skip (exists): {tag}", flush=True)
            else:
                todo.append((tag, arch, shape_name, multi_pod))
    # a child a cell, as many at once as cores; one at a time on the card, whose memory
    # one rank's step of a full-width cell may fill
    workers = 1 if args.device == "cuda" else min(len(todo), os.cpu_count() or 1)
    failures = []
    if todo:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            done = pool.map(lambda c: write_cell(*c, args.out, args.device), todo)
            failures = [c[0] for c, ok in zip(todo, list(done)) if not ok]
    if failures:
        print("FAILURES:", failures, flush=True)
        return 1
    print("dry-run complete", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
