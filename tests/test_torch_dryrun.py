"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.op_analysis``)
against a live mesh and against the reference's plans, on the CPU.

* At the smoke configs' size, one rank's step planned in a fake (2, 4)
  world (PyTorch's ``fake`` process group, meta tensors) issues exactly
  the collectives — kinds, counts and ring bytes — of the same step run
  on a live (2, 4) mesh of gloo ranks and metered the same way, for
  ``decode``, w8a16 ``decode``, ``long``, ``prefill``, ``train`` and the
  retrieve step at the tiny engine's size (n = 2,000, D = 24, B = 8),
  for the first and the last rank; both plan the same argument bytes
  from the specs, and the live rank holds exactly the planned bytes of
  its state, parameters and caches.
* For every full-width arch and shape on both production meshes (one
  arch in tier-1, the lattice ``slow``), the argument bytes equal the
  reference's per-device bytes, computed in a subprocess from its own
  ``tree_pspecs`` / ``cache_pspecs`` / ``make_train_state_specs`` with
  ``NamedSharding(...).shard_shape`` on 512 emulated devices (XLA's
  padded ceiling block where a dimension does not divide, which
  ``shard_shape`` refuses), no compilation; w8a16 decode too.
* ``op_analysis``' ring bytes of one all-reduce, one all-gather and one
  reduce-scatter over a group of 4 equal ``repro.launch.hlo_analysis.
  analyze`` of a hand-written HLO module of the same ops.
* The CLI writes a cell's JSON, and a second run skips it.

Every spawn has a deadline (``spawn_local``'s, ``dryrun.in_child``'s or
``subprocess``'s).
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, shapes_for  # noqa: E402
from repro_torch.distributed.sharding import make_layout  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, spawn_local  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT_S = 300
ARCH = "gemma3-4b"
SHAPE = (2, 4)
# the smoke-size cells: name -> (layout kind, shape, w8a16)
CELLS = {"decode": ("decode", ShapeConfig("decode_s", 16, 4, "decode"), False),
         "decode_w8a16": ("decode", ShapeConfig("decode_s", 16, 4, "decode"), True),
         "long": ("long", ShapeConfig("long_s", 16, 1, "decode"), False),
         "prefill": ("prefill", ShapeConfig("prefill_s", 32, 4, "prefill"), False),
         "train": ("train", ShapeConfig("train_s", 32, 4, "train"), False)}
RETRIEVAL = dict(n=2_000, dim=24, batch=8, mode="gate")
KEYS = ("collective_counts", "collective_bytes_per_device", "argument_size_in_bytes",
        "argument_size_in_bytes_rank", "held_bytes_plan")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_cfg():
    return dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")


def plans(mesh) -> dict:
    """Every smoke-size cell's report on this process's rank of ``mesh``."""
    out = {}
    for name, (kind, shape, w8) in CELLS.items():
        out[name] = dryrun.plan_on_mesh(smoke_cfg(), shape, make_layout(kind, mesh), w8a16=w8)
    out["retrieval"] = dryrun.plan_retrieval_on_mesh(mesh, multi_pod=False, **RETRIEVAL)
    return out


def _live_rank(mesh):
    torch.set_num_threads(1)  # a spawned rank starts with every core's thread
    return plans(mesh)


def fake_plans(ranks: tuple) -> dict:
    """The plans of ``ranks`` of a fake (2, 4) world, one world after the
    other in this process, and the first world's ``ring_ops``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {}
    for rank in ranks:
        out[rank] = plans(dryrun.fake_mesh(SHAPE, ("data", "model"), rank=rank))
        if "ring" not in out:
            out["ring"] = ring_ops()
        dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def live_and_fake():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # the two worlds at once
        fake = pool.submit(dryrun.in_child, fake_plans, (0, 7), timeout_s=TIMEOUT_S)
        live = pool.submit(spawn_local, _live_rank, SHAPE, backend="gloo", device="cpu",
                           timeout_s=TIMEOUT_S)
        return live.result(), fake.result()


@pytest.mark.parametrize("cell", list(CELLS) + ["retrieval"])
@pytest.mark.parametrize("rank", [0, 7])
def test_fake_world_plan_equals_live_gloo(live_and_fake, cell, rank):
    """The fake world's plan of a rank issues the live rank's collectives
    (kinds, counts, ring bytes) and plans its argument bytes; the live
    rank holds the planned bytes of its state, parameters and caches."""
    live, fake = live_and_fake
    got, want = fake[rank][cell], live[rank][cell]
    assert got["device"] == "meta" and want["device"] == "cpu"
    for key in KEYS:
        assert got[key] == want[key], (cell, rank, key)
    assert want["held_bytes"] == want["held_bytes_plan"], (cell, rank)
    assert sum(want["collective_counts"].values()) > 0
    if cell == "retrieval":
        assert want["collective_counts"] == {"all-reduce": 48}  # one a hop
        assert got["kernel_bytes"]["pq_lookup"] > 0 and got["kernel_bytes"]["rerank"] > 0
    if cell == "decode_w8a16":  # the stacked scales' rows gathered a layer at a time
        plain = live[rank]["decode"]["collective_counts"]["all-gather"]
        assert want["collective_counts"]["all-gather"] > plain


REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, shapes_for
    from repro.distributed.sharding import make_layout, tree_pspecs
    from repro.launch.mesh import make_production_mesh
    from repro.models import transformer as tfm
    from repro.models import zoo
    from repro.models.layers import quantize_axes, quantize_tree
    from repro.optim import OptConfig, opt_init
    from repro.serve.decode import cache_pspecs
    from repro.train.train_step import TrainHParams, TrainState, make_train_state_specs

    OPT_FOR = {"llama4-maverick-400b-a17b": "adafactor"}
    VARIANT_FOR = {"xlstm-350m": "dp_only"}
    spec = json.loads(sys.argv[1])
    is_spec = lambda s: isinstance(s, P)

    def block(mesh, s, shape):
        # NamedSharding.shard_shape where the shape divides; XLA's padded
        # (ceiling) block where it does not, which shard_shape refuses
        try:
            return NamedSharding(mesh, s).shard_shape(shape)
        except ValueError:
            sizes = dict(mesh.shape)
            entries = list(s) + [None] * (len(shape) - len(s))
            axes = [() if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in entries]
            return tuple(-(-n // int(np.prod([sizes[a] for a in ax]))) for n, ax in zip(shape, axes))

    def nbytes(mesh, structs, specs):
        got = []
        jax.tree.map(lambda s, x: got.append(int(np.prod(block(mesh, s, x.shape)))
                                             * x.dtype.itemsize), specs, structs, is_leaf=is_spec)
        return sum(got)

    def bf16(tree):
        return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16 if jnp.issubdtype(
            s.dtype, jnp.floating) else s.dtype), tree)

    out = {}
    for mp in spec["meshes"]:
        mesh = make_production_mesh(multi_pod=mp)
        for arch in spec["archs"]:
            cfg, box = get_config(arch), {}

            def grab(k):
                p, box["axes"] = tfm.init_model(k, cfg)
                return p

            params = jax.eval_shape(grab, jax.random.PRNGKey(0))
            axes = box["axes"]
            for shape in shapes_for(cfg):
                kind = "long" if shape.name == "long_500k" else shape.kind
                variant = VARIANT_FOR.get(arch, "default") if shape.kind == "train" else "default"
                layout = make_layout(kind, mesh, multi_pod=mp, variant=variant)
                ab = layout.act_axes("act_batch")
                ins = zoo.input_specs(cfg, shape)
                tag = f"{arch}/{shape.name}/{mp}"
                if shape.kind in ("train", "prefill"):
                    seq = layout.act_axes("act_seq")
                    in_specs = {k: P(ab, seq) if k != "prefix_embeds" else P(ab, seq, None)
                                for k in ins}
                    n_in = nbytes(mesh, ins, in_specs)
                if shape.kind == "train":
                    opt = OPT_FOR.get(arch, "adamw")
                    state = jax.eval_shape(lambda p: TrainState(
                        params=p, opt=opt_init(p, OptConfig(name=opt)),
                        step=jnp.zeros((), jnp.int32)), params)
                    specs = make_train_state_specs(params, axes, layout, opt)
                    out[tag] = nbytes(mesh, state, specs) + n_in
                elif shape.kind == "prefill":
                    p = bf16(params)
                    out[tag] = nbytes(mesh, p, tree_pspecs(axes, p, layout, stored=True)) + n_in
                else:
                    rest = (nbytes(mesh, ins["caches"], cache_pspecs(cfg, layout))
                            + nbytes(mesh, ins["tokens"], P(ab, None)) + 4)
                    p = bf16(params)
                    out[tag] = nbytes(mesh, p, tree_pspecs(axes, p, layout, stored=False)) + rest
                    q = jax.eval_shape(lambda p: quantize_tree(p, axes), p)
                    out[tag + "/w8"] = nbytes(mesh, q, tree_pspecs(quantize_axes(axes), q, layout,
                                                                   stored=False)) + rest
    json.dump(out, open(sys.argv[2], "w"))
""")


def reference_bytes(tmp_path, archs) -> dict:
    out = tmp_path / "ref_bytes.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE,
                           json.dumps({"archs": list(archs), "meshes": [False, True]}), str(out)],
                          env=env, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.load(open(out))


def assert_bytes_equal(ref: dict, archs) -> int:
    n = 0
    for mp in (False, True):
        shape, names = dryrun.production_shape(mp)
        mesh = AbstractMesh(names, shape)
        for arch in archs:
            cfg = get_config(arch)
            opt = dryrun.OPT_FOR.get(arch, "adamw")
            for sh in shapes_for(cfg):
                layout = dryrun.layout_of(sh, arch, mesh, mp)
                for w8 in ((False, True) if sh.kind == "decode" else (False,)):
                    held, ins = dryrun.cell_items(cfg, sh, layout, opt_name=opt, w8a16=w8)
                    got = int(dryrun.spec_bytes(mesh, held + ins).max())
                    tag = f"{arch}/{sh.name}/{mp}" + ("/w8" if w8 else "")
                    assert got == ref[tag], (tag, got, ref[tag])
                    n += 1
    return n


def test_argument_bytes_equal_reference(tmp_path):
    """gemma3-4b's every shape (w8a16 decode too) on 16 x 16 and 2 x 16 x 16:
    the plan's argument bytes a rank == the reference's per device."""
    assert assert_bytes_equal(reference_bytes(tmp_path, (ARCH,)), (ARCH,)) == 12


@pytest.mark.slow  # every arch at full width
def test_argument_bytes_equal_reference_every_arch(tmp_path):
    assert assert_bytes_equal(reference_bytes(tmp_path, ARCH_IDS), ARCH_IDS) > 60


HLO = textwrap.dedent("""
    HloModule ring

    %add (a: f32[], b: f32[]) -> f32[] {
      %a = f32[] parameter(0)
      %b = f32[] parameter(1)
      ROOT %s = f32[] add(f32[] %a, f32[] %b)
    }

    ENTRY %main (p0: f32[4,8]) -> f32[1,8] {
      %p0 = f32[4,8] parameter(0)
      %ar = f32[4,8] all-reduce(f32[4,8] %p0), replica_groups={{0,1,2,3}}, to_apply=%add
      %ag = f32[16,8] all-gather(f32[4,8] %ar), replica_groups={{0,1,2,3}}, dimensions={0}
      ROOT %rs = f32[1,8] reduce-scatter(f32[4,8] %p0), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
    }
""").lstrip()


def ring_ops() -> dict:
    """One all-reduce of (4, 8) float32, one all-gather of it and one
    reduce-scatter to (1, 8), over a group of 4 of this process's fake
    world of 8."""
    import torch.distributed as dist

    from repro_torch.launch.op_analysis import analyze

    g = dist.new_group([0, 1, 2, 3])
    x = torch.empty((4, 8), device="meta")

    def ops():
        dist.all_reduce(x, group=g)
        dist.all_gather([torch.empty_like(x) for _ in range(4)], x, group=g)
        dist.reduce_scatter(torch.empty((1, 8), device="meta"),
                            [torch.empty((1, 8), device="meta") for _ in range(4)], group=g)

    return analyze(ops)


def test_ring_bytes_equal_hlo_analysis(live_and_fake):
    """``op_analysis`` charges each collective as the reference's
    ``hlo_analysis`` does: all-reduce 2 n (g-1)/g, all-gather its output
    (g-1)/g, reduce-scatter its output (g-1)."""
    from repro.launch.hlo_analysis import analyze as hlo_analyze

    want = hlo_analyze(HLO)
    got = live_and_fake[1]["ring"]
    assert got["collective_bytes"] == want["collective_bytes"]
    assert got["collective_counts"] == want["collective_counts"]
    assert got["collective_total"] == want["collective_total"]
    assert want["collective_bytes"] == {"all-reduce": 192.0, "all-gather": 384.0,
                                        "reduce-scatter": 96.0}


def test_cli_writes_a_cell_and_skips_it_again(tmp_path, capsys):
    """The CLI's entry (``python -m repro_torch.launch.dryrun --arch ...
    --shape ...``) plans the cell in a child of its own and writes its JSON
    with the reference's keys; a second run skips it, and this process
    joins no world either time."""
    argv = ["--arch", "xlstm-350m", "--shape", "decode_32k", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 0
    rep = json.load(open(tmp_path / "xlstm-350m__decode_32k__16x16.json"))
    for key in ("arch", "shape", "mesh", "multi_pod", "n_devices", "layout", "variant",
                "flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device",
                "collective_bytes_total", "collective_counts", "params_total", "params_active",
                "argument_size_in_bytes", "output_size_in_bytes", "trace_s"):
        assert key in rep, key
    assert rep["mesh"] == [16, 16] and rep["n_devices"] == 256 and rep["layout"] == "decode"
    capsys.readouterr()
    assert dryrun.main(argv) == 0
    assert "skip (exists): xlstm-350m__decode_32k__16x16" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


def _kernel_calls():
    """(name, wrapper call on given tensors) for each kernel wrapper, and
    the inputs it takes (shape, dtype) at a tiny size."""
    from repro_torch.kernels import fused_traversal as ftk
    from repro_torch.kernels import l2_dist as l2k
    from repro_torch.kernels import pq_lookup as pqk
    from repro_torch.kernels import topk_merge as tkk

    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    b, m, c, k, n, d, w, l = 2, 5, 4, 16, 30, 8, 3, 6
    return {
        "pq_lookup_gathered": (lambda t: pqk.pq_lookup_gathered(*t),
                               [((b, c, k), f32), ((b, m, c), i32)]),
        "adc_ids": (lambda t: pqk.adc_ids(*t), [((b, c, k), f32), ((n, c), i32), ((b, m), i32)]),
        "pq_scan": (lambda t: pqk.pq_scan(*t), [((b, c, k), f32), ((n, c), i32)]),
        "l2_dist": (lambda t: l2k.l2_dist(*t), [((b, d), f32), ((b, w, d), f32)]),
        "rerank": (lambda t: l2k.rerank(*t), [((b, d), f32), ((b, w, d), f32), ((b, w), i32),
                                              ((b, w), b8), ((b, 10), i32), ((b, 10), f32),
                                              ((b,), i32)]),
        "topk_merge": (lambda t: tkk.topk_merge(*t, 4), [((b, m), f32), ((b, m), i32)]),
        "fused_traversal_round": (lambda t: ftk.fused_traversal_round(*t, mode="gate", width=w),
                                  [((b, l), i32), ((b, l), f32), ((b, l), b8), ((b, l), b8),
                                   ((b, m), i32), ((b, m, c), i32), ((b, m), b8),
                                   ((b, c, k), f32), ((b,), i32)]),
    }


@pytest.mark.parametrize("name", list(_kernel_calls()))
def test_kernel_wrappers_on_meta_launch_nothing(name):
    """On the meta device each kernel wrapper returns empty outputs of the
    plain version's shapes and dtypes, launches nothing, and charges its
    inputs and outputs to the meter (``kernels._build.charge``)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.op_analysis import OpMeter

    call, specs = _kernel_calls()[name]
    cpu = call([torch.zeros(s, dtype=dt) for s, dt in specs])
    meta_in = [torch.empty(s, dtype=dt, device="meta") for s, dt in specs]
    launches = dict(_build.LAUNCHES)
    with OpMeter() as meter:
        got = call(meta_in)
    assert dict(_build.LAUNCHES) == launches
    flat = lambda x: list(x) if isinstance(x, tuple) else [x]  # noqa: E731
    assert [(tuple(t.shape), t.dtype) for t in flat(got)] == \
        [(tuple(t.shape), t.dtype) for t in flat(cpu)]
    assert all(t.device.type == "meta" for t in flat(got))
    assert sum(meter.report()["kernel_bytes"].values()) > 0
