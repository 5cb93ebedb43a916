"""The port's sharding plans against the reference's, on the CPU.

One subprocess runs the reference on emulated XLA devices (8 for the
smoke configs' (2, 4) and (2, 2, 2) meshes; 512 for the production
16 x 16 and 2 x 16 x 16 meshes at full width, marked slow) and writes,
for every arch of ``configs/registry.py``: ``init_model``'s axes tree
(under ``jax.eval_shape``) and ``quantize_axes``' tree, the leaves'
shapes, and the specs of every layout (``train`` / ``prefill`` /
``decode`` / ``long``), variant (``default`` / ``dp_only``) and mesh
(``multi_pod`` off on the 2-D mesh, on on the 3-D one):
``tree_pspecs`` stored and compute, of the float32 and the w8a16 tree,
``make_train_state_specs`` for AdamW, Adafactor and 8-bit AdamW, and
``cache_pspecs`` with ``REPRO_KV_INT8`` off and on.  The port plans the
same from ``Transformer(cfg, device="meta")`` (``reference_axes``,
``reference_leaves``, ``quantize_model``) on ``AbstractMesh``es, and
every spec must be equal entry for entry (``None``, or the tuple of axis
names; a single name counts as a tuple of one).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    NULL_LAYOUT, NamedSharding, PartitionSpec, lshard, make_layout, tree_pspecs)
from repro_torch.launch.mesh import AbstractMesh, abstract_production_mesh  # noqa: E402
from repro_torch.models.convert import reference_axes, reference_leaves  # noqa: E402
from repro_torch.models.layers import quantize_model  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve.decode import cache_pspecs  # noqa: E402
from repro_torch.train.train_step import make_train_state_specs  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KINDS = ("train", "prefill", "decode", "long")
VARIANTS = ("default", "dp_only")
OPTS = ("adamw", "adafactor", "adamw8bit")
SMOKE_MESHES = {"2d": ((2, 4), ("data", "model")), "3d": ((2, 2, 2), ("pod", "data", "model"))}
FULL_MESHES = {"2d": ((16, 16), ("data", "model")), "3d": ((2, 16, 16), ("pod", "data", "model"))}

REFERENCE = textwrap.dedent("""
    import json, os, sys
    import jax, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.configs import ARCH_IDS, get_config, get_smoke_config
    from repro.distributed.sharding import make_layout, tree_pspecs
    from repro.models import transformer as tfm
    from repro.models.layers import quantize_axes, quantize_tree
    from repro.serve.decode import cache_pspecs
    from repro.train.train_step import make_train_state_specs

    spec = json.loads(sys.argv[1])

    def key(k):
        for a in ("key", "idx", "name"):
            if hasattr(k, a):
                return str(getattr(k, a))
        return str(k)

    def flat(tree, leaf):
        got = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]
        return {"/".join(key(k) for k in path): v for path, v in got}

    is_axes = lambda t: isinstance(t, tuple) and all(isinstance(x, (str, type(None))) for x in t)
    is_spec = lambda s: isinstance(s, P)
    norm = lambda s: [None if e is None else ([e] if isinstance(e, str) else list(e)) for e in s]
    specs = lambda tree: {k: norm(v) for k, v in flat(tree, is_spec).items()}
    out = {}
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch) if spec["smoke"] else get_config(arch)
        box = {}

        def grab(k):
            p, a = tfm.init_model(k, cfg)
            box["axes"] = a
            return p

        params = jax.eval_shape(grab, jax.random.PRNGKey(0))
        axes = box["axes"]
        qparams = jax.eval_shape(lambda p: quantize_tree(p, axes), params)
        qaxes = quantize_axes(axes)
        o = {"axes": {k: list(v) for k, v in flat(axes, is_axes).items()},
             "qaxes": {k: list(v) for k, v in flat(qaxes, is_axes).items()},
             "shapes": {k: list(v.shape) for k, v in flat(params, None).items()}, "cases": {}}
        for mname, (shape, names) in spec["meshes"].items():
            mesh = jax.make_mesh(tuple(shape), tuple(names))
            for kind in ("train", "prefill", "decode", "long"):
                for variant in ("default", "dp_only"):
                    lay = make_layout(kind, mesh, multi_pod=len(shape) == 3, variant=variant)
                    c = {}
                    for stored in (True, False):
                        c[f"params_{stored}"] = specs(tree_pspecs(axes, params, lay, stored))
                        c[f"qparams_{stored}"] = specs(tree_pspecs(qaxes, qparams, lay, stored))
                    for opt in ("adamw", "adafactor", "adamw8bit"):
                        c["state_" + opt] = specs(make_train_state_specs(params, axes, lay, opt))
                    for kv8 in ("0", "1"):
                        os.environ["REPRO_KV_INT8"] = kv8
                        c["cache_" + kv8] = specs(cache_pspecs(cfg, lay))
                    o["cases"][f"{mname}/{kind}/{variant}"] = c
        out[arch] = o
    json.dump(out, open(sys.argv[2], "w"))
""")


def run_reference(tmp_path, smoke: bool, meshes: dict, n_dev: int):
    """Start the reference's subprocess; returns a function that waits
    for it and returns its JSON."""
    out = tmp_path / "ref.json"
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n_dev}",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    spec = json.dumps({"smoke": smoke, "meshes": meshes})
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, spec, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err
        return json.load(open(out))

    return wait


def norm(s: PartitionSpec) -> list:
    return [None if e is None else ([e] if isinstance(e, str) else list(e)) for e in s]


def flat_specs(tree, prefix=()) -> dict:
    """{path: normalised spec} of a tree of NamedTuples, dicts and lists
    whose leaves are ``PartitionSpec``."""
    if isinstance(tree, PartitionSpec):
        return {"/".join(prefix): norm(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    else:
        items = list(enumerate(tree))
    return {k: v for key, sub in items for k, v in flat_specs(sub, prefix + (str(key),)).items()}


def port_plan(cfg, meshes: dict, monkeypatch) -> dict:
    """The port's counterpart of one arch's reference JSON."""
    model = Transformer(cfg, device="meta")
    leaves, axes = reference_leaves(model), reference_axes(model)
    qmodel = quantize_model(Transformer(cfg, device="meta"))
    qaxes = reference_axes(qmodel)
    qleaves = _named_leaves(qmodel)
    o = {"axes": {k: list(v) for k, v in axes.items()},
         "qaxes": {k: list(v) for k, v in qaxes.items()},
         "shapes": {k: list(v.shape) for k, v in leaves.items()}, "cases": {}}
    for mname, (shape, names) in meshes.items():
        mesh = AbstractMesh(tuple(names), tuple(shape))
        for kind in KINDS:
            for variant in VARIANTS:
                lay = make_layout(kind, mesh, multi_pod=len(shape) == 3, variant=variant)
                c = {}
                for stored in (True, False):
                    c[f"params_{stored}"] = flat_specs(tree_pspecs(axes, leaves, lay, stored))
                    c[f"qparams_{stored}"] = flat_specs(tree_pspecs(qaxes, qleaves, lay, stored))
                for opt in OPTS:
                    c["state_" + opt] = flat_specs(make_train_state_specs(leaves, axes, lay, opt))
                for kv8 in ("0", "1"):
                    monkeypatch.setenv("REPRO_KV_INT8", kv8)
                    c["cache_" + kv8] = flat_specs(cache_pspecs(cfg, lay))
                o["cases"][f"{mname}/{kind}/{variant}"] = c
    return o


def _named_leaves(model) -> dict:
    """A w8a16 meta model's leaves by the reference's paths: each unit's
    tensors stacked (shapes only), as ``quantize_tree`` lays them out."""
    cfg = model.cfg
    n_unit = len(cfg.pattern_unit)
    out = {"embed": model.embed, "final_norm/scale": model.final_norm.scale}
    if model.unembed is not None:
        out["unembed"] = model.unembed
    for pos in range(n_unit if cfg.n_units else 0):
        for name, t in model.layers[pos].state_dict(keep_vars=True).items():
            out[f"units/{pos}/" + name.replace(".", "/")] = torch.empty(
                (cfg.n_units, *t.shape), device="meta")
    for i, layer in enumerate(model.layers[cfg.n_units * n_unit:]):
        for name, t in layer.state_dict(keep_vars=True).items():
            out[f"leftover/{i}/" + name.replace(".", "/")] = t
    return out


def assert_plans_equal(ref: dict, cfg_of, meshes: dict, monkeypatch) -> int:
    n = 0
    assert sorted(ref) == sorted(ARCH_IDS)
    for arch in ARCH_IDS:
        got, want = port_plan(cfg_of(arch), meshes, monkeypatch), ref[arch]
        for part in ("axes", "qaxes", "shapes"):
            assert got[part] == want[part], (arch, part)
        assert got["cases"].keys() == want["cases"].keys()
        for case, specs in want["cases"].items():
            for what, tree in specs.items():
                assert got["cases"][case][what] == tree, (arch, case, what)
                n += len(tree)
    return n


def test_plans_equal_reference_smoke(tmp_path, monkeypatch):
    """Every arch's smoke config on the (2, 4) and (2, 2, 2) meshes."""
    wait = run_reference(tmp_path, True, SMOKE_MESHES, 8)
    ref = wait()
    assert assert_plans_equal(ref, get_smoke_config, SMOKE_MESHES, monkeypatch) > 10_000


@pytest.mark.slow  # every arch at full width on 512 emulated devices
def test_plans_equal_reference_full_width(tmp_path, monkeypatch):
    """Every arch at full width on the production meshes."""
    wait = run_reference(tmp_path, False, FULL_MESHES, 512)
    ref = wait()
    assert assert_plans_equal(ref, get_config, FULL_MESHES, monkeypatch) > 10_000


def test_abstract_production_mesh_plans_without_memory():
    """The production meshes join no world, and a full-width plan reads
    shapes only: gemma3-4b's 16 x 16 storage blocks split each leaf 256
    ways where a dimension divides."""
    mesh = abstract_production_mesh()
    assert (mesh.axis_names, mesh.shape) == (("data", "model"), (16, 16))
    assert abstract_production_mesh(multi_pod=True).shape == (2, 16, 16)
    model = Transformer(get_config("gemma3-4b"), device="meta")
    leaves = reference_leaves(model)
    specs = tree_pspecs(reference_axes(model), leaves, make_layout("train", mesh), True)
    assert specs["embed"] == PartitionSpec(("data", "model"), None)
    assert all(t.device.type == "meta" for t in leaves.values())
    with pytest.raises(ValueError, match="differ in length"):
        AbstractMesh(("data",), (2, 2))


def test_lshard_is_the_identity_and_named_sharding_blocks():
    """``lshard`` returns its input (the executor places data) and checks
    its rank against the names; a ``NamedSharding``'s blocks tile the
    tensor, the first axis of an entry the major one, and a replicated
    axis's coordinate 0 owns each block."""
    lay = make_layout("train", AbstractMesh(("data", "model"), (2, 4)))
    x = torch.zeros(4, 8, 3)
    assert lshard(x, lay, ("act_batch", "act_seq", "embed")) is x
    assert lshard(x, NULL_LAYOUT, ("a",)) is x
    with pytest.raises(ValueError):
        lshard(x, lay, ("act_batch", "act_seq"))
    mesh = AbstractMesh(("data", "model"), (2, 4))
    sh = NamedSharding(mesh, PartitionSpec(("data", "model"), None))
    full = torch.arange(16 * 3).reshape(16, 3)
    blocks = [full[sh.block((16, 3), r)] for r in range(8)]
    assert torch.equal(torch.cat(blocks), full)  # rank r = data * 4 + model holds rows 2r, 2r + 1
    assert sh.shard_shape((16, 3)) == (2, 3) and sh.full_shape((2, 3)) == (16, 3)
    half = NamedSharding(mesh, PartitionSpec(None, "model"))
    assert [half.owns(r) for r in range(8)] == [True] * 4 + [False] * 4
    # a dimension that does not divide splits as XLA splits it: ceiling-sized
    # blocks, the last ones short or empty, shard_shape the padded block
    assert sh.shard_shape((12, 3)) == (2, 3)
    uneven = [full[:12][sh.block((12, 3), r)] for r in range(8)]
    assert [len(b) for b in uneven] == [2, 2, 2, 2, 2, 2, 0, 0]
    assert torch.equal(torch.cat(uneven), full[:12])
