"""The port's ZeRO-sharded train step (``train.make_train_step`` with a
``train`` layout on a live mesh) on gloo ranks on the CPU, against one
device and against the reference.

One module fixture runs, at once, the reference in a subprocess with 8
emulated XLA devices and ``spawn_local`` meshes of gloo ranks:

* (2, 4), B = 4, T = 32 (the reference's ``tests/test_distributed.py``
  contracts at their own shapes): deepseek-coder-33b's smoke config in
  float32 with AdamW loses loss over 4 steps on one batch; gemma3-4b's
  smoke config's sharded loss is within rtol 2e-4 of one device's and of
  the reference's ``lm_loss`` under its (2, 4) train layout on the same
  weights; internvl2-2b's step with a vision prefix;
* (2, 2): one step of each optimizer (gemma3-4b), of each layer kind
  (dbrx-132b's MoE with its Switch aux loss over the whole batch,
  recurrentgemma-9b's RG-LRU, xlstm-350m under ``dp_only``),
  ``REPRO_GRAD_SHARD=1`` against ``=0``, and a checkpoint;
* then the same four processes as a (1, 4) mesh: that checkpoint
  restored with ``shardings=`` and stepped.

Bounds against one device's step from the same weights and batch: loss
and grad norm within rtol 2e-5 (the LM's float32 tolerance; the ranks
sum the loss terms and gradients in another order), the updated params
by ``test_torch_train.assert_step_close``'s rule (within 1e-6 of a
leaf's scale plus 2.2 lr, at most 1 in 10,000 elements past 1e-6 scale
+ lr / 100).  The checkpoint restores bit for bit on one device, on
(1, 4) and in the reference's ``Checkpointer``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointConfig, Checkpointer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.sharding import NamedSharding, make_layout, named_shardings  # noqa: E402
from repro_torch.launch import AbstractMesh, spawn_local  # noqa: E402
from repro_torch.models import params_to_reference  # noqa: E402
from repro_torch.models.convert import reference_axes, reference_leaves  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainHParams, load_state_tree, make_train_state, make_train_state_specs, make_train_step,
    state_tree)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT_S = 240
B, T = 4, 32
F32 = dict(rtol=2e-5, atol=2e-5)
# (name, arch, optimizer, variant, REPRO_GRAD_SHARD) of the (2, 2) cases
ONE_STEP = [("adamw", "gemma3-4b", "adamw", "default", "1"),
            ("adafactor", "gemma3-4b", "adafactor", "default", "1"),
            ("adamw8bit", "gemma3-4b", "adamw8bit", "default", "1"),
            ("grad_shard_0", "gemma3-4b", "adamw", "default", "0"),
            ("moe", "dbrx-132b", "adamw", "default", "1"),
            ("rglru", "recurrentgemma-9b", "adamw", "default", "1"),
            ("xlstm_dp_only", "xlstm-350m", "adamw", "dp_only", "1")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def hp_of(opt: str) -> TrainHParams:
    return TrainHParams(peak_lr=1e-3, warmup=2, total_steps=10, opt=OptConfig(name=opt))


def batch_of(cfg, seed: int = 0) -> dict:
    """B x T tokens and targets; a vision-stub config's first
    ``n_prefix_embeds`` positions are its prefix (no loss there)."""
    rng = np.random.default_rng(seed)
    t = T - cfg.n_prefix_embeds if cfg.frontend == "vision_stub" else T
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = (rng.normal(size=(B, cfg.n_prefix_embeds, cfg.d_model))
                                  * 0.02).astype(np.float32)
    return batch


def specs_of(cfg, layout, opt: str):
    meta = Transformer(cfg, device="meta")
    return make_train_state_specs(reference_leaves(meta), reference_axes(meta), layout, opt)


def sharded_steps(mesh, arch: str, opt: str, variant: str, steps: int, *, from_step: int = 1,
                  batch_seed: int = 0):
    """``steps`` sharded steps on one batch from the seeded init, the state
    at step ``from_step`` (its lr above 0): (metrics, this rank's master
    blocks)."""
    cfg, hp = cfg_of(arch), hp_of(opt)
    layout = make_layout("train", mesh, variant=variant)
    state = make_train_state(cfg, hp, torch.Generator().manual_seed(0), layout=layout)
    state = state._replace(step=torch.full((), from_step, dtype=torch.int32))
    step = make_train_step(cfg, hp, layout=layout, grad_specs=specs_of(cfg, layout, opt).params)
    rows = []
    for _ in range(steps):
        state, m = step(state, batch_of(cfg, batch_seed))
        rows.append({k: float(v) for k, v in m.items()})
    return rows, state


def _rank_2x4(mesh):
    torch.set_num_threads(1)  # a spawned rank starts with every core's thread
    out = {"deepseek": sharded_steps(mesh, "deepseek-coder-33b", "adamw", "default", 4)[0]}
    out["gemma_loss"] = sharded_steps(mesh, "gemma3-4b", "adamw", "default", 1)[0][0]["loss"]
    out["vision"] = sharded_steps(mesh, "internvl2-2b", "adamw", "default", 1)[0][0]
    return out


def _rank_2x2(mesh, ckpt_dir: str):
    torch.set_num_threads(1)
    out = {}
    for name, arch, opt, variant, grad_shard in ONE_STEP:
        os.environ["REPRO_GRAD_SHARD"] = grad_shard
        rows, state = sharded_steps(mesh, arch, opt, variant, 1)
        out[name] = {"rows": rows, "params": {k: v.clone() for k, v in state.params.items()}}
        if name == "adamw":
            cfg, hp = cfg_of(arch), hp_of(opt)
            shardings = named_shardings(mesh, specs_of(cfg, make_layout("train", mesh), opt))
            Checkpointer(CheckpointConfig(ckpt_dir, async_write=False)).save(
                2, state, shardings=shardings)  # blocking: ends in a barrier
    os.environ["REPRO_GRAD_SHARD"] = "1"
    # the same four processes as a (1, 4) mesh: the step's collectives run
    # on the world, so a mesh of the same world with another shape is one
    # the checkpoint must restore on
    remeshed = dataclasses.replace(mesh, shape=(1, 4), coords=(0, mesh.rank), groups={})
    out["1x4"] = _restore_and_step(remeshed, ckpt_dir)
    return out


def _restore_and_step(mesh, ckpt_dir: str):
    """The (2, 2) checkpoint restored on ``mesh`` (``shardings=``), then
    one more step."""
    cfg, hp = cfg_of("gemma3-4b"), hp_of("adamw")
    layout = make_layout("train", mesh)
    specs = specs_of(cfg, layout, "adamw")
    state = make_train_state(cfg, hp, torch.Generator().manual_seed(0), layout=layout)
    state = Checkpointer(CheckpointConfig(ckpt_dir)).restore(
        state, shardings=named_shardings(mesh, specs))
    restored = {k: v.clone() for k, v in state.params.items()}
    step = make_train_step(cfg, hp, layout=layout, grad_specs=specs.params)
    state, m = step(state, batch_of(cfg, 1))
    return {"restored": restored, "step": int(state.step) - 1, "loss": float(m["loss"])}


REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_smoke_config
    from repro.distributed.sharding import NULL_LAYOUT, make_layout
    from repro.models import transformer as tfm

    d = sys.argv[1]
    cfg = dataclasses.replace(get_smoke_config("gemma3-4b"), dtype="float32")
    flat = dict(np.load(d + "/weights.npz"))
    struct = jax.eval_shape(lambda k: tfm.init_model(k, cfg)[0], jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(struct)
    key = lambda k: str(getattr(k, "key", getattr(k, "idx", k)))
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat["/".join(key(k) for k in path)]) for path, _ in leaves])
    batch = {k: jnp.asarray(v) for k, v in np.load(d + "/batch.npz").items()}
    # Auto axes: this jax's make_mesh defaults to Explicit ones, which the
    # reference's with_sharding_constraint refuses
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {"single": float(jax.jit(lambda p, b: tfm.lm_loss(p, cfg, NULL_LAYOUT, b))(params, batch)),
           "sharded": float(jax.jit(lambda p, b: tfm.lm_loss(p, cfg, make_layout("train", mesh),
                                                             b))(params, batch))}
    json.dump(out, open(d + "/ref_loss.json", "w"))
""")

REFERENCE_RESTORE = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.checkpointer import CheckpointConfig, Checkpointer
    from repro.configs import get_smoke_config
    from repro.models import transformer as tfm
    from repro.optim import OptConfig, opt_init
    from repro.train.train_step import TrainState

    d = sys.argv[1]
    cfg = dataclasses.replace(get_smoke_config("gemma3-4b"), dtype="float32")
    template = jax.eval_shape(lambda k: TrainState(
        params=tfm.init_model(k, cfg)[0], opt=opt_init(tfm.init_model(k, cfg)[0],
        OptConfig(name="adamw")), step=jnp.zeros((), jnp.int32)), jax.random.PRNGKey(0))
    state = Checkpointer(CheckpointConfig(d + "/ckpt")).restore(template)
    key = lambda k: str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    np.savez(d + "/ref_restored.npz", **{"/".join(key(k) for k in p): np.asarray(v)
                                        for p, v in leaves})
""")


def _reference(script: str, d: str) -> subprocess.Popen:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", script, d], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc: subprocess.Popen) -> None:
    _, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err


def flat_ref(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat_ref(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat_ref(sub, prefix + (str(i),)).items()}
    return {"/".join(prefix): np.asarray(tree)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded_train"))
    gemma = cfg_of("gemma3-4b")
    model = make_train_state(gemma, hp_of("adamw"), torch.Generator().manual_seed(0),
                             device="cpu").params
    np.savez(os.path.join(d, "weights.npz"), **flat_ref(params_to_reference(model)))
    np.savez(os.path.join(d, "batch.npz"), **batch_of(gemma))
    ref = _reference(REFERENCE, d)
    try:
        r24 = spawn_local(_rank_2x4, (2, 4), backend="gloo", device="cpu", timeout_s=TIMEOUT_S)
        r22 = spawn_local(_rank_2x2, (2, 2), backend="gloo", device="cpu", timeout_s=TIMEOUT_S,
                          args=(os.path.join(d, "ckpt"),))
    finally:
        _wait(ref)
    _wait(_reference(REFERENCE_RESTORE, d))
    return {"dir": d, "2x4": r24, "2x2": r22, "1x4": [r["1x4"] for r in r22],
            "ref_loss": json.load(open(os.path.join(d, "ref_loss.json")))}


def single_steps(arch: str, opt: str, steps: int, *, from_step: int = 1, batch_seed: int = 0):
    cfg, hp = cfg_of(arch), hp_of(opt)
    state = make_train_state(cfg, hp, torch.Generator().manual_seed(0), device="cpu")
    state = state._replace(step=torch.full((), from_step, dtype=torch.int32))
    step = make_train_step(cfg, hp)
    rows = []
    for _ in range(steps):
        state, m = step(state, batch_of(cfg, batch_seed))
        rows.append({k: float(v) for k, v in m.items()})
    return rows, state


def gather(ranks: list, blocks_of, arch: str, opt: str, mesh: AbstractMesh, variant="default"):
    """The full leaves from every rank's blocks (``blocks_of(rank result)``)."""
    cfg = cfg_of(arch)
    specs = specs_of(cfg, make_layout("train", mesh, variant=variant), opt).params
    shapes = {k: tuple(v.shape) for k, v in reference_leaves(Transformer(cfg, device="meta")).items()}
    full = {k: torch.full(shape, float("nan")) for k, shape in shapes.items()}
    for r, res in enumerate(ranks):
        for k, block in blocks_of(res).items():
            full[k][NamedSharding(mesh, specs[k]).block(shapes[k], r)] = block
    assert not any(bool(v.isnan().any()) for v in full.values())
    return full


def assert_step_close(got: dict, want: dict, lr: float) -> None:
    """``test_torch_train.assert_step_close``'s rule on leaf dicts."""
    apart, n = 0, 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        scale = float(w.abs().max())
        assert float(d.max()) <= 1e-6 * scale + 2.2 * lr, k
        apart += int((d > 1e-6 * scale + 1e-2 * lr).sum())
        n += d.numel()
    assert apart <= n // 10_000, (apart, n)


def test_deepseek_loss_falls_on_2x4(results):
    """The reference's ``test_train_step_sharded_2x4`` on the port."""
    for r in results["2x4"]:
        losses = [x["loss"] for x in r["deepseek"]]
        assert len(losses) == 4 and all(np.isfinite(losses))
        assert losses[-1] < losses[0], losses
        assert r["deepseek"] == results["2x4"][0]["deepseek"]  # every rank the same


def test_gemma_sharded_loss_equals_single_and_reference(results):
    """The reference's ``test_sharded_equals_single_device``: the (2, 4)
    loss within rtol 2e-4 of one device's and of the reference's sharded
    loss on the same weights."""
    got = results["2x4"][0]["gemma_loss"]
    single = single_steps("gemma3-4b", "adamw", 1)[0][0]["loss"]
    np.testing.assert_allclose(got, single, rtol=2e-4)
    np.testing.assert_allclose(got, results["ref_loss"]["sharded"], rtol=2e-4)
    np.testing.assert_allclose(results["ref_loss"]["sharded"], results["ref_loss"]["single"],
                               rtol=2e-4)


def test_vision_prefix_step_equals_single_device(results):
    """internvl2-2b's vision prefix (8 positions, no loss) on (2, 4): the
    24 token positions split 6 a ``model`` rank after the prefix."""
    want = single_steps("internvl2-2b", "adamw", 1)[0][0]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(results["2x4"][0]["vision"][k], want[k], **F32, err_msg=k)


@pytest.mark.parametrize("case", [c[0] for c in ONE_STEP])
def test_one_step_equals_single_device(results, case):
    name, arch, opt, variant, _ = next(c for c in ONE_STEP if c[0] == case)
    got = results["2x2"]
    rows, state = single_steps(arch, opt, 1)
    for r in got:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r[name]["rows"][0][k], rows[0][k], **F32, err_msg=k)
    full = gather(got, lambda res: res[name]["params"], arch, opt,
                  AbstractMesh(("data", "model"), (2, 2)), variant)
    assert_step_close(full, state_tree(state).params, rows[0]["lr"])


def test_grad_shard_0_equals_1(results):
    """``REPRO_GRAD_SHARD=0`` (all-reduce, clip, slice) against ``=1``
    (reduce-scatter into the blocks): the same step within float32."""
    a, b = results["2x2"][0]["adamw"], results["2x2"][0]["grad_shard_0"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(a["rows"][0][k], b["rows"][0][k], **F32, err_msg=k)
    assert_step_close(b["params"], a["params"], a["rows"][0]["lr"])


def test_checkpoint_restores_across_meshes_and_in_the_reference(results):
    """The (2, 2) run's checkpoint: one device restores it bit for bit
    equal to the gathered blocks; the (1, 4) mesh restores its own blocks
    and steps on within rtol 2e-5 of one device from the same checkpoint;
    the reference's ``Checkpointer`` restores the same values."""
    d = results["dir"]
    mesh22, mesh14 = AbstractMesh(("data", "model"), (2, 2)), AbstractMesh(("data", "model"), (1, 4))
    full22 = gather(results["2x2"], lambda res: res["adamw"]["params"], "gemma3-4b", "adamw", mesh22)
    cfg, hp = cfg_of("gemma3-4b"), hp_of("adamw")
    one = make_train_state(cfg, hp, torch.Generator().manual_seed(1), device="cpu")
    one = load_state_tree(one, Checkpointer(CheckpointConfig(os.path.join(d, "ckpt"))).restore(
        state_tree(one)))
    assert int(one.step) == 2
    for k, v in state_tree(one).params.items():
        assert torch.equal(v, full22[k]), k
    full14 = gather(results["1x4"], lambda res: res["restored"], "gemma3-4b", "adamw", mesh14)
    for k, v in full14.items():
        assert torch.equal(v, full22[k]), k
    _, m = make_train_step(cfg, hp)(one, batch_of(cfg, 1))
    for r in results["1x4"]:
        assert r["step"] == 2
        np.testing.assert_allclose(r["loss"], float(m["loss"]), **F32)
    ref = np.load(os.path.join(d, "ref_restored.npz"))
    for k, v in full22.items():
        np.testing.assert_array_equal(ref["params/" + k], v.numpy(), err_msg=k)
    assert int(ref["step"]) == 2


def test_other_layouts_and_abstract_meshes_refuse_to_execute():
    """The train step executes only the train layout, and only on a live
    mesh; the serving steps execute their own layouts on a live mesh only
    (an ``AbstractMesh`` plans, it joins no world), and so does
    ``shard_model``, w8a16 weights included (they execute on a live mesh:
    ``test_torch_sharded_serve.py``)."""
    from repro_torch.models.convert import shard_model
    from repro_torch.models.layers import quantize_model
    from repro_torch.serve import make_prefill_step, make_serve_step

    cfg, hp = cfg_of("gemma3-4b"), hp_of("adamw")
    mesh = AbstractMesh(("data", "model"), (2, 2))
    with pytest.raises(ValueError, match="joins no world"):
        make_train_step(cfg, hp, layout=make_layout("train", mesh))
    for kind in ("prefill", "decode", "long"):
        with pytest.raises(NotImplementedError):
            make_train_step(cfg, hp, layout=make_layout(kind, mesh))
        step = make_prefill_step if kind == "prefill" else make_serve_step
        with pytest.raises(ValueError, match="joins no world"):
            step(cfg, layout=make_layout(kind, mesh))
    model = make_train_state(cfg, hp, torch.Generator().manual_seed(0), device="cpu").params
    with pytest.raises(ValueError, match="joins no world"):
        shard_model(quantize_model(model), make_layout("decode", mesh))


def test_moe_aux_over_batch_shards_equals_the_whole_batch():
    """The Switch aux loss is a product of two batch means: two batch
    shards whose routed shares are replaced by the whole batch's
    (``MoE.batch_mean``, as the sharded step sets it) average to the
    whole batch's aux and z-loss; each shard's own shares do not."""
    from repro_torch.models.moe import MoE

    cfg = cfg_of("dbrx-132b")
    moe = MoE(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    x = torch.randn(4, T, cfg.d_model, generator=torch.Generator().manual_seed(4))
    whole = moe(x)[1]
    halves = (x[:2], x[2:])
    frac = [moe.route(h).onehot.sum(dim=2).mean(dim=(0, 1)) for h in halves]
    local = [moe(h)[1] for h in halves]
    moe.batch_mean = lambda f: (frac[0] + frac[1]) / 2
    shared = [moe(h)[1] for h in halves]
    for k in ("moe_aux", "moe_zloss"):
        np.testing.assert_allclose(float((shared[0][k] + shared[1][k]) / 2), float(whole[k]),
                                   rtol=1e-6, err_msg=k)
    gap = abs(float((local[0]["moe_aux"] + local[1]["moe_aux"]) / 2 - whole["moe_aux"]))
    assert gap > 1e-3 * float(whole["moe_aux"]), gap
