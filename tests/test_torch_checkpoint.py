"""The port's checkpointer (``repro_torch.checkpoint``) and launcher
(``repro_torch.launch.train``), on the CPU.

  * the reference's contracts (``tests/test_substrate.py``) on the port:
    a round trip of a small tree at two steps, and keep-2 retention of
    four async saves;
  * the format is the reference's, so each package restores the other's
    ``TrainState`` checkpoint: the port's, after two steps of each
    optimizer on the dbrx-132b smoke model (two stacked units), restores
    into the reference's state bit for bit, leaf for leaf; the
    reference's into the port's; then one more step in each package from
    the restored state agrees (loss, grad norm and lr within 2e-5 of the
    reference's step; the params equal to the reference's update of the
    restored state with the port's gradients, ``step_both``);
  * ``launch.train.run`` cut short at a checkpoint and run again resumes
    at the saved step and reaches the unbroken run's losses and final
    checkpoint bit for bit.
"""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointConfig as JCheckpointConfig  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.distributed.sharding import NULL_LAYOUT  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.optim import opt_init as jopt_init  # noqa: E402
from repro.train.train_step import TrainHParams as JHParams  # noqa: E402
from repro.train.train_step import TrainState as JTrainState  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint import CheckpointConfig, Checkpointer  # noqa: E402
from repro_torch.checkpoint.checkpointer import flatten_with_paths  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import params_to_reference  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainHParams,
    grad_leaves,
    load_state_tree,
    state_tree,
)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train import F32, cfgs, flat, make_batch, state_for  # noqa: E402

ARCH = "dbrx-132b"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the reference's own contracts, on the port
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path), keep=2))
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 3), dtype=torch.int32)}}
    ck.save(1, tree, blocking=True)
    ck.save(7, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}}, blocking=True)
    assert ck.latest_step() == 7
    got = ck.restore(tree)
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(5.0) * 2)
    assert got["b"]["c"].dtype == torch.int32
    got1 = ck.restore(tree, step=1)
    np.testing.assert_array_equal(got1["a"].numpy(), np.arange(5.0))
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(5.0) * 2)  # a new tensor each


def test_checkpoint_retention_and_async(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path), keep=2))
    tree = {"x": torch.zeros((4,))}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)  # async
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_background_save_keeps_the_values_at_the_call(tmp_path):
    """A background save of CPU tensors writes their values at the call:
    changed in place while the write may still run, as a train step
    changes its params and moments, the restore gives the old values."""
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    tree = {"w": torch.arange(1 << 20, dtype=torch.float32), "m": {"v": torch.ones((256, 256))}}
    want = {k: v.clone() for k, v in flatten_with_paths(tree).items()}
    ck.save(1, tree, blocking=False)
    tree["w"].mul_(-1.0)
    tree["m"]["v"].zero_()
    ck.wait()
    got = flatten_with_paths(ck.restore(tree))
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_restore_refuses_a_shape_that_differs(tmp_path):
    ck = Checkpointer(CheckpointConfig(directory=str(tmp_path)))
    ck.save(1, {"x": torch.zeros((4,))}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"x": torch.zeros((5,))})


def jstate_like(tree, opt: str, step: int = 0) -> JTrainState:
    jp = jax.tree.map(jnp.asarray, tree)
    return JTrainState(params=jp, opt=jopt_init(jp, JOptConfig(name=opt)),
                       step=jnp.full((), step, jnp.int32))


def step_both(state, jstate, hp, opt: str, seed: int):
    """One more step of each package from its (restored) state: loss, grad
    norm and lr agree with the reference's jitted step; and the port's new
    params equal the reference's update (op by op) of the restored state
    with the port's own clipped gradients — bit for bit for AdamW and
    8-bit AdamW, within 1e-6 of each leaf's scale for Adafactor (its means;
    ``tests/test_torch_optim.py``).  (The two packages' gradients differ in
    float32 noise, which 8-bit AdamW's step can blow up to tens of lr where a
    second moment quantises to 0, so the params are held to the update.)"""
    jcfg, cfg = cfgs(ARCH)
    jopt = JOptConfig(name=opt)
    jhp = JHParams(peak_lr=hp.peak_lr, warmup=hp.warmup, total_steps=hp.total_steps, opt=jopt)
    batch = make_batch(cfg, seed=seed)
    jnew, jm = jax.jit(jmake_train_step(jcfg, NULL_LAYOUT, jhp))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = make_train_step(cfg, hp)(state, batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **F32, err_msg=k)
    assert int(new.step) == int(jnew.step)
    grads = grad_leaves(new.params)
    paths, treedef = jax.tree_util.tree_flatten_with_path(jstate.params)
    keys = ["/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path) for path, _ in paths]
    jgrads = jax.tree.unflatten(treedef, [jnp.asarray(grads[k].numpy()) for k in keys])
    want, _ = jadam.opt_update(jgrads, jstate.opt, jstate.params, jnp.float32(float(m["lr"])), jopt)
    want = flat(want)
    for k, p in flat(params_to_reference(new.params)).items():
        if opt == "adafactor":
            assert float(np.abs(p - want[k]).max()) <= 1e-6 * float(np.abs(want[k]).max()), k
        else:
            np.testing.assert_array_equal(p, want[k], err_msg=k)


def trained(opt: str, steps: int = 2):
    state, hp = state_for(ARCH, opt=opt)
    _, cfg = cfgs(ARCH)
    step = make_train_step(cfg, hp)
    for i in range(steps):
        state, _ = step(state, make_batch(cfg, seed=10 + i))
    return state, hp


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "adamw8bit"])
def test_reference_restores_the_ports_checkpoint(tmp_path, opt):
    state, hp = trained(opt)
    Checkpointer(CheckpointConfig(directory=str(tmp_path))).save(2, state_tree(state),
                                                                 blocking=True)
    with open(tmp_path / "step_0000000002" / "manifest.json") as f:
        keys = set(json.load(f)["leaves"])
    saved = {k: v.detach().numpy().copy() for k, v in flatten_with_paths(state_tree(state)).items()}
    assert keys == set(saved)
    template = jstate_like(params_to_reference(state.params), opt)
    jstate = JCheckpointer(JCheckpointConfig(directory=str(tmp_path))).restore(template)
    assert int(jstate.step) == 2
    got = flat({"params": jstate.params, "opt": jstate.opt._asdict(), "step": jstate.step})
    assert set(got) == keys
    for k, v in got.items():
        assert v.dtype == saved[k].dtype and v.shape == saved[k].shape, k
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    step_both(state, jstate, hp, opt, seed=20)


def test_port_restores_the_references_checkpoint(tmp_path):
    donor, hp = trained("adamw")  # weights the reference then trains one step
    jcfg, cfg = cfgs(ARCH)
    jhp = JHParams(peak_lr=hp.peak_lr, warmup=hp.warmup, total_steps=hp.total_steps,
                   opt=JOptConfig(name="adamw"))
    jstate = jstate_like(params_to_reference(donor.params), "adamw", step=1)
    jstate, _ = jax.jit(jmake_train_step(jcfg, NULL_LAYOUT, jhp))(
        jstate, {k: jnp.asarray(v) for k, v in make_batch(cfg, seed=30).items()})
    JCheckpointer(JCheckpointConfig(directory=str(tmp_path))).save(2, jstate, blocking=True)
    state, _ = state_for(ARCH)  # fresh weights: all of them come from the file
    state = load_state_tree(state, Checkpointer(CheckpointConfig(directory=str(tmp_path))).restore(
        state_tree(state)))
    assert int(state.step) == 2 and state.step.dtype == torch.int32
    want = flat({"params": jstate.params, "opt": jstate.opt._asdict(), "step": jstate.step})
    got = {k: v.detach().numpy() for k, v in flatten_with_paths(state_tree(state)).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    step_both(state, jstate, hp, "adamw", seed=31)


def test_launcher_resumes_where_it_stopped(tmp_path, capsys):
    """A run cut short at step 4 of a 6-step schedule (its checkpoint
    written there) and run again to step 6 resumes at step 4; steps 4-5
    give the unbroken run's losses and its final checkpoint, bit for
    bit."""
    hp = TrainHParams(peak_lr=3e-4, warmup=1, total_steps=6, opt=OptConfig(name="adamw"))
    kw = dict(smoke=True, steps=6, seq_len=16, batch=2, hp=hp, device="cpu")
    whole = launch_train.run("gemma3-4b", ckpt_dir=str(tmp_path / "whole"), **kw)
    first = launch_train.run("gemma3-4b", ckpt_dir=str(tmp_path / "cut"), **dict(kw, steps=4))
    assert Checkpointer(CheckpointConfig(directory=str(tmp_path / "cut"))).all_steps() == [4]
    capsys.readouterr()
    rest = launch_train.run("gemma3-4b", ckpt_dir=str(tmp_path / "cut"), **kw)
    assert "resumed from step 4" in capsys.readouterr().out
    assert len(whole) == 6 and first + rest == whole
    for name in ("whole", "cut"):
        assert Checkpointer(CheckpointConfig(directory=str(tmp_path / name))).latest_step() == 6
    a = tmp_path / "whole" / "step_0000000006"
    b = tmp_path / "cut" / "step_0000000006"
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b))
    for f in files:
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a / f), np.load(b / f), err_msg=f)
