"""The port's loss and train step (``Transformer.forward_train``,
``chunked_xent``, ``lm_loss``, ``train.make_train_step``) against the
reference's, on the CPU, in float32, with the port's seeded weights
carried into the reference's layout (``params_to_reference``).

Tolerances:
  * the loss: rtol = atol = 2e-5, the LM's float32 tolerance (measured at
    most 1.9e-6 abs, at losses near 7.8);
  * gradients by autograd against ``jax.value_and_grad``: every leaf
    within 2e-5 of the whole tree's largest gradient magnitude, and
    rtol 2e-5 (measured: 1.1e-5 of the largest on gemma3-4b, 1.8e-6 to
    2.7e-6 on the others; the sLSTM's input-gate bias, whose gradient is
    5e-9 at most, is the only leaf whose own-scale error is large, 7.6e-9
    abs);
  * one ``make_train_step`` step (AdamW): loss, grad norm and lr as
    above (lr equal); the updated params within 1e-6 of each leaf's
    largest magnitude plus lr / 100, but for at most 1 in 10,000
    elements where float32 noise tips Adam's normalised step (all within
    2.2 lr; 17 of 291,776 on gemma3-4b, ``assert_step_close``);
  * ``REPRO_REMAT`` (off, full, dots) and the checkpointing of each unit
    change memory only: loss and gradients equal bit for bit.

One smoke config of each layer kind: gemma3-4b (attention, a unit of 6
and a leftover layer), dbrx-132b (MoE, with the aux terms), recurrentgemma
-9b (RG-LRU), xlstm-350m (mLSTM and sLSTM), internvl2-2b (a vision
prefix, its targets -1).  The bf16 loss and gradients are marked slow.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.distributed.sharding import NULL_LAYOUT  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.train.train_step import TrainHParams as JHParams  # noqa: E402
from repro.train.train_step import TrainState as JTrainState  # noqa: E402
from repro.train.train_step import make_train_step as jmake_train_step  # noqa: E402
from repro.optim import opt_init as jopt_init  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_to_reference  # noqa: E402
from repro_torch.models.transformer import chunked_xent, lm_loss  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.train import TrainHParams, make_train_state, make_train_step  # noqa: E402
from repro_torch.train.train_step import grad_leaves  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
KINDS = ["gemma3-4b", "dbrx-132b", "recurrentgemma-9b", "xlstm-350m", "internvl2-2b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch: str, dtype: str = "float32"):
    return (dataclasses.replace(jsmoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def make_batch(cfg, b: int = 2, t: int = 16, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tt = t - cfg.n_prefix_embeds if cfg.frontend == "vision_stub" else t
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, tt)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, tt)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = (rng.normal(size=(b, cfg.n_prefix_embeds, cfg.d_model))
                                  * 0.02).astype(np.float32)
    return batch


def flat(tree, prefix=()) -> dict:
    """A reference tree as {path: numpy}, the path's keys joined by '/'."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, prefix + (str(i),)).items()}
    return {"/".join(prefix): np.asarray(tree)}


def state_for(arch: str, dtype: str = "float32", opt: str = "adamw"):
    hp = TrainHParams(peak_lr=1e-3, warmup=2, total_steps=10, opt=OptConfig(name=opt))
    _, cfg = cfgs(arch, dtype)
    return make_train_state(cfg, hp, torch.Generator().manual_seed(0), device="cpu"), hp


def port_loss_and_grads(state, batch, remat=True):
    model = state.params
    grads = grad_leaves(model)
    for g in grads.values():
        g.zero_()
    loss = lm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()}, remat=remat)
    loss.backward()
    return float(loss.detach()), {k: g.clone() for k, g in grads.items()}


def assert_grads_close(got: dict, want: dict) -> float:
    """Every leaf within rtol 2e-5 and 2e-5 of the tree's largest gradient
    magnitude; returns the largest error over that magnitude."""
    assert list(got) == list(want), "leaves or their order differ"
    top = max(float(np.abs(w).max()) for w in want.values())
    err = 0.0
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=2e-5, atol=2e-5 * top, err_msg=k)
        err = max(err, float(np.abs(g.numpy() - want[k]).max()) / top)
    return err


@pytest.mark.parametrize("arch", KINDS)
def test_lm_loss_and_grads_equal_reference(arch):
    jcfg, cfg = cfgs(arch)
    state, _ = state_for(arch)
    tree = params_to_reference(state.params)
    batch = make_batch(cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.lm_loss(p, jcfg, NULL_LAYOUT, {k: jnp.asarray(v) for k, v in batch.items()})
    ))(jax.tree.map(jnp.asarray, tree))
    loss, grads = port_loss_and_grads(state, batch)
    np.testing.assert_allclose(loss, float(want_loss), **F32)
    assert_grads_close(grads, flat(want_grads))


def test_moe_aux_terms_enter_the_loss():
    """dbrx-132b: the loss is the mean NLL plus every MoE layer's
    ``moe_aux + moe_zloss``, as the reference's ``lm_loss`` adds them."""
    jcfg, cfg = cfgs("dbrx-132b")
    state, _ = state_for("dbrx-132b")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    model = state.params
    with torch.no_grad():
        hidden, aux = model.forward_train(batch["tokens"])
        loss_sum, n = chunked_xent(hidden, model.unembed_matrix(), batch["targets"])
        loss = lm_loss(model, batch)
    assert float(aux) > 0 and float(loss) == float(loss_sum / n + aux)
    _, want_aux, _ = jtfm.forward_train(jax.tree.map(jnp.asarray, params_to_reference(model)),
                                        jcfg, NULL_LAYOUT, {"tokens": jnp.asarray(batch["tokens"])})
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)


def test_chunked_xent_pads_the_last_chunk():
    """V = 50 in chunks of 16 (the last one padded with -1e30 logits), some
    targets ignored (-1): the loss sum, the valid count and the gradients
    of hidden and the unembedding equal the reference's within 2e-5."""
    rng = np.random.default_rng(3)
    hidden = rng.normal(size=(2, 5, 8)).astype(np.float32)
    w = (rng.normal(size=(8, 50)) * 0.3).astype(np.float32)
    targets = rng.integers(0, 50, (2, 5)).astype(np.int32)
    targets[0, 1] = targets[1, 4] = -1
    targets[1, 0] = 49  # in the padded chunk

    def jloss(h, w):
        s, n = jtfm.chunked_xent(h, w, jnp.asarray(targets), chunk_v=16)
        return s / n

    (want, (gh, gw)) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    s, n = chunked_xent(th, tw, torch.from_numpy(targets), chunk_v=16)
    assert int(n) == 8
    (s / n).backward()
    np.testing.assert_allclose(float((s / n).detach()), float(want), **F32)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), **F32)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), **F32)


@pytest.mark.parametrize("arch", ["gemma3-4b", "dbrx-132b"])
def test_train_step_equals_reference(arch):
    """One ``make_train_step`` step (AdamW) against the reference's jitted
    step from the same state and batch, at step 1 (the learning rate of
    step 0 is 0: warmup from 0)."""
    jcfg, cfg = cfgs(arch)
    state, hp = state_for(arch)
    state = state._replace(step=torch.ones((), dtype=torch.int32))
    tree = jax.tree.map(jnp.asarray, params_to_reference(state.params))
    jhp = JHParams(peak_lr=hp.peak_lr, warmup=hp.warmup, total_steps=hp.total_steps,
                   opt=JOptConfig(name="adamw"))
    jstate = JTrainState(params=tree, opt=jopt_init(tree, jhp.opt), step=jnp.ones((), jnp.int32))
    batch = make_batch(cfg, seed=5)
    jnew, jm = jax.jit(jmake_train_step(jcfg, NULL_LAYOUT, jhp))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = make_train_step(cfg, hp)(state, batch)
    assert int(new.step) == 2 and new.step.dtype == torch.int32
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **F32, err_msg=k)
    assert float(m["lr"]) == float(jm["lr"]) > 0
    assert_step_close(new.params, jnew.params, float(m["lr"]))


def assert_step_close(model, want_tree, lr: float) -> None:
    """The port's params after a step (``model``) against the reference's
    (``want_tree``).  Adam's step moves an element by about lr either way
    (lr g / (|g| + eps) at the first): where the gradient is float32 noise
    next to the element's normaliser the two packages can step apart.
    Every element within 2.2 lr (the most two such steps and the decay can
    differ), and at most 1 in 10,000 elements past 1e-6 of their leaf's
    scale plus lr / 100 (measured: 17 of 291,776 on gemma3-4b's first
    AdamW step, 2 of 189,248 on dbrx-132b's third 8-bit step, else 0)."""
    want = flat(want_tree)
    apart, n = 0, 0
    for k, p in flat(params_to_reference(model)).items():
        d = np.abs(p - want[k])
        scale = float(np.abs(want[k]).max())
        assert float(d.max()) <= 1e-6 * scale + 2.2 * lr, k
        apart += int((d > 1e-6 * scale + 1e-2 * lr).sum())
        n += d.size
    assert apart <= n // 10_000, (apart, n)


def test_zero_grad_between_steps_keeps_the_gradients():
    """``model.zero_grad()`` between two steps sets every ``.grad`` to
    None; the next step points them at its gradient buffers again, so the
    two steps give the params, loss and grad norm of two steps without it,
    bit for bit.  A model moved after its layout was made is refused."""
    _, cfg = cfgs("gemma3-4b")
    runs = []
    for zero in (False, True):
        state, hp = state_for("gemma3-4b")
        step = make_train_step(cfg, hp)
        for i in range(2):
            if zero and i:
                state.params.zero_grad()
            state, m = step(state, make_batch(cfg, seed=40 + i))
        assert float(m["grad_norm"]) > 0
        runs.append((state, m))
    (a, ma), (b, mb) = runs
    for k in ("loss", "grad_norm", "lr"):
        assert float(ma[k]) == float(mb[k]), k
    want = flat(params_to_reference(a.params))
    for k, p in flat(params_to_reference(b.params)).items():
        np.testing.assert_array_equal(p, want[k], err_msg=k)
    b.params.double()
    with pytest.raises(ValueError, match="no longer"):
        grad_leaves(b.params)


@pytest.mark.parametrize("arch", ["dbrx-132b", "xlstm-350m"])
def test_remat_changes_nothing(arch, monkeypatch):
    """No remat, remat of each unit, and ``REPRO_REMAT=dots`` (the products
    kept, the rest recomputed): the same loss and gradients, bit for bit."""
    _, cfg = cfgs(arch)
    batch = make_batch(cfg, seed=7)
    runs = {}
    for name, remat, env in (("off", False, "full"), ("full", True, "full"), ("dots", True, "dots")):
        monkeypatch.setenv("REPRO_REMAT", env)
        state, _ = state_for(arch)
        runs[name] = port_loss_and_grads(state, batch, remat=remat)
    for name in ("full", "dots"):
        assert runs[name][0] == runs["off"][0], name
        for k, g in runs["off"][1].items():
            assert torch.equal(runs[name][1][k], g), (name, k)


BF16_REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
sys.path[:0] = [{src!r}, {tests!r}]
import dataclasses, numpy as np, jax, jax.numpy as jnp
import lm_reference_bf16 as bref
from repro.configs import get_smoke_config
from repro.distributed.sharding import NULL_LAYOUT
from repro.models import transformer as tfm
cfg = dataclasses.replace(get_smoke_config({arch!r}), dtype="bfloat16")
data = dict(np.load({inp!r}))
batch = {{k[6:]: jnp.asarray(v) for k, v in data.items() if k.startswith("batch/")}}
tree = bref.unflatten({{k[7:]: v for k, v in data.items() if k.startswith("params/")}})
loss, grads = jax.jit(jax.value_and_grad(lambda p: tfm.lm_loss(p, cfg, NULL_LAYOUT, batch)))(
    jax.tree.map(jnp.asarray, tree))
np.savez({out!r}, loss=np.asarray(loss), **bref.flatten(grads))
"""


@pytest.mark.slow
@pytest.mark.parametrize("arch", KINDS)
def test_lm_loss_bf16_close_to_reference(arch, tmp_path):
    """bf16 activations over float32 masters (each layer on its masters
    rounded to bf16 inside its unit, the reference's early cast), against
    the reference jitted with ``--xla_allow_excess_precision=false`` in a
    process of its own (``tests/lm_reference_bf16.py`` says why): the loss
    within 3e-3 (measured 1.8e-3 on gemma3-4b, 5e-7 on recurrentgemma-9b)
    and the gradients within 5e-2 of their norm (measured 4.1e-2, 1.1e-2
    and 1.9e-2 on gemma3-4b, recurrentgemma-9b and xlstm-350m: the bf16
    roundings of the backward fall differently, a departure logged in
    ROADMAP Queue 3)."""
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    import lm_reference_bf16 as bref

    _, cfg = cfgs(arch, "bfloat16")
    state, _ = state_for(arch, "bfloat16")
    batch = make_batch(cfg)
    inp, out = str(tmp_path / "in.npz"), str(tmp_path / "out.npz")
    np.savez(inp, **{f"batch/{k}": v for k, v in batch.items()},
             **{f"params/{k}": v for k, v in bref.flatten(params_to_reference(state.params)).items()})
    here = os.path.dirname(os.path.abspath(__file__))
    code = BF16_REFERENCE.format(src=os.path.join(here, "..", "src"), tests=here, arch=arch,
                                 inp=inp, out=out)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr
    want = dict(np.load(out))
    loss, grads = port_loss_and_grads(state, batch)
    np.testing.assert_allclose(loss, float(want.pop("loss")), rtol=3e-3)
    num = np.sqrt(sum(float(np.sum((g.numpy().astype(np.float64) - want[k]) ** 2))
                      for k, g in grads.items()))
    den = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want.values()))
    assert num / den <= 5e-2, num / den
