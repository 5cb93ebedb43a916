"""The port's optimizers and schedule (``repro_torch.optim``) against the
reference's (``repro.optim``), on the CPU.

Five updates of each optimizer from the same gradients (numpy, seeded)
over the reference's parameter tree of the dbrx-132b smoke config (two
stacked units: a unit leaf holds both layers, so Adafactor's factored
moments and update clipping and the 8-bit blocks span the stack), the
reference run op by op and jitted:

  * op by op: AdamW and 8-bit AdamW equal bit for bit (params, moments,
    codes and scales); Adafactor's row / column means sum in another
    order than XLA's: params, ``vr`` and ``vc`` within 1e-6 of each
    leaf's largest magnitude (measured 1.5e-7, 2.2e-7, 2.3e-7);
  * jitted: XLA's CPU backend contracts multiplies and adds into FMAs
    (AdamW's moments), so every state within 1e-6 of its leaf's largest
    magnitude (measured at most 2.3e-7 for the three optimizers); the
    8-bit codes equal (no tie fell the other way), their scales within
    it.

The port's square root is XLA's, correctly rounded (``optim.adamw.sqrt``;
torch's float32 ``sqrt`` on the CPU is an ulp off on 0.7% of values).
``warmup_cosine`` equals the jitted reference bit for bit at steps 0, 1,
warmup - 1, warmup, mid, total and past total; ``global_norm`` within 2
ulps (its per-leaf sums run in another order).  The reference's own
contracts, ``test_optimizer_reduces_loss`` and ``test_grad_clip``, hold
on the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import OptConfig as JOptConfig  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.optim import warmup_cosine as jwarmup  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_to_reference, zoo  # noqa: E402
from repro_torch.models.convert import reference_leaves  # noqa: E402
from repro_torch.optim import (OptConfig, clip_by_global_norm, global_norm, opt_init,  # noqa: E402
                               opt_update, warmup_cosine)
from repro_torch.optim import adamw as tadam  # noqa: E402

NAMES = ["adamw", "adafactor", "adamw8bit"]
REL = 1e-6  # of a leaf's largest magnitude


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """(the port's leaves of the dbrx-132b smoke model, its reference tree,
    five gradient sets in the leaves' order)."""
    cfg = dataclasses.replace(get_smoke_config("dbrx-132b"), dtype="float32")
    assert cfg.n_units == 2
    model = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = reference_leaves(model)
    tree = params_to_reference(model)
    rng = np.random.default_rng(1)
    grads = [[(rng.normal(size=p.shape) * 0.1).astype(np.float32) for p in leaves.values()]
             for _ in range(5)]
    return {k: v.clone() for k, v in leaves.items()}, tree, grads


def run_both(problem, name: str, jit: bool):
    leaves, tree, grads = problem
    params = {k: v.clone() for k, v in leaves.items()}
    jp, treedef = jax.tree.flatten(jax.tree.map(jnp.asarray, tree))
    assert len(jp) == len(params)
    jp = jax.tree.unflatten(treedef, jp)
    jcfg, cfg = JOptConfig(name=name), OptConfig(name=name)
    jstate, state = jadam.opt_init(jp, jcfg), opt_init(params, cfg)

    def jupd(g, s, p, lr):
        return jadam.opt_update(g, s, p, lr, jcfg)

    jupd = jax.jit(jupd) if jit else jupd
    for i, g in enumerate(grads):
        lr = np.float32(1e-2 * (i + 1))
        jp, jstate = jupd(jax.tree.unflatten(treedef, [jnp.asarray(x) for x in g]), jstate, jp,
                          jnp.float32(lr))
        state = opt_update({k: torch.from_numpy(x.copy()) for k, x in zip(params, g)}, state,
                           params, torch.tensor(lr), cfg)
    assert int(state.step) == int(jstate.step) == 5 and state.step.dtype == torch.int32
    pairs = {"params": list(zip(jax.tree.leaves(jp), params.values()))}
    for f in state._fields[1:]:
        pairs[f] = list(zip(jax.tree.leaves(getattr(jstate, f)), getattr(state, f).values()))
    return pairs


def worst(pairs) -> float:
    """The largest |port - reference| over a leaf's largest |reference|."""
    w = 0.0
    for want, got in pairs:
        want, got = np.asarray(want), got.numpy()
        assert want.shape == got.shape and want.dtype == got.dtype
        scale = max(float(np.abs(want.astype(np.float64)).max()), 1e-30)
        w = max(w, float(np.abs(got.astype(np.float64) - want).max()) / scale)
    return w


@pytest.mark.parametrize("name", NAMES)
def test_updates_equal_reference_op_by_op(problem, name):
    pairs = run_both(problem, name, jit=False)
    for field, ps in pairs.items():
        if name == "adafactor":
            assert worst(ps) <= REL, field
        else:
            for want, got in ps:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=field)


@pytest.mark.parametrize("name", NAMES)
def test_updates_close_to_jitted_reference(problem, name):
    pairs = run_both(problem, name, jit=True)
    for field, ps in pairs.items():
        if field in ("m_q", "v_q"):
            for want, got in ps:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=field)
        else:
            assert worst(ps) <= REL, field


def test_adafactor_and_8bit_see_stacked_leaves(problem):
    """The unit leaves are stacked, as the reference's: a (2, d) norm scale
    is factored by Adafactor (a (2,) row and a (64,) column moment),
    and an 8-bit leaf's blocks run over both units."""
    leaves, _, _ = problem
    key = "units/0/norm1/scale"
    assert leaves[key].shape == (2, 64)
    st = opt_init(leaves, OptConfig(name="adafactor"))
    assert st.vr[key].shape == (2,) and st.vc[key].shape == (64,)
    st = opt_init(leaves, OptConfig(name="adamw8bit"))
    assert st.m_q[key].shape == (1, tadam.BLOCK)


def test_warmup_cosine_equals_reference():
    kw = dict(peak_lr=3e-4, warmup=20, total=300)
    steps = np.array([0, 1, 19, 20, 160, 300, 301, 1000], np.int32)
    want = np.asarray(jax.jit(lambda s: jwarmup(s, **kw))(jnp.asarray(steps)))
    got = np.array([warmup_cosine(torch.tensor(s), **kw).item() for s in steps], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[3] == np.float32(3e-4) and got[-1] == got[-2]


def test_global_norm_and_clip_equal_reference(problem):
    leaves, tree, grads = problem
    g = {k: torch.from_numpy(x.copy()) for k, x in zip(leaves, grads[0])}
    jg = jax.tree.unflatten(jax.tree.structure(tree), [jnp.asarray(x) for x in grads[0]])
    want = float(jadam.global_norm(jg))
    got = float(global_norm(g))
    assert abs(got - want) <= 2 * np.spacing(np.float32(want)), (got, want)
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == got
    jclipped, _ = jadam.clip_by_global_norm(jg, 1.0)
    assert worst(list(zip(jax.tree.leaves(jclipped), clipped.values()))) <= REL


# the reference's own contracts (tests/test_substrate.py), on the port
def _quad_problem():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros((3,)), "b": torch.zeros((2, 3))}

    def loss(p):
        return torch.sum((p["w"] - target) ** 2) + torch.sum((p["b"] - 0.5) ** 2)

    return params, loss


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_reduces_loss(name):
    params, loss = _quad_problem()
    cfg = OptConfig(name=name, weight_decay=0.0)
    state = opt_init(params, cfg)
    l0 = float(loss(params))
    for _ in range(60):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss(p).backward()
        state = opt_update({k: v.grad for k, v in p.items()}, state, params, 0.05, cfg)
    assert float(loss(params)) < 0.05 * l0


def test_grad_clip():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0, rel=1e-5)
