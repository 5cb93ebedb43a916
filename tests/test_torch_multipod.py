"""The port's multi-pod layouts (a (``pod``, ``data``, ``model``) mesh,
``multi_pod=True``) executed on 8 gloo ranks on the CPU, as a (2, 2, 2)
mesh, against the reference's one-device steps on the same weights and
inputs.

One ``spawn_local`` runs, at the smoke configs' sizes: gemma3-4b
``decode`` (B = 4, the batch over the (``pod``, ``data``) plane) with
float32 and w8a16 weights, ``long`` (B = 1, the cache over the whole
world), ``prefill`` (B = 4, T = 32) and one ZeRO train step under the
``train`` layout (the batch over ``pod`` x ``data``, the loss positions
over ``model``).  The reference runs in this process meanwhile, jitted with
``NULL_LAYOUT`` on the port's seeded init carried over by
``params_to_reference`` (w8a16: its ``quantize_tree`` of that tree).
Bars: the serving logits within 2e-5 of the reference's largest
magnitude and the greedy tokens equal (``test_torch_sharded_serve.py``'s
bar); the train step's loss, grad norm and learning rate within rtol
2e-5 and its updated params (every rank's blocks put together) by
``test_torch_train.py``'s rule.
"""
import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.sharding import NamedSharding, make_layout  # noqa: E402
from repro_torch.launch import AbstractMesh, spawn_local  # noqa: E402
from repro_torch.models import params_to_reference, zoo  # noqa: E402
from repro_torch.models.convert import reference_leaves  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serve import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.train.train_step import make_train_state, make_train_step  # noqa: E402
from test_torch_sharded_serve import (  # noqa: E402
    B, LENGTH, NEW, cfg_of, close, decode_run, inputs_of, model_of)
from test_torch_sharded_train import assert_step_close, batch_of, hp_of, specs_of  # noqa: E402

ARCH, SHAPE, TIMEOUT_S = "gemma3-4b", (2, 2, 2), 240
MESH = AbstractMesh(("pod", "data", "model"), SHAPE)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rank(mesh):
    torch.set_num_threads(1)  # a spawned rank starts with every core's thread
    cfg, out = cfg_of(ARCH), {}
    for name, kind, w8 in (("decode", "decode", False), ("decode_w8a16", "decode", True),
                           ("long", "long", False)):
        layout = make_layout(kind, mesh, multi_pod=True)
        model = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                                layout=layout, w8a16=w8)
        toks = inputs_of(ARCH)[kind]
        rows = model.shard.batch.block(toks.shape[0])
        run = decode_run(model, make_serve_step(cfg, layout=layout), toks[rows], NEW, LENGTH)
        out[name] = {"rows": (rows.start, rows.stop), "logits": run["logits"],
                     "tokens": run["tokens"]}
    layout = make_layout("prefill", mesh, multi_pod=True)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", layout=layout)
    r = make_prefill_step(cfg, layout=layout)(params, {"tokens": inputs_of(ARCH)["prefill/tokens"]})
    rows = params.shard.batch.block(B)
    out["prefill"] = {"rows": (rows.start, rows.stop), "logits": r["logits"].numpy()}
    hp, layout = hp_of("adamw"), make_layout("train", mesh, multi_pod=True)
    state = make_train_state(cfg, hp, torch.Generator().manual_seed(0), layout=layout)
    state = state._replace(step=torch.full((), 1, dtype=torch.int32))
    step = make_train_step(cfg, hp, layout=layout, grad_specs=specs_of(cfg, layout, "adamw").params)
    state, m = step(state, batch_of(cfg))
    out["train"] = {"metrics": {k: float(v) for k, v in m.items()},
                    "params": {k: v.clone() for k, v in state.params.items()}}
    return out


def reference_decode(jcfg, params, toks: np.ndarray) -> dict:
    """The reference's jitted one-device ``make_serve_step``: the prompt
    teacher-forced, then ``NEW`` greedy tokens fed back (``decode_run``'s
    schedule), float32 caches of ``LENGTH`` slots."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.sharding import NULL_LAYOUT
    from repro.models import transformer as jtfm
    from repro.serve import make_serve_step as jmake_serve_step

    step = jax.jit(jmake_serve_step(jcfg, NULL_LAYOUT))
    caches = jtfm.init_caches(jcfg, toks.shape[0], LENGTH, jnp.float32)
    tok, logits, nexts = jnp.asarray(toks[:, :1]), [], []
    for t in range(toks.shape[1] + NEW - 1):
        r = step(params, caches, tok, jnp.int32(t))
        logits.append(np.asarray(r["logits"])[:, 0])
        nexts.append(np.asarray(r["next_tokens"])[:, 0])
        caches = r["caches"]
        tok = jnp.asarray(toks[:, t + 1:t + 2]) if t + 1 < toks.shape[1] else r["next_tokens"]
    return {"logits": np.stack(logits), "tokens": np.stack(nexts)}


def reference_outputs() -> dict:
    """The reference's one-device outputs: decode (float32 and w8a16), long,
    prefill, and one AdamW train step at step 1 (the new params by leaf
    path).  jax is imported here, not by the module: every rank imports
    the module to find ``_rank``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jsmoke
    from repro.distributed.sharding import NULL_LAYOUT
    from repro.models import zoo as jzoo
    from repro.models.layers import quantize_tree
    from repro.optim import OptConfig as JOptConfig
    from repro.optim import opt_init as jopt_init
    from repro.serve import make_prefill_step as jmake_prefill_step
    from repro.train.train_step import TrainHParams as JHParams
    from repro.train.train_step import TrainState as JTrainState
    from repro.train.train_step import make_train_step as jmake_train_step
    from test_torch_train import flat

    jcfg = dataclasses.replace(jsmoke(ARCH), dtype="float32")
    params = jax.tree.map(jnp.asarray, params_to_reference(model_of(ARCH)))
    qparams = quantize_tree(params, jzoo.param_axes(jcfg))
    ins = inputs_of(ARCH)
    out = {"decode": reference_decode(jcfg, params, ins["decode"]),
           "decode_w8a16": reference_decode(jcfg, qparams, ins["decode"]),
           "long": reference_decode(jcfg, params, ins["long"])}
    r = jax.jit(jmake_prefill_step(jcfg, NULL_LAYOUT))(
        params, {"tokens": jnp.asarray(ins["prefill/tokens"])})
    out["prefill"] = np.asarray(r["logits"])
    hp = hp_of("adamw")
    state = make_train_state(cfg_of(ARCH), hp, torch.Generator().manual_seed(0), device="cpu")
    tree = jax.tree.map(jnp.asarray, params_to_reference(state.params))
    jhp = JHParams(peak_lr=hp.peak_lr, warmup=hp.warmup, total_steps=hp.total_steps,
                   opt=JOptConfig(name="adamw"))
    jstate = JTrainState(params=tree, opt=jopt_init(tree, jhp.opt), step=jnp.ones((), jnp.int32))
    new, m = jax.jit(jmake_train_step(jcfg, NULL_LAYOUT, jhp))(
        jstate, {k: jnp.asarray(v) for k, v in batch_of(cfg_of(ARCH)).items()})
    out["train"] = {"metrics": {k: float(v) for k, v in m.items()},
                    "params": {k: torch.from_numpy(np.array(v)) for k, v in flat(new.params).items()}}
    return out


@pytest.fixture(scope="module")
def runs():
    """(every rank's results, the reference's outputs): the world runs in a
    thread while this process jits and runs the reference."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn_local, _rank, SHAPE, backend="gloo", device="cpu",
                            timeout_s=TIMEOUT_S)
        ref = reference_outputs()
        return world.result(), ref


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


@pytest.mark.parametrize("name,kind,w8", [("decode", "decode", False),
                                          ("decode_w8a16", "decode", True),
                                          ("long", "long", False)])
def test_multipod_decode_equals_one_device(ranks, reference, name, kind, w8):
    """``decode`` (float32 and w8a16 weights) and ``long`` on (2, 2, 2):
    every rank's rows' logits and greedy tokens equal the reference's one
    device's on the same weights (w8a16: its ``quantize_tree``)."""
    want = reference[name]
    seen = set()
    for r in ranks:
        got = r[name]
        rows = slice(*got["rows"])
        seen.update(range(rows.start, rows.stop))
        np.testing.assert_array_equal(got["tokens"], want["tokens"][:, rows])
        close(got["logits"], want["logits"][:, rows], f"{name} multi-pod")
    assert seen == set(range(want["tokens"].shape[1]))


def test_multipod_prefill_equals_one_device(ranks, reference):
    """``prefill`` on (2, 2, 2) against the reference's one-device prefill:
    the batch over the (pod, data) plane, the sequence over model, the
    parameters stored over all three axes."""
    want = reference["prefill"]
    assert {r["prefill"]["rows"] for r in ranks} == {(i, i + 1) for i in range(B)}
    for r in ranks:
        close(r["prefill"]["logits"], want[slice(*r["prefill"]["rows"])], "prefill multi-pod")


def test_multipod_train_step_equals_one_device(ranks, reference):
    """One ZeRO train step under the multi-pod ``train`` layout against the
    reference's one-device step: its loss, grad norm and learning rate,
    and its updated params (every rank's blocks put together) within the
    train tests' rule."""
    want = reference["train"]
    for r in ranks:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r["train"]["metrics"][k], want["metrics"][k], rtol=2e-5,
                                       atol=2e-5, err_msg=k)
    cfg = cfg_of(ARCH)
    specs = specs_of(cfg, make_layout("train", MESH, multi_pod=True), "adamw").params
    leaves = reference_leaves(Transformer(cfg, device="meta"))
    full = {k: torch.full(tuple(v.shape), float("nan")) for k, v in leaves.items()}
    for rank, r in enumerate(ranks):
        for k, block in r["train"]["params"].items():
            full[k][NamedSharding(MESH, specs[k]).block(tuple(leaves[k].shape), rank)] = block
    assert not any(bool(v.isnan().any()) for v in full.values())
    assert set(full) == set(want["params"])
    assert_step_close(full, want["params"], want["metrics"]["lr"])
