"""The port's LM (``repro_torch.models``) against the reference's
(``repro.models``), on the CPU, with the reference's random weights
carried over by ``params_from_reference``.

Tolerances, as np.testing.assert_allclose's rtol = atol:
  * float32: 2e-5 (measured: the gemma3-4b smoke's prefill logits 1.6e-5
    and decode logits 3.0e-5 at most apart, at logits up to 9.4; the
    layers' ops alone 0 to 3e-7); k / v and other activations with atol
    scaled to their magnitude (``close_f32``; measured 3.7e-5 at 7);
  * bf16, the layers' ops alone: 3e-2 (measured 0: the port rounds each
    op where the reference does — GeLU and SiLU op by op);
  * bf16, whole models: a norm bound, ||port - ref|| <= 3e-2 ||ref||
    (measured 4.7e-3 for the gemma3-4b smoke's prefill logits, one bf16
    rounding of the 40-token run falling the other way and carried
    through 7 layers, 0.042 abs; 4.4e-8 for qwen2.5-32b and internvl2-2b;
    decode with bf16 caches 2.2e-4, 9.5e-3 abs).  The bf16 reference numbers come from
    ``tests/lm_reference_bf16.py`` in a process of its own (why: its
    docstring).  A bf16 model differs from its float32 self by 2.5e-2 to
    6.3e-2 of the norm on these configs, so the bound tells bf16 from
    float32 arithmetic.

The MoE, RG-LRU and xLSTM kinds (recurrentgemma-9b, xlstm-350m,
dbrx-132b and llama4-maverick smoke configs), measured: float32 prefill
/ decode logits 8.5e-6 / 8.8e-6, 1.7e-5 / 2.0e-5, 4.5e-6 / 1.1e-5 and
1.1e-5 / 1.9e-5 apart at most (logits up to 8.1); bf16 prefill 6.9e-3
of the norm for recurrentgemma (its windowed attention's single-chunk
PV sum rounds 7 of 3,072 outputs the other way; the RG-LRU layers are
bit-equal) and 3e-8 to 4e-8 for the others, bf16 decode 4.6e-3, 1.2e-3,
3e-8 and 3e-8.  The blocks alone (``moe_ffn`` in both groupings, with
drops and ties; the RG-LRU scan and decode; mLSTM parallel and
recurrent; the sLSTM scan and decode) hold the float32 tolerance.

The reference runs jitted on the CPU and is shared through module
fixtures; the wider lattice (gemma-7b, deepseek-coder-33b,
musicgen-medium) is marked slow.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.distributed.sharding import NULL_LAYOUT  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as tfm  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models import layers, params_from_reference, params_to_reference, zoo  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import lm_reference_bf16 as bref  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
BF16_NORM = 3e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test workers on the machine's cores: one
    torch thread a worker keeps them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32cfg(arch: str):
    return (dataclasses.replace(jsmoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


@pytest.fixture(scope="module")
def trees():
    """Parameter trees in the reference's layout, as numpy, by arch:
    gemma3-4b's from the reference's own ``init_model``; the other smoke
    configs' from the port's seeded init through ``params_to_reference``
    (the reference's init takes about 10 s a config on this CPU; both
    packages then compute on the same weights either way)."""
    cache = {}

    def get(arch: str) -> dict:
        if arch not in cache:
            if arch == "gemma3-4b":
                params, _ = tfm.init_model(jax.random.PRNGKey(0), jsmoke(arch))
                cache[arch] = jax.tree.map(np.asarray, params)
            else:
                cache[arch] = params_to_reference(zoo.init_params(
                    get_smoke_config(arch), torch.Generator().manual_seed(0), device="cpu"))
        return cache[arch]

    return get


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close_f32(got, want):
    """Logits: rtol = atol = 2e-5.  Activations: the same rtol, and atol
    2e-5 times the tensor's largest magnitude when above 1 — deep layers'
    k / v reach 10 to 15, and their float32 noise is relative to that
    (measured 3.1e-5 at most at the gemma3-4b smoke's last layer)."""
    want = host(want)
    np.testing.assert_allclose(host(got), want, rtol=2e-5,
                               atol=2e-5 * max(1.0, float(np.abs(want).max())))


def logits_f32(got, want):
    np.testing.assert_allclose(host(got), host(want), **F32)


def near_norm(got, want, bound=BF16_NORM) -> float:
    err = float(np.linalg.norm(host(got) - host(want)) / np.linalg.norm(host(want)))
    assert err <= bound, f"relative error {err:.3g} > {bound}"
    return err


# ------------------------------------------------------------------ the ops
def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_equal_reference(dtype):
    """rms_norm (Gemma's 1 + scale), rope (halves, theta 1e6 and 1e4),
    linear (multi-dim out, bias) and the gated FFN with GeLU and SiLU."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16
    x = _rand((2, 5, 64), 1, 3.0)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    scale = _rand((64,), 2, 0.5)
    got = layers.rms_norm(tx, torch.from_numpy(scale), 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(host(got), host(jlayers.rms_norm(jx, {"scale": scale}, 1e-6)), **tol)

    w, b = _rand((64, 4, 16), 3, 0.125), _rand((4, 16), 4)
    got = layers.linear(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tdt and got.shape == (2, 5, 4, 16)
    np.testing.assert_allclose(host(got), host(jlayers.linear(jx, {"w": w, "b": b})), **tol)

    q = _rand((2, 5, 4, 16), 5)
    pos = np.arange(5)[None].repeat(2, 0) * 7
    for theta in (1e6, 1e4):
        want = jlayers.rope(jnp.asarray(q, jdt), jnp.asarray(pos), theta)
        got = layers.rope(torch.from_numpy(q).to(tdt), torch.from_numpy(pos),
                          layers.rope_freq(16, theta))
        np.testing.assert_allclose(host(got), host(want), **tol)

    ffn = {k: {"w": _rand((64, 128) if k != "down" else (128, 64), 6 + i, 0.125)}
           for i, k in enumerate(("gate", "up", "down"))}
    tw = [torch.from_numpy(ffn[k]["w"]) for k in ("gate", "up", "down")]
    for act in ("gelu", "silu"):
        want = jlayers.ffn(jx, ffn, act, NULL_LAYOUT)
        np.testing.assert_allclose(host(layers.ffn(tx, *tw, act)), host(want), **tol)


def test_gelu_is_the_tanh_form():
    """The reference's GeLU is ``jax.nn.gelu``'s default, the tanh form:
    the port's FFN matches it, and an FFN with ``F.gelu``'s default (erf)
    does not, at the float32 tolerance."""
    x = _rand((4, 64), 11, 2.0)
    ffn = {k: {"w": _rand((64, 128) if k != "down" else (128, 64), 12 + i, 0.125)}
           for i, k in enumerate(("gate", "up", "down"))}
    tw = [torch.from_numpy(ffn[k]["w"]) for k in ("gate", "up", "down")]
    want = host(jlayers.ffn(jnp.asarray(x), ffn, "gelu", NULL_LAYOUT))
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(host(layers.ffn(tx, *tw, "gelu")), want, **F32)
    erf = layers.linear(torch.nn.functional.gelu(layers.linear(tx, tw[0]))
                        * layers.linear(tx, tw[1]), tw[2])
    assert not np.allclose(host(erf), want, **F32)


# ------------------------------------------------------------- attention
@pytest.fixture(scope="module")
def gemma_f32(trees):
    jcfg, cfg = f32cfg("gemma3-4b")
    tree = trees("gemma3-4b")
    return jcfg, cfg, tree, params_from_reference(tree, cfg, device="cpu")


def test_attn_forward_fully_masked_chunks(gemma_f32):
    """T = 40 (not a multiple of 512) with kv_chunk 16 (halved to 8 to
    divide T): a windowed layer (16) whose queries see whole chunks
    masked, and the global layer."""
    jcfg, cfg, params, model = gemma_f32
    x = _rand((2, 40, cfg.d_model), 21)
    pos = np.arange(40)
    for i in (0, 5):  # windowed, global
        lp = tfm.layer_params_for(params, jcfg, i)
        window = jcfg.layer_windows[i]
        want, (wk, wv) = jax.jit(lambda p, x, w=window: jattn.attn_train(
            p, x, jnp.asarray(pos), jcfg, NULL_LAYOUT, window=w, kv_chunk=16))(lp["attn"], x)
        got, (k, v) = model.layers[i].attn(torch.from_numpy(x), torch.from_numpy(pos),
                                           window=window, kv_chunk=16)
        assert np.isfinite(host(got)).all()
        for g, w in ((got, want), (k, wk), (v, wv)):
            close_f32(g, w)


def test_attn_decode_across_the_ring_wrap(gemma_f32):
    """One windowed layer (window 16, a 16-slot ring) decoding T = 24
    tokens: outputs, the ring's k / v and its slot positions equal the
    reference's at every step."""
    jcfg, cfg, params, model = gemma_f32
    lp = tfm.layer_params_for(params, jcfg, 0)["attn"]
    xs = _rand((24, 2, 1, cfg.d_model), 22)
    jcache = jattn.make_cache(jcfg, 2, 16, jnp.float32)
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    step = jax.jit(lambda p, x, c, pos: jattn.attn_decode(p, x, c, pos, jcfg, NULL_LAYOUT,
                                                          window=16))
    for t in range(24):
        want, jcache = step(lp, xs[t], jcache, jnp.int32(t))
        got, cache = model.layers[0].attn.decode(torch.from_numpy(xs[t]), cache, t, window=16)
        close_f32(got, want)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    assert sorted(cache["pos"].tolist()) == list(range(8, 24))
    for k in ("k", "v"):
        close_f32(cache[k], jcache[k])


# ------------------------------------------------------------ whole model
def _prefill_ref(jcfg, params, batch):
    logits, caches = jax.jit(lambda p, bt: tfm.forward_prefill(p, jcfg, NULL_LAYOUT, bt))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return host(logits), [(host(k), host(v)) for k, v in bref.per_layer_kv(caches, jcfg)]


def n_attention(cfg) -> int:
    return sum(kind in bref.ATTENTION for kind in cfg.layer_kinds)


def _check_prefill(model, batch, want_logits, want_kv, close, close_logits=None):
    logits, kvs = model.forward_prefill(
        torch.from_numpy(batch["tokens"]),
        torch.from_numpy(batch["prefix_embeds"]) if "prefix_embeds" in batch else None)
    assert logits.dtype == torch.float32 and len(kvs) == len(want_kv) == n_attention(model.cfg)
    (close_logits or close)(logits, want_logits)
    for (k, v), (wk, wv) in zip(kvs, want_kv):
        assert k.dtype == model.dtype
        close(k, wk)
        close(v, wv)


def test_prefill_gemma3_f32(gemma_f32):
    jcfg, cfg, params, model = gemma_f32
    batch = {"tokens": bref.tokens(cfg.vocab_size, 2, 40)}
    logits, kv = _prefill_ref(jcfg, params, batch)
    _check_prefill(model, batch, logits, kv, close_f32, logits_f32)


@pytest.fixture(scope="module")
def decode_tokens():
    return bref.tokens(512, 2, 24)


@pytest.fixture(scope="module")
def gemma_f32_decode(gemma_f32, decode_tokens):
    """The reference's f32 model decoding 24 tokens with f32 and with
    bf16 caches: each step's logits and the final caches."""
    jcfg, _, params, _ = gemma_f32
    step = jax.jit(lambda p, c, tok, pos: tfm.forward_decode(p, jcfg, NULL_LAYOUT, tok, c, pos))
    out = {}
    for dt in ("float32", "bfloat16"):
        caches = tfm.init_caches(jcfg, 2, 24, getattr(jnp, dt))
        steps = []
        for i in range(24):
            logits, caches = step(params, caches, jnp.asarray(decode_tokens[:, i:i + 1]),
                                  jnp.int32(i))
            steps.append(host(logits))
        out[dt] = (np.stack(steps), caches)
    return out


def _decode(model, toks, cache_dtype):
    caches = model.init_caches(toks.shape[0], toks.shape[1], cache_dtype)
    steps = []
    for i in range(toks.shape[1]):
        logits, caches = model.forward_decode(torch.from_numpy(toks[:, i:i + 1]), caches, i)
        steps.append(host(logits))
    return np.stack(steps), caches


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_gemma3_f32_step_by_step(gemma_f32, gemma_f32_decode, decode_tokens, cache_dtype):
    """24 steps across the windowed layers' ring wrap: every step's logits
    and every layer's final cache.  With bf16 caches the f32 model reads
    k / v rounded to bf16 (bf16 tolerance; measured 6.3e-5 abs)."""
    _, _, _, model = gemma_f32
    want, jcaches = gemma_f32_decode[cache_dtype]
    got, caches = _decode(model, decode_tokens, getattr(torch, cache_dtype))
    tol = F32 if cache_dtype == "float32" else BF16
    np.testing.assert_allclose(got, want, **tol)
    for c, jc in zip(caches, jcaches):
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
        for k in ("k", "v"):
            assert c[k].dtype == getattr(torch, cache_dtype)
            np.testing.assert_allclose(host(c[k]), host(jc[k]), **tol)


def test_decode_f32_caches_promote_a_bf16_model(trees):
    """The reference's ``generate`` decodes a bf16 model into float32
    caches: layer 0's attention output is float32, so the residual stream
    and every later layer run in float32 (the masters cast to float32).
    The port does the same: its logits equal the reference's at the
    float32 tolerance (measured 1.8e-5 abs at logits up to 9.4; rtol and
    atol 3e-5), and layer 0's output is float32.  A port that kept bf16
    through the stack (bf16 caches) is 0.25 away."""
    jcfg, cfg = jsmoke("gemma3-4b"), get_smoke_config("gemma3-4b")
    assert cfg.dtype == "bfloat16"
    params = trees("gemma3-4b")
    model = params_from_reference(params, cfg, device="cpu")
    toks = bref.tokens(cfg.vocab_size, 2, 12)
    step = jax.jit(lambda p, c, tok, pos: tfm.forward_decode(p, jcfg, NULL_LAYOUT, tok, c, pos))
    caches = tfm.init_caches(jcfg, 2, 12, jnp.float32)
    want = []
    for i in range(12):
        logits, caches = step(params, caches, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        want.append(host(logits))
    want = np.stack(want)
    got, _ = _decode(model, toks, torch.float32)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    bf16_through, _ = _decode(model, toks, torch.bfloat16)
    assert np.abs(bf16_through - want).max() > 0.1
    with torch.inference_mode():
        c = model.init_caches(2, 4, torch.float32)
        x0 = model.embed_tokens(torch.from_numpy(toks[:, :1]))
        assert x0.dtype == torch.bfloat16
        assert model.layers[0].decode(x0, c[0], 0)[0].dtype == torch.float32


def test_prefill_qwen_qkv_bias_f32(trees):
    jcfg, cfg = f32cfg("qwen2.5-32b")
    assert cfg.qkv_bias
    params = trees("qwen2.5-32b")
    model = params_from_reference(params, cfg, device="cpu")
    batch = {"tokens": bref.tokens(cfg.vocab_size, 2, 24)}
    logits, kv = _prefill_ref(jcfg, params, batch)
    _check_prefill(model, batch, logits, kv, close_f32, logits_f32)


def test_prefill_internvl_prefix_embeds_f32(trees):
    """The vision stub's prefix embeddings prepended to the tokens; the
    batch from ``make_concrete_batch``, equal to the reference's."""
    jcfg, cfg = f32cfg("internvl2-2b")
    shape = ShapeConfig("prefill", 24, 2, "prefill")
    batch = zoo.make_concrete_batch(cfg, shape)
    want = jzoo.make_concrete_batch(jcfg, JShape("prefill", 24, 2, "prefill"))
    assert batch.keys() == want.keys() == {"tokens", "prefix_embeds"}
    for k in batch:
        np.testing.assert_array_equal(batch[k], host(want[k]) if k == "prefix_embeds"
                                      else np.asarray(want[k]))
    params = trees("internvl2-2b")
    model = params_from_reference(params, cfg, device="cpu")
    logits, kv = _prefill_ref(jcfg, params, batch)
    assert kv[0][0].shape[1] == 24  # prefix + tokens
    _check_prefill(model, batch, logits, kv, close_f32, logits_f32)


def test_make_concrete_batch_train_equals_reference():
    for arch in ("gemma3-4b", "internvl2-2b"):
        got = zoo.make_concrete_batch(get_smoke_config(arch), ShapeConfig("t", 16, 2, "train"), 3)
        want = jzoo.make_concrete_batch(jsmoke(arch), JShape("t", 16, 2, "train"), 3)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], host(want[k]) if k == "prefix_embeds"
                                          else np.asarray(want[k]))


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-coder-33b", "musicgen-medium"])
def test_prefill_and_decode_wider_lattice_f32(trees, arch):
    jcfg, cfg = f32cfg(arch)
    params = trees(arch)
    model = params_from_reference(params, cfg, device="cpu")
    batch = {"tokens": bref.tokens(cfg.vocab_size, 2, 24)}
    logits, kv = _prefill_ref(jcfg, params, batch)
    _check_prefill(model, batch, logits, kv, close_f32, logits_f32)
    step = jax.jit(lambda p, c, tok, pos: tfm.forward_decode(p, jcfg, NULL_LAYOUT, tok, c, pos))
    caches = tfm.init_caches(jcfg, 2, 24, jnp.float32)
    want = []
    for i in range(24):
        lg, caches = step(params, caches, jnp.asarray(batch["tokens"][:, i:i + 1]), jnp.int32(i))
        want.append(host(lg))
    got, _ = _decode(model, batch["tokens"], torch.float32)
    np.testing.assert_allclose(got, np.stack(want), **F32)


# -------------------------------------------------------- bf16, whole model
@pytest.fixture(scope="module")
def bf16_ref(tmp_path_factory, trees):
    """The reference's bf16 outputs, from ``tests/lm_reference_bf16.py``
    in a process of its own, on this module's parameter trees."""
    tmp = tmp_path_factory.mktemp("lm_bf16")
    out, params = str(tmp / "ref.npz"), str(tmp / "params.npz")
    np.savez(params, **{f"{arch}/{k}": v for arch in bref.ARCHS
                        for k, v in bref.flatten(trees(arch)).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "lm_reference_bf16.py"),
                           params, out],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as z:
        return dict(z)


@pytest.mark.parametrize("arch,b,t", bref.PREFILL)
def test_prefill_bf16(bf16_ref, trees, arch, b, t):
    cfg = get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    model = params_from_reference(trees(arch), cfg, device="cpu")
    if cfg.frontend == "vision_stub":
        batch = zoo.make_concrete_batch(cfg, ShapeConfig("prefill", t, b, "prefill"))
    else:
        batch = {"tokens": bref.tokens(cfg.vocab_size, b, t)}
    kv = [(bf16_ref[f"{arch}/prefill/k{i}"], bf16_ref[f"{arch}/prefill/v{i}"])
          for i in range(n_attention(cfg))]
    _check_prefill(model, batch, bf16_ref[f"{arch}/prefill/logits"], kv, near_norm)


def test_decode_bf16_caches(bf16_ref, trees):
    """The bf16 model decoding into bf16 caches (bf16 throughout), 24
    steps across the ring's wrap."""
    arch, b, t = bref.DECODE
    cfg = get_smoke_config(arch)
    model = params_from_reference(trees(arch), cfg, device="cpu")
    got, caches = _decode(model, bref.tokens(cfg.vocab_size, b, t), torch.bfloat16)
    near_norm(got, bf16_ref[f"{arch}/decode/logits"])
    np.testing.assert_allclose(got, bf16_ref[f"{arch}/decode/logits"], **BF16)
    for i, c in enumerate(caches):
        np.testing.assert_array_equal(c["pos"].numpy(), bf16_ref[f"{arch}/decode/pos{i}"])
        for k in ("k", "v"):
            np.testing.assert_allclose(host(c[k]), bf16_ref[f"{arch}/decode/{k}{i}"], **BF16)


# ------------------------------------------------------ weights and kinds
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_smoke_config_builds(arch):
    """Every config's smoke model builds on the CPU, every layer kind
    included: one module a layer holding its kind's block, and as many
    parameters as the reference's ``init_model`` tree."""
    cfg = get_smoke_config(arch)
    model = Transformer(cfg, device="cpu")
    assert len(model.layers) == cfg.n_layers
    for layer, kind in zip(model.layers, cfg.layer_kinds):
        assert isinstance(getattr(layer, kind), torch.nn.Module), (arch, kind)
    want = jax.eval_shape(lambda k: tfm.init_model(k, jsmoke(arch))[0], jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(a.size for a in jax.tree.leaves(want))


def test_weights_round_trip(trees):
    """The reference's gemma3-4b tree (1 unit of 6 layers stacked + 1
    leftover) -> port -> tree is exact."""
    cfg = get_smoke_config("gemma3-4b")
    tree = trees("gemma3-4b")
    back = params_to_reference(params_from_reference(tree, cfg, device="cpu"))
    flat, treedef = jax.tree.flatten(tree)
    flat_back, treedef_back = jax.tree.flatten(back)
    assert treedef == treedef_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)
    assert sum(a.size for a in flat) == cfg.param_count()


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "musicgen-medium", "internvl2-2b"]
                         + list(bref.KINDS))
def test_port_tree_has_the_reference_layout(arch):
    """The port's weights as a reference tree have the structure and
    shapes of the reference's ``init_model`` (qwen: 2 units of 1 layer
    with biases; musicgen: an untied unembedding; recurrentgemma: 1 unit
    of (rglru, rglru, attn) + 2 leftovers; xlstm: mlstm / slstm with no
    norm2; dbrx and llama4: the experts, llama4's shared expert), and
    carry back exactly."""
    cfg = get_smoke_config(arch)
    model = zoo.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    tree = params_to_reference(model)
    want = jax.eval_shape(lambda k: tfm.init_model(k, jsmoke(arch))[0], jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, w in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == w.shape and a.dtype == w.dtype
    again = params_from_reference(tree, cfg, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(model.parameters(), again.parameters()))


def test_init_params_from_a_generator():
    """Random init from an explicit generator: seeded runs are equal,
    seeds differ; the parameter count is the config's; ``device=None``
    means the card."""
    cfg = get_smoke_config("gemma3-4b")
    a = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = zoo.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count()
    assert a.embed.std().item() == pytest.approx(cfg.d_model ** -0.5, rel=0.05)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            zoo.init_params(cfg, torch.Generator().manual_seed(0))


def test_full_width_config_counts():
    assert get_config("gemma3-4b").param_count() == 3_879_907_840


# full-width parameter counts: the reference's ``init_model`` tree (from
# ``jax.eval_shape``), MoE configs at 2 layers as the card runs them
FULL_WIDTH = {"recurrentgemma-9b": None, "xlstm-350m": None, "dbrx-132b": 2,
              "llama4-maverick-400b-a17b": 2}


@pytest.mark.parametrize("arch", sorted(FULL_WIDTH))
def test_full_width_kinds_count_the_reference_tree(arch):
    """The port's full-width model (built on ``meta``: shapes, no storage)
    has as many parameters as the reference's tree.  ``param_count()``
    (copied from the reference) leaves out the RG-LRU's gate linears
    w_a / w_i and counts one bias too many (2 W^2 - W a layer), and counts
    the xLSTM blocks by a formula of its own, so it is below the tree
    there; for the MoE configs it is exact."""
    cfg = get_config(arch)
    if FULL_WIDTH[arch]:
        cfg = dataclasses.replace(cfg, n_layers=FULL_WIDTH[arch])
    jcfg = dataclasses.replace(jsmoke(arch), **{f.name: getattr(cfg, f.name)
                                                for f in dataclasses.fields(cfg)})
    want = jax.eval_shape(lambda k: tfm.init_model(k, jcfg)[0], jax.random.PRNGKey(0))
    n = sum(p.numel() for p in Transformer(cfg, device="meta").parameters())
    assert n == sum(a.size for a in jax.tree.leaves(want))
    if arch == "recurrentgemma-9b":
        w = cfg.lru_width
        assert n - cfg.param_count() == cfg.layer_kinds.count("rglru") * (2 * w * w - w)
    elif arch == "xlstm-350m":
        assert n > cfg.param_count()
    else:
        assert n == cfg.param_count()


# ----------------------------------------------------------- the new kinds
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.models.rglru import linear_scan, make_rglru_state  # noqa: E402
from repro_torch.models.xlstm import make_mlstm_state, make_slstm_state  # noqa: E402


def kind_model(trees, arch, **changes):
    """(reference cfg, port cfg, tree, port model) in float32 on the
    arch's smoke weights, with ``changes`` applied to both configs."""
    jcfg, cfg = f32cfg(arch)
    jcfg, cfg = dataclasses.replace(jcfg, **changes), dataclasses.replace(cfg, **changes)
    tree = trees(arch)
    return jcfg, cfg, tree, params_from_reference(tree, cfg, device="cpu")


def ref_state(jstate) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}


MOE_CASES = {  # (arch, config changes, router change)
    "drops": ("dbrx-132b", {"capacity_factor": 0.5}, None),
    "ties": ("dbrx-132b", {}, "equal_columns"),
    "shared": ("llama4-maverick-400b-a17b", {}, None),
}


@pytest.mark.parametrize("group_by_batch", [False, True])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_equals_reference(trees, case, group_by_batch):
    """``moe_ffn`` per sequence (prefill) and over the whole batch
    (decode): outputs within the float32 tolerance, the aux losses too.
    "drops": capacity_factor 0.5 drops pairs past capacity (and keeps
    others); "ties": all router columns equal, so every probability ties
    and the top-k is experts 0..k-1, the lower index first as in
    ``jax.lax.top_k``, with the later tokens dropped; "shared": llama4's
    top-1 routing plus its shared expert."""
    arch, changes, router = MOE_CASES[case]
    jcfg, cfg, tree, model = kind_model(trees, arch, **changes)
    i = cfg.layer_kinds.index("moe")
    lp = dict(tfm.layer_params_for(tree, jcfg, i)["moe"])
    moe = model.layers[i].moe
    if router == "equal_columns":
        w = np.repeat(lp["router"]["w"][:, :1], cfg.n_experts, axis=1)
        lp["router"] = {"w": w}
        moe.router.w.data.copy_(torch.from_numpy(w))
    x = _rand((4, 6, cfg.d_model), 31)
    want, waux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg, NULL_LAYOUT,
                                                   group_by_batch=group_by_batch))(lp, x)
    with torch.inference_mode():
        got, aux = moe(torch.from_numpy(x), group_by_batch=group_by_batch)
        xg = torch.from_numpy(x).reshape(1, 24, -1) if group_by_batch else torch.from_numpy(x)
        r = moe.route(xg)
    close_f32(got, want)
    for k in ("moe_aux", "moe_zloss"):
        np.testing.assert_allclose(aux[k].item(), float(waux[k]), **F32)
    if case == "drops":
        assert 0 < int(r.kept.sum()) < r.kept.numel()
    if case == "ties":
        k = cfg.moe_top_k
        assert (r.experts == torch.arange(k)).all()
        assert not r.kept.all() and r.kept[:, 0].all()


@pytest.mark.parametrize("t", [13, 16])
def test_rglru_train_and_decode_equal_reference(trees, t):
    """``rglru_train`` (the parallel scan, odd and even T) and
    ``rglru_decode`` step by step, against the reference's; the port's
    scan against a step-by-step loop of the recurrence (float32, within
    2e-6 of the values' scale), and decode against the full sequence."""
    jcfg, cfg, tree, model = kind_model(trees, "recurrentgemma-9b")
    lp = tfm.layer_params_for(tree, jcfg, 0)["rglru"]
    block = model.layers[0].rglru
    x = _rand((2, t, cfg.d_model), 32)
    want = jax.jit(lambda p, x: jrglru.rglru_train(p, x, jcfg, NULL_LAYOUT))(lp, x)
    tx = torch.from_numpy(x)
    with torch.inference_mode():
        got = block(tx)
        close_f32(got, want)
        from repro_torch.models.layers import causal_conv

        xi, _ = causal_conv(block.w_rec(tx), block.conv_w, block.conv_b)
        a, b = block._gates(xi)
        _, h = linear_scan(a, b)
        loop, hs = torch.zeros_like(b[:, 0]), []
        for i in range(t):
            loop = a[:, i] * loop + b[:, i]
            hs.append(loop)
        np.testing.assert_allclose(h.numpy(), torch.stack(hs, 1).numpy(), rtol=2e-6,
                                   atol=2e-6 * float(h.abs().max()))
        state = make_rglru_state(cfg, 2, torch.float32)
        jstate = jrglru.make_rglru_state(jcfg, 2, jnp.float32)
        step = jax.jit(lambda p, x, s: jrglru.rglru_decode(p, x, s, jcfg, NULL_LAYOUT))
        for i in range(t):
            w, jstate = step(lp, x[:, i:i + 1], jstate)
            g, state = block.decode(tx[:, i:i + 1], state)
            close_f32(g, w)
            close_f32(g, got[:, i:i + 1])
    for k in ("h", "conv"):
        close_f32(state[k], jstate[k])


def test_mlstm_parallel_and_recurrent_equal_reference(trees):
    """The mLSTM's stabilized parallel form and its recurrent decode
    against the reference's, and against each other (float32)."""
    jcfg, cfg, tree, model = kind_model(trees, "xlstm-350m")
    assert cfg.layer_kinds[0] == "mlstm"
    lp = tfm.layer_params_for(tree, jcfg, 0)["mlstm"]
    block = model.layers[0].mlstm
    x = _rand((2, 12, cfg.d_model), 33)
    want = jax.jit(lambda p, x: jxlstm.mlstm_train(p, x, jcfg, NULL_LAYOUT))(lp, x)
    tx = torch.from_numpy(x)
    state = make_mlstm_state(cfg, 2, torch.float32)
    jstate = jxlstm.make_mlstm_state(jcfg, 2, jnp.float32)
    step = jax.jit(lambda p, x, s: jxlstm.mlstm_decode(p, x, s, jcfg, NULL_LAYOUT))
    with torch.inference_mode():
        got = block(tx)
        close_f32(got, want)
        for i in range(12):
            w, jstate = step(lp, x[:, i:i + 1], jstate)
            g, state = block.decode(tx[:, i:i + 1], state)
            close_f32(g, w)
            close_f32(g, got[:, i:i + 1])
    for k in ("c", "n", "m", "conv"):
        close_f32(state[k], jstate[k])


def test_slstm_scan_and_decode_equal_reference(trees):
    """The sLSTM's T-step scan (with its GeGLU FFN) and its decode against
    the reference's, and against each other (float32)."""
    jcfg, cfg, tree, model = kind_model(trees, "xlstm-350m")
    assert cfg.layer_kinds[1] == "slstm"
    lp = tfm.layer_params_for(tree, jcfg, 1)["slstm"]
    block = model.layers[1].slstm
    x = _rand((2, 12, cfg.d_model), 34)
    want = jax.jit(lambda p, x: jxlstm.slstm_train(p, x, jcfg, NULL_LAYOUT))(lp, x)
    tx = torch.from_numpy(x)
    state = make_slstm_state(cfg, 2)
    jstate = jxlstm.make_slstm_state(jcfg, 2)
    step = jax.jit(lambda p, x, s: jxlstm.slstm_decode(p, x, s, jcfg, NULL_LAYOUT))
    with torch.inference_mode():
        got = block(tx)
        close_f32(got, want)
        for i in range(12):
            w, jstate = step(lp, x[:, i:i + 1], jstate)
            g, state = block.decode(tx[:, i:i + 1], state)
            close_f32(g, w)
            close_f32(g, got[:, i:i + 1])
    for k in ("c", "n", "h", "m"):
        close_f32(state[k], jstate[k])


@pytest.mark.parametrize("arch", bref.KINDS)
def test_prefill_and_decode_kinds_f32(trees, arch):
    """Whole models of the new kinds in float32: prefill logits and the
    attention layers' KV, then 20 decode steps into float32 caches
    (logits at every step, every layer's final state)."""
    jcfg, cfg, tree, model = kind_model(trees, arch)
    batch = {"tokens": bref.tokens(cfg.vocab_size, 2, 20)}
    logits, kv = _prefill_ref(jcfg, tree, batch)
    _check_prefill(model, batch, logits, kv, close_f32, logits_f32)
    step = jax.jit(lambda p, c, tok, pos: tfm.forward_decode(p, jcfg, NULL_LAYOUT, tok, c, pos))
    jc = tfm.init_caches(jcfg, 2, 20, jnp.float32)
    want = []
    for i in range(20):
        lg, jc = step(tree, jc, jnp.asarray(batch["tokens"][:, i:i + 1]), jnp.int32(i))
        want.append(host(lg))
    got, caches = _decode(model, batch["tokens"], torch.float32)
    np.testing.assert_allclose(got, np.stack(want), **F32)
    for c, w in zip(caches, jc):
        assert c.keys() == w.keys()
        for k in c:
            close_f32(c[k], w[k])


@pytest.mark.parametrize("arch,b,t", bref.DECODE_KINDS)
def test_decode_bf16_kinds(bf16_ref, trees, arch, b, t):
    """The bf16 models of the new kinds decoding into bf16 caches and
    states: every step's logits and every final state within 3e-2 of its
    norm; attention slots' positions exactly."""
    cfg = get_smoke_config(arch)
    model = params_from_reference(trees(arch), cfg, device="cpu")
    got, caches = _decode(model, bref.tokens(cfg.vocab_size, b, t), torch.bfloat16)
    near_norm(got, bf16_ref[f"{arch}/decode/logits"])
    for i, c in enumerate(caches):
        for k, v in c.items():
            want = bf16_ref[f"{arch}/decode/{k}{i}"]
            if k == "pos":
                np.testing.assert_array_equal(v.numpy(), want)
            elif k == "m":  # -1e30 where a gate never opened, else a log scale
                np.testing.assert_allclose(host(v), want, rtol=3e-2, atol=3e-2)
            else:
                near_norm(v, want)


def test_early_cast_changes_bf16_prefill(bf16_ref, trees):
    """The reference rounds the layer stack's float32 masters to bf16
    before a bf16 full-sequence forward (``REPRO_CAST_EARLY``, on by
    default); the weights consumed in float32 (the xLSTM gate linears and
    biases, the sLSTM's recurrent matrices) then read the rounded values.
    The port does the same: on the xlstm-350m smoke (no attention, whose
    bf16 score sums can round the other way) its prefill logits equal the
    reference's to 4.4e-8 of the norm, and the same prefill reading the
    float32 masters is 2.2e-2 off (measured)."""
    arch, b, t = next(p for p in bref.PREFILL if p[0] == "xlstm-350m")
    cfg = get_smoke_config(arch)
    model = params_from_reference(trees(arch), cfg, device="cpu")
    toks = torch.from_numpy(bref.tokens(cfg.vocab_size, b, t))
    want = bf16_ref[f"{arch}/prefill/logits"]
    with torch.inference_mode():
        cast, _ = model.forward_prefill(toks)
        # the same forward with every layer on its float32 masters
        x = model.embed_tokens(toks)
        positions = torch.arange(t)[None].expand(b, t)
        for layer in model.layers:
            x, _, _ = layer(x, positions)
        x = layers.rms_norm(x, model.final_norm.scale, cfg.norm_eps)
        uncast = model.logits(x[:, -1:])
    rel = {k: float(np.linalg.norm(host(v) - want) / np.linalg.norm(want))
           for k, v in (("cast", cast), ("uncast", uncast))}
    assert rel["cast"] <= 1e-6 and rel["uncast"] >= 5e-3, rel


def test_moe_decode_output_depends_on_the_batch(trees):
    """The reference's decode routes the whole batch as one capacity group
    (``group_by_batch``), so a request's output depends on the other
    requests in its batch; the port copies it.  With every router column
    equal (each token picks experts 0 and 1) the dbrx smoke's capacity is
    1 for one token and 2 for a batch of 4: the last token alone keeps both
    experts, in the batch both its pairs are dropped and its output is 0
    — in the port and in the reference alike."""
    jcfg, cfg, tree, model = kind_model(trees, "dbrx-132b")
    lp = dict(tfm.layer_params_for(tree, jcfg, 0)["moe"])
    moe = model.layers[0].moe
    w = np.repeat(lp["router"]["w"][:, :1], cfg.n_experts, axis=1)
    lp["router"] = {"w": w}
    moe.router.w.data.copy_(torch.from_numpy(w))
    x = _rand((4, 1, cfg.d_model), 35)
    step = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, jcfg, NULL_LAYOUT, group_by_batch=True)[0])
    with torch.inference_mode():
        alone = moe(torch.from_numpy(x[-1:]), group_by_batch=True)[0]
        batched = moe(torch.from_numpy(x), group_by_batch=True)[0]
    close_f32(alone, step(lp, x[-1:]))
    close_f32(batched, step(lp, x))
    assert float(alone.abs().max()) > 0.1
    assert float(batched[-1].abs().max()) == 0.0
