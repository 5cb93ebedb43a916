"""The port's LM serving path (``repro_torch.serve``: ``make_prefill_step``,
``make_serve_step``, ``RAGServer.generate``) against the reference's, on
the CPU, on the gemma3-4b smoke config (7 layers, a window-16 ring on
six of them).

  * the prefill and serve steps: logits, caches and greedy tokens step by
    step, float32 (rtol = atol = 2e-5; measured 1.6e-5 / 3.7e-5);
  * ``generate`` over the tiny engine's saved index (the reference
    searches its engine, the port loads the file): the generated tokens
    equal the reference's exactly in float32 and in bf16, and so do the
    retrieved ids' ``SearchStats`` and the ``io_report``.  In bf16 the
    reference decodes into float32 caches, which lifts the residual
    stream to float32 from layer 0's attention output on.  The port's
    logits along ``generate``'s own 37 steps are within 2e-4 of the
    reference's on the same sequence (measured 5.4e-5 in float32 and
    2.6e-5 in bf16, abs, at logits up to about 7), while a port that
    kept bf16 through the stack (bf16 caches) is 0.40 away;
  * ``generate`` over the recurrentgemma-9b smoke model, whose caches
    mix RG-LRU states and KV rings: the same tokens as the reference in
    float32 and bf16;
  * an empty batch gives the reference's shapes, and requests with
    ``max_new_tokens=0`` raise the reference's ``ValueError``;
  * the serving variants.  w8a16 (``models.layers.quantize_model``): the
    int8 codes and float32 scales equal the reference's
    ``quantize_tree(params, axes)`` bit for bit (gemma-7b, two stacked
    units; dbrx-132b, its router quantised and its raw experts not), the
    stacked ``w_s`` shaped (n_units, *out) both ways; the quantised decode
    of the qwen2.5-32b smoke (the reference's ``tests/test_w_int8.py``
    config, with the reference's own weights) equals the reference's
    quantised decode within the float32 tolerance (measured 1.1e-5 at
    logits up to 7.7) and meets the reference's own bound against the full
    forward (0.48 against 1.11, argmax agreement 0.958).  The int8 KV cache (``REPRO_KV_INT8=1``):
    ``quant_kv``'s codes and scales equal ``_quant_kv``'s bit for bit;
    decode logits equal the reference's with the variable set within the
    float32 tolerance (measured 6.7e-6, 2.0e-5 and 9.8e-6 at logits up to
    8.5) on deepseek-coder-33b
    (and the reference's bound against the full forward), on gemma3-4b's
    window-16 rings past the wrap and on recurrentgemma-9b (its states
    untouched); a bf16 model's decode stays bf16.

Both packages compute on the same weights: the port's seeded init
carried into the reference's tree layout (``params_to_reference``; the
reference's own init is held to the carry-over in
``tests/test_torch_models.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.models.layers import quantize_tree  # noqa: E402
from repro.core import SearchConfig as JSearchConfig  # noqa: E402
from repro.distributed.sharding import NULL_LAYOUT  # noqa: E402
from repro.models import transformer as tfm  # noqa: E402
from repro.serve import RAGRequest as JRequest  # noqa: E402
from repro.serve import RAGServer as JRAGServer  # noqa: E402
from repro.serve import make_prefill_step as jmake_prefill  # noqa: E402
from repro.serve import make_serve_step as jmake_serve  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core.search import SearchStats  # noqa: E402
from repro_torch.models import params_from_reference, params_to_reference, zoo  # noqa: E402
from repro_torch.models.attention import quant_kv  # noqa: E402
from repro_torch.models.layers import quantize_model  # noqa: E402
from repro_torch.serve import RAGRequest, RAGServer, make_prefill_step, make_serve_step  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
SEARCH = dict(mode="gate", search_l=32, beam_width=4, result_k=3)
PASSAGE, PROMPT, NEW = 8, 6, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test workers on the machine's cores: one
    torch thread a worker keeps them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(dtype: str):
    return (dataclasses.replace(jsmoke("gemma3-4b"), dtype=dtype),
            dataclasses.replace(get_smoke_config("gemma3-4b"), dtype=dtype))


@pytest.fixture(scope="module")
def weights():
    """(the port's model builder by dtype, the same weights as a reference tree)."""
    _, cfg = cfgs("float32")
    model = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = params_to_reference(model)

    def port(dtype: str):
        m = zoo.init_params(cfgs(dtype)[1], torch.Generator().manual_seed(0), device="cpu")
        assert all(torch.equal(p, q) for p, q in zip(m.parameters(), model.parameters()))
        return m

    return port, tree


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_prefill_and_serve_steps(weights):
    """The reference's ``make_prefill_step`` and ``make_serve_step`` and
    the port's: prefill logits and every layer's KV; then 24 greedy
    serve steps fed their own tokens (f32 caches), logits and next
    tokens equal at every step; ``greedy=False`` hands the tokens back."""
    port, tree = weights
    jcfg, cfg = cfgs("float32")
    model = port("float32")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = jax.jit(jmake_prefill(jcfg, NULL_LAYOUT))(tree, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(cfg)(model, {"tokens": toks})
    np.testing.assert_allclose(host(got["logits"]), host(want["logits"]), **F32)
    n_unit = len(cfg.pattern_unit)
    for i, (k, v) in enumerate(got["caches"]):
        if i < cfg.n_units * n_unit:
            u, pos = divmod(i, n_unit)
            wk, wv = (a[u] for a in want["caches"][0][pos])
        else:
            wk, wv = want["caches"][1 + i - cfg.n_units * n_unit]
        for g, w in ((k, wk), (v, wv)):
            w = host(w)
            np.testing.assert_allclose(host(g), w, rtol=2e-5, atol=2e-5 * max(1.0, np.abs(w).max()))

    jstep = jax.jit(jmake_serve(jcfg, NULL_LAYOUT))
    step = make_serve_step(cfg)
    jc = tfm.init_caches(jcfg, 2, 24, jnp.float32)
    c = model.init_caches(2, 24, torch.float32)
    jtok, tok = jnp.asarray(toks[:, :1]), toks[:, :1]
    for t in range(24):
        w = jstep(tree, jc, jtok, jnp.int32(t))
        g = step(model, c, tok, t)
        np.testing.assert_allclose(host(g["logits"]), host(w["logits"]), **F32)
        np.testing.assert_array_equal(g["next_tokens"].numpy(), np.asarray(w["next_tokens"]))
        assert g["next_tokens"].dtype == torch.int32 and g["next_tokens"].shape == (2, 1)
        jc, c = w["caches"], g["caches"]
        jtok, tok = w["next_tokens"], g["next_tokens"]
    same = make_serve_step(cfg, greedy=False)(model, model.init_caches(2, 4, torch.float32),
                                              toks[:, :1], 0)
    np.testing.assert_array_equal(same["next_tokens"].numpy(), toks[:, :1])


@pytest.fixture(scope="module")
def index_path(tiny_engine, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_lm_serve") / "tiny.gann")
    tiny_engine.save(path)
    return path


@pytest.fixture(scope="module")
def port_engine(index_path):
    return GateANNEngine.load(index_path, device="cpu")


def _requests(queries, vocab: int, req_cls):
    rng = np.random.default_rng(4)
    return [req_cls(query_vec=queries[i], prompt_tokens=rng.integers(0, vocab, PROMPT).astype(np.int32),
                    filter_kind="label", filter_params=np.int32(i % 3))
            for i in range(4)]


def _passages(n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (n, PASSAGE)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_equals_reference(weights, tiny_engine, port_engine, tiny_corpus, dtype):
    port, tree = weights
    jcfg, cfg = cfgs(dtype)
    model = port(dtype)
    _, _, queries = tiny_corpus
    n = int(port_engine.codes.shape[0])
    passages = _passages(n, cfg.vocab_size)
    jsrv = JRAGServer(engine=tiny_engine, cfg=jcfg, params=tree, layout=NULL_LAYOUT,
                      passage_tokens=passages, search_config=JSearchConfig(**SEARCH))
    srv = RAGServer(engine=port_engine, cfg=cfg, params=model, passage_tokens=passages,
                    search_config=SearchConfig(**SEARCH))
    want, wstats = jsrv.generate(_requests(queries, cfg.vocab_size, JRequest), max_new_tokens=NEW)

    steps = []  # the port's logits along generate's own steps
    decode = model.forward_decode

    def recorded(tokens, caches, pos):
        logits, caches = decode(tokens, caches, pos)
        steps.append(host(logits)[:, 0])
        return logits, caches

    model.forward_decode = recorded
    got, stats = srv.generate(_requests(queries, cfg.vocab_size, RAGRequest), max_new_tokens=NEW)
    del model.forward_decode
    assert got.dtype == np.int32 and got.shape == (4, NEW)
    np.testing.assert_array_equal(got, want)
    for f in SearchStats._fields:
        np.testing.assert_array_equal(getattr(stats, f).numpy(), np.asarray(getattr(wstats, f)))
    assert srv.io_report() == jsrv.io_report()

    # the reference's logits along the same sequence: prompts + generated
    ids, _ = srv.retrieve(_requests(queries, cfg.vocab_size, RAGRequest))
    seq = np.concatenate([srv.build_prompts(_requests(queries, cfg.vocab_size, RAGRequest), ids),
                          got], axis=1)
    jstep = jax.jit(lambda p, c, t, pos: tfm.forward_decode(p, jcfg, NULL_LAYOUT, t, c, pos))
    jc = tfm.init_caches(jcfg, 4, seq.shape[1], jnp.float32)
    ref = []
    for t in range(seq.shape[1] - 1):
        logits, jc = jstep(tree, jc, jnp.asarray(seq[:, t:t + 1]), jnp.int32(t))
        ref.append(host(logits)[:, 0])
    ref, steps = np.stack(ref), np.stack(steps)
    err = float(np.abs(steps - ref).max())
    assert err <= 2e-4, err
    if dtype == "bfloat16":
        # a port keeping bf16 through the stack (bf16 caches) is far off
        c = model.init_caches(4, seq.shape[1], torch.bfloat16)
        bf = [host(model.forward_decode(torch.from_numpy(seq[:, t:t + 1]), c, t)[0])[:, 0]
              for t in range(seq.shape[1] - 1)]
        assert float(np.abs(np.stack(bf) - ref).max()) > 0.1


def test_generate_empty_batch(weights, tiny_engine, port_engine):
    port, tree = weights
    jcfg, cfg = cfgs("float32")
    n = int(port_engine.codes.shape[0])
    jsrv = JRAGServer(engine=tiny_engine, cfg=jcfg, params=tree, layout=NULL_LAYOUT,
                      passage_tokens=_passages(n, 512), search_config=JSearchConfig(**SEARCH))
    srv = RAGServer(engine=port_engine, cfg=cfg, params=port("float32"),
                    passage_tokens=_passages(n, 512), search_config=SearchConfig(**SEARCH))
    want, wstats = jsrv.generate([], max_new_tokens=4)
    got, stats = srv.generate([], max_new_tokens=4)
    assert got.shape == want.shape == (0, 4) and got.dtype == want.dtype == np.int32
    for f in SearchStats._fields:
        assert tuple(getattr(stats, f).shape) == np.asarray(getattr(wstats, f)).shape == (0,)
    assert srv.io_report() == jsrv.io_report()


def test_generate_needs_the_model(port_engine, tiny_corpus):
    _, _, queries = tiny_corpus
    n = int(port_engine.codes.shape[0])
    srv = RAGServer(engine=port_engine, cfg=None, params=None, passage_tokens=_passages(n, 512),
                    search_config=SearchConfig(**SEARCH))
    with pytest.raises(ValueError, match="generate needs params"):
        srv.generate(_requests(queries, 512, RAGRequest))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_hybrid_equals_reference(tiny_engine, port_engine, tiny_corpus, dtype):
    """``generate`` over the recurrentgemma-9b smoke model (RG-LRU, RG-LRU,
    windowed attention; 5 layers): the caches are mixed (recurrent states
    beside KV rings), and the generated tokens equal the reference's
    exactly in float32 and in bf16 (where the first two RG-LRU layers run
    in bf16 and the float32 caches promote the stream from layer 2's
    attention on)."""
    jcfg = dataclasses.replace(jsmoke("recurrentgemma-9b"), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"), dtype=dtype)
    model = zoo.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    tree = params_to_reference(model)
    _, _, queries = tiny_corpus
    passages = _passages(int(port_engine.codes.shape[0]), cfg.vocab_size)
    jsrv = JRAGServer(engine=tiny_engine, cfg=jcfg, params=tree, layout=NULL_LAYOUT,
                      passage_tokens=passages, search_config=JSearchConfig(**SEARCH))
    srv = RAGServer(engine=port_engine, cfg=cfg, params=model, passage_tokens=passages,
                    search_config=SearchConfig(**SEARCH))
    want, _ = jsrv.generate(_requests(queries, cfg.vocab_size, JRequest), max_new_tokens=NEW)
    got, _ = srv.generate(_requests(queries, cfg.vocab_size, RAGRequest), max_new_tokens=NEW)
    assert got.dtype == np.int32 and got.shape == (4, NEW)
    np.testing.assert_array_equal(got, want)
    caches = model.init_caches(4, 8, torch.float32)
    assert [sorted(c) for c in caches[:3]] == [["conv", "h"], ["conv", "h"], ["k", "pos", "v"]]


def test_generate_zero_new_tokens_raises_as_the_reference(weights, tiny_engine, port_engine,
                                                         tiny_corpus):
    """Requests with ``max_new_tokens=0``: every step is teacher-forced and
    no token is made; the reference's ``np.stack`` of no steps raises
    ``ValueError``, and so does the port."""
    port, tree = weights
    jcfg, cfg = cfgs("float32")
    _, _, queries = tiny_corpus
    passages = _passages(int(port_engine.codes.shape[0]), cfg.vocab_size)
    jsrv = JRAGServer(engine=tiny_engine, cfg=jcfg, params=tree, layout=NULL_LAYOUT,
                      passage_tokens=passages, search_config=JSearchConfig(**SEARCH))
    srv = RAGServer(engine=port_engine, cfg=cfg, params=port("float32"), passage_tokens=passages,
                    search_config=SearchConfig(**SEARCH))
    with pytest.raises(ValueError):
        jsrv.generate(_requests(queries, cfg.vocab_size, JRequest), max_new_tokens=0)
    with pytest.raises(ValueError, match="max_new_tokens=0"):
        srv.generate(_requests(queries, cfg.vocab_size, RAGRequest), max_new_tokens=0)


# ------------------------------------------------------------ w8a16 weights
def f32_model(arch: str, seed: int = 0):
    jcfg = dataclasses.replace(jsmoke(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return jcfg, cfg, zoo.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")


def flat_tree(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat_tree(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat_tree(sub, prefix + (str(i),)).items()}
    return {"/".join(prefix): np.asarray(tree)}


@pytest.mark.parametrize("arch", ["gemma-7b", "dbrx-132b"])
def test_w8a16_equals_quantize_tree(arch):
    jcfg, cfg, model = f32_model(arch)
    tree = params_to_reference(model)
    want = flat_tree(quantize_tree(jax.tree.map(jnp.asarray, tree), jzoo.param_axes(jcfg)))
    got = flat_tree(params_to_reference(quantize_model(model)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    # stacked scales (n_units, *out); embeddings and raw expert tensors kept
    wq = [k for k in got if k.endswith("attn/wq/w_q")][0]
    assert got[wq[:-1] + "s"].shape == (cfg.n_units,) + got[wq].shape[2:]
    assert "embed" in got and got["embed"].dtype == np.float32
    assert not any(k.endswith("/w") for k in got)
    if arch == "dbrx-132b":
        assert got["units/0/moe/router/w_q"].dtype == np.int8
        assert got["units/0/moe/w_gate"].dtype == np.float32
    # and back: a w8a16 tree carried into the port is the same tree
    again = flat_tree(params_to_reference(params_from_reference(
        quantize_tree(jax.tree.map(jnp.asarray, tree), jzoo.param_axes(jcfg)), cfg, device="cpu")))
    for k, w in want.items():
        np.testing.assert_array_equal(again[k], w, err_msg=k)


def jdecode(jcfg, params, caches, toks):
    step = jax.jit(lambda p, c, tok, pos: tfm.forward_decode(p, jcfg, NULL_LAYOUT, tok, c, pos))
    out = []
    for i in range(toks.shape[1]):
        logits, caches = step(params, caches, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        out.append(host(logits)[:, 0])
    return np.stack(out, axis=1)


def tdecode(model, caches, toks):
    out = []
    for i in range(toks.shape[1]):
        logits, caches = model.forward_decode(torch.from_numpy(toks[:, i:i + 1]), caches, i)
        out.append(host(logits)[:, 0])
    return np.stack(out, axis=1)


def within_reference_bound(dec, full, rel: float, abs_: float, agree: float) -> None:
    """The reference's own variant contract: max |decode - full forward| <
    rel * scale + abs_, and the argmax agreeing on more than ``agree``."""
    scale = float(np.abs(full).max())
    assert float(np.abs(dec - full).max()) < rel * scale + abs_
    assert float(np.mean(dec.argmax(-1) == full.argmax(-1))) > agree


def test_w8a16_decode_equals_reference():
    """qwen2.5-32b smoke with the reference's own weights and inputs
    (``tests/test_w_int8.py``: ``init_model(PRNGKey(0))``, B = 2, 12
    tokens) decoded by the quantised model in float32 caches.  The bound
    is a property of those weights: with the port's seeded ones the
    argmax agreement came out 0.833, under it, while the decode still
    equalled the reference's."""
    jcfg = dataclasses.replace(jsmoke("qwen2.5-32b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"), dtype="float32")
    tree = jax.tree.map(np.asarray, tfm.init_model(jax.random.PRNGKey(0), jcfg)[0])
    model = params_from_reference(tree, cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    with torch.inference_mode():
        full = host(model.logits(model.forward_hidden(torch.from_numpy(toks))[0]))
    jq = quantize_tree(jax.tree.map(jnp.asarray, tree), jzoo.param_axes(jcfg))
    want = jdecode(jcfg, jq, tfm.init_caches(jcfg, 2, 12, jnp.float32), toks)
    quantize_model(model)
    got = tdecode(model, model.init_caches(2, 12, torch.float32), toks)
    np.testing.assert_allclose(got, want, **F32)
    within_reference_bound(got, full, 0.08, 0.5, 0.85)


# --------------------------------------------------------- the int8 KV cache
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_equals_reference(dtype):
    x = np.random.default_rng(2).normal(size=(3, 1, 4, 32)).astype(np.float32) * 3
    x[0, 0, 1] = 0.0  # an all-zero head: the 1e-9 clamp
    jq, js = jattn._quant_kv(jnp.asarray(x, getattr(jnp, dtype)))
    q, s = quant_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (3, 1, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("arch,t", [("deepseek-coder-33b", 16), ("gemma3-4b", 24),
                                    ("recurrentgemma-9b", 20)])
def test_int8_kv_decode_equals_reference(monkeypatch, arch, t):
    """``REPRO_KV_INT8=1`` read when the caches are made, in both packages:
    gemma3-4b's window-16 rings wrap past step 16; recurrentgemma-9b's
    RG-LRU states stay float32 beside its int8 KV ring."""
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    jcfg, cfg, model = f32_model(arch)
    tree = jax.tree.map(jnp.asarray, params_to_reference(model))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
    jc, c = tfm.init_caches(jcfg, 2, t, jnp.float32), model.init_caches(2, t, torch.float32)
    for jcache, cache, kind in zip(jc, c, cfg.layer_kinds):
        assert sorted(cache) == sorted(jcache), kind
        if kind in ("attn", "moe"):
            assert sorted(cache) == ["k_q", "k_s", "pos", "v_q", "v_s"]
            assert cache["k_q"].dtype == torch.int8 and cache["k_s"].dtype == torch.float32
    want, got = jdecode(jcfg, tree, jc, toks), tdecode(model, c, toks)
    np.testing.assert_allclose(got, want, **F32)
    if arch == "deepseek-coder-33b":  # the reference's tests/test_kv_int8.py contract
        with torch.inference_mode():
            full = host(model.logits(model.forward_hidden(torch.from_numpy(toks))[0]))
        within_reference_bound(got, full, 0.05, 0.3, 0.9)


def test_int8_kv_keeps_a_bf16_decode_in_bf16(monkeypatch):
    """The dequantised K and V come back in the activations' dtype, so a
    bf16 model decoding with the int8 cache (asked for in float32, as
    ``generate`` asks) stays bf16 after its first attention layer, in both
    packages, where float32 caches promote it."""
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    _, cfg = cfgs("bfloat16")
    jcfg = dataclasses.replace(jsmoke("gemma3-4b"), dtype="bfloat16")
    model = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 1, cfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    with torch.inference_mode():
        out, _ = model.layers[0].decode(x, model.init_caches(2, 8, torch.float32)[0], 0)
    assert out.dtype == torch.bfloat16
    lp = tfm.layer_params_for(jax.tree.map(jnp.asarray, params_to_reference(model)), jcfg, 0)
    jout, _ = tfm.apply_layer_decode(lp, jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                     tfm.init_caches(jcfg, 2, 8, jnp.float32)[0], jnp.int32(0),
                                     "attn", jcfg.layer_windows[0], jcfg, NULL_LAYOUT)
    assert jout.dtype == jnp.bfloat16
    monkeypatch.setenv("REPRO_KV_INT8", "0")
    with torch.inference_mode():
        out, _ = model.layers[0].decode(x, model.init_caches(2, 8, torch.float32)[0], 0)
    assert out.dtype == torch.float32
