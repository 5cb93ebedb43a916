"""The port's serving layouts executed on a mesh (``make_prefill_step`` /
``make_serve_step`` / ``RAGServer.generate`` with a ``prefill``,
``decode`` or ``long`` layout on a live mesh of gloo ranks on the CPU),
against the reference.

One module fixture runs, at once, the reference in a subprocess with 8
emulated XLA devices and two ``spawn_local`` worlds of gloo ranks:

* 8 ranks as a (2, 4) mesh: ``decode`` of the gemma3-4b, dbrx-132b,
  recurrentgemma-9b and xlstm-350m smoke configs (B = 4, a 6-token
  prompt teacher-forced, then 4 greedy tokens, float32 caches of 13
  slots: 13 does not divide by 4, and gemma's window-16 rings are
  shorter than their window) with float32 and with w8a16 weights, and
  ``prefill`` of gemma3-4b and internvl2-2b (its vision prefix sharded
  as tokens are), B = 4, T = 32;
* 4 ranks as a (1, 4) mesh: the same ``decode`` cases (the dbrx MoE's
  dropped pairs counted a step), gemma3-4b past its rings' wrap (a
  30-token prompt and 11 new tokens in 42 slots: 42 does not divide by
  4), the int8 KV cache, ``RAGServer(..., layout=)`` ``generate``,
  w8a16 weights cut by ``shard_model`` and w8a16 with the int8 KV
  cache; then the same ranks as a (2, 2) mesh (``Mesh.reshape``):
  ``long`` (B = 1) of gemma3-4b and dbrx-132b, float32 and w8a16, and
  ``prefill`` of every config, and w8a16 ``prefill`` of gemma3-4b and
  recurrentgemma-9b.

The w8a16 runs are held to the reference's one-device steps on its
``quantize_tree`` of the same weights, and every rank's codes and scales
to that tree's leaves sliced by its ``quantize_axes`` specs, bit for bit.

Bars against the reference's one-device output on the same weights (the
port's seeded init carried over by ``params_to_reference``) and inputs:
float32 logits within 2e-5 of their largest magnitude, greedy tokens
equal, each rank's cache blocks equal to slices of one device's caches
within the same bar (a short last block's padded slots empty), the MoE's
dropped pairs equal to one device's.  The reference's own jitted sharded
decode step (``in_shardings`` / ``out_shardings`` from ``tree_pspecs``
and ``cache_pspecs``, as its dry run builds them) runs on this jax and is
held to the same bar at an even cache length of 16 for gemma3-4b; the
other configs and the bf16 lattice are ``slow``.  ``generate`` is held to
the reference's ``generate`` with ``NULL_LAYOUT`` on the same index (the
layout changes placement, not the semantics, and the parent test process
has one XLA device).
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.sharding import NamedSharding, PartitionSpec, make_layout  # noqa: E402
from repro_torch.launch import AbstractMesh, spawn_local  # noqa: E402
from repro_torch.models import params_to_reference, zoo  # noqa: E402
from repro_torch.models.convert import shard_model  # noqa: E402
from repro_torch.models.layers import Linear, quantize_model  # noqa: E402
from repro_torch.models.transformer import leaf_path  # noqa: E402
from repro_torch.serve import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.serve.decode import cache_pspecs  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT_S = 240
DECODE_ARCHS = ("gemma3-4b", "dbrx-132b", "recurrentgemma-9b", "xlstm-350m")
PREFILL_ARCHS = DECODE_ARCHS + ("internvl2-2b",)
LONG_ARCHS = ("gemma3-4b", "dbrx-132b")
W8_PREFILL_ARCHS = ("gemma3-4b", "recurrentgemma-9b")  # the RG-LRU's prefill reads its weights apart
SHARDED_REF_ARCHS = ("gemma3-4b",)  # the reference's own sharded step in tier-1
B, PROMPT, NEW, LENGTH, EVEN, T = 4, 6, 4, 13, 16, 32
WRAP = (30, 11, 42)  # gemma3-4b past its rings' wrap: prompt, new tokens, cache length
SEARCH = dict(mode="gate", search_l=32, beam_width=4, result_k=3)
PASSAGE, RAG_PROMPT, RAG_NEW = 8, 6, 6
F32_BAR = 2e-5  # of the largest magnitude


def cfg_of(arch: str, dtype: str = "float32"):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype)


def model_of(arch: str, dtype: str = "float32"):
    return zoo.init_params(cfg_of(arch, dtype), torch.Generator().manual_seed(0), device="cpu")


def inputs_of(arch: str) -> dict:
    """The seeded inputs of an arch's cases (numpy), the same in every
    process."""
    cfg = cfg_of(arch)
    rng = np.random.default_rng(PREFILL_ARCHS.index(arch) + 11)
    out = {"decode": rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32),
           "long": rng.integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32),
           "wrap": rng.integers(0, cfg.vocab_size, (B, WRAP[0])).astype(np.int32)}
    t = T - (cfg.n_prefix_embeds if cfg.frontend == "vision_stub" else 0)
    out["prefill/tokens"] = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    if cfg.frontend == "vision_stub":
        out["prefill/prefix_embeds"] = (rng.normal(size=(B, cfg.n_prefix_embeds, cfg.d_model))
                                        * 0.02).astype(np.float32)
    return out


def decode_run(model, step, toks: np.ndarray, new: int, length: int) -> dict:
    """A teacher-forced prompt, then ``new`` greedy tokens fed back, through
    ``step``; ``toks`` the rows ``model`` decodes.  Returns every step's
    logits (steps, rows, V), next tokens (steps, rows) and the caches."""
    caches = model.init_caches(toks.shape[0] * (model.shard.batch.size if model.shard else 1),
                               length, torch.float32)
    tok, logits, nexts = torch.from_numpy(toks[:, :1]), [], []
    for t in range(toks.shape[1] + new - 1):
        r = step(model, caches, tok, t)
        logits.append(r["logits"][:, 0])
        nexts.append(r["next_tokens"][:, 0])
        tok = torch.from_numpy(toks[:, t + 1:t + 2]) if t + 1 < toks.shape[1] else r["next_tokens"]
    return {"logits": torch.stack(logits).numpy(), "tokens": torch.stack(nexts).numpy(),
            "caches": [{k: v.float().numpy() for k, v in c.items()} for c in caches]}


def count_drops(model) -> list:
    """Wrap each MoE layer's ``route_logits`` to append its dropped pairs to
    the returned list."""
    seen = []
    for layer in model.layers:
        moe = getattr(layer, "moe", None)
        if moe is not None:
            def route(logits, real=moe.route_logits):
                r = real(logits)
                seen.append(int((~r.kept).sum()))
                return r
            moe.route_logits = route
    return seen


def rank_decode(mesh, kind: str, arch: str, toks: np.ndarray, new: int, length: int,
                dtype: str = "float32", w8a16: bool = False) -> dict:
    """One rank's decode of ``toks`` (the whole batch) under ``kind``; with
    ``w8a16`` its w8a16 codes and scales too (``quant_blocks``)."""
    cfg, layout = cfg_of(arch, dtype), make_layout(kind, mesh)
    model = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", layout=layout,
                            w8a16=w8a16)
    rows = model.shard.batch.block(toks.shape[0])
    drops = count_drops(model)
    out = decode_run(model, make_serve_step(cfg, layout=layout), toks[rows], new, length)
    out.update(rows=(rows.start, rows.stop), drops=drops)
    if w8a16:
        out["blocks"] = quant_blocks(model)
    return out


def quant_blocks(model) -> dict:
    """A rank's w8a16 codes and scales by the reference's leaf paths: a
    stacked leaf's block as the rank's layers' blocks stacked in unit
    order, or its rows of scales as held (``layers.ScaleRows``)."""
    got: dict = {}
    for name, m in model.named_modules():
        if isinstance(m, Linear) and m.w is None:
            for leaf in ("w_q", "w_s"):
                path, u = leaf_path(model.cfg, f"{name}.{leaf}")
                got.setdefault(path, []).append((u, getattr(m, leaf), leaf == "w_s" and m.scale_rows))
    out = {}
    for path, held in got.items():
        held.sort(key=lambda x: -1 if x[0] is None else x[0])
        u, t, rows = held[0]
        out[path] = (t if u is None or rows else torch.stack([x[1] for x in held])).numpy()
    return out


def rank_prefill(mesh, arch: str, dtype: str = "float32", w8a16: bool = False) -> dict:
    cfg, layout = cfg_of(arch, dtype), make_layout("prefill", mesh)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", layout=layout,
                             w8a16=w8a16)
    batch = {k.split("/")[1]: v for k, v in inputs_of(arch).items() if k.startswith("prefill/")}
    r = make_prefill_step(cfg, layout=layout)(params, batch)
    rows = params.shard.batch.block(B)
    seq = params.shard.seq.block(T)
    return {"rows": (rows.start, rows.stop), "seq": (seq.start, seq.stop),
            "logits": r["logits"].float().numpy(),
            "caches": [(k.float().numpy(), v.float().numpy()) for k, v in r["caches"]],
            "gathered_bytes": params.gathered_bytes}


def _rank_2x4(mesh, d: str):
    torch.set_num_threads(1)  # a spawned rank starts with every core's thread
    out = {f"decode_{a}": rank_decode(mesh, "decode", a, inputs_of(a)["decode"], NEW, LENGTH)
           for a in DECODE_ARCHS}
    out.update({f"prefill_{a}": rank_prefill(mesh, a) for a in ("gemma3-4b", "internvl2-2b")})
    out.update({f"w8_decode_{a}": rank_decode(mesh, "decode", a, inputs_of(a)["decode"], NEW,
                                              LENGTH, w8a16=True) for a in DECODE_ARCHS})
    return out


def _rank_1x4(mesh, d: str):
    torch.set_num_threads(1)
    out = {f"decode_{a}": rank_decode(mesh, "decode", a, inputs_of(a)["decode"], NEW, LENGTH)
           for a in DECODE_ARCHS}
    p, n, length = WRAP
    out["wrap"] = rank_decode(mesh, "decode", "gemma3-4b", inputs_of("gemma3-4b")["wrap"], n, length)
    os.environ["REPRO_KV_INT8"] = "1"
    try:
        out["int8"] = rank_decode(mesh, "decode", "gemma3-4b", inputs_of("gemma3-4b")["decode"],
                                  NEW, LENGTH)
    finally:
        del os.environ["REPRO_KV_INT8"]
    out["generate"] = rank_generate(mesh, d)
    out.update({f"w8_decode_{a}": rank_decode(mesh, "decode", a, inputs_of(a)["decode"], NEW,
                                              LENGTH, w8a16=True) for a in DECODE_ARCHS})
    # w8a16 weights cut from a whole quantised model equal those drawn a leaf at a time
    layout = make_layout("decode", mesh)
    cut = shard_model(quantize_model(model_of("gemma3-4b")), layout)
    out["w8_shard_model"] = quant_blocks(cut)
    os.environ["REPRO_KV_INT8"] = "1"
    try:
        out["w8_int8"] = rank_decode(mesh, "decode", "gemma3-4b", inputs_of("gemma3-4b")["decode"],
                                     NEW, LENGTH, w8a16=True)
    finally:
        del os.environ["REPRO_KV_INT8"]
    mesh22 = mesh.reshape((2, 2))
    out["long"] = {a: rank_decode(mesh22, "long", a, inputs_of(a)["long"], NEW, LENGTH)
                   for a in LONG_ARCHS}
    out["w8_long"] = {a: rank_decode(mesh22, "long", a, inputs_of(a)["long"], NEW, LENGTH,
                                     w8a16=True) for a in LONG_ARCHS}
    out["prefill"] = {a: rank_prefill(mesh22, a) for a in PREFILL_ARCHS}
    out["w8_prefill"] = {a: rank_prefill(mesh22, a, w8a16=True) for a in W8_PREFILL_ARCHS}
    return out


def rag_requests(queries: np.ndarray, vocab: int, req_cls) -> list:
    rng = np.random.default_rng(4)
    return [req_cls(query_vec=queries[i], prompt_tokens=rng.integers(0, vocab, RAG_PROMPT)
                    .astype(np.int32), filter_kind="label", filter_params=np.int32(i % 3))
            for i in range(B)]


def rag_passages(n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (n, PASSAGE)).astype(np.int32)


def rank_generate(mesh, d: str) -> np.ndarray:
    """``RAGServer(..., layout=decode)`` on this rank's engine, loaded from
    the saved index."""
    from repro_torch.core import GateANNEngine, SearchConfig
    from repro_torch.serve import RAGRequest, RAGServer

    cfg, layout = cfg_of("gemma3-4b"), make_layout("decode", mesh)
    eng = GateANNEngine.load(os.path.join(d, "tiny.gann"), device="cpu")
    model = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", layout=layout)
    srv = RAGServer(eng, cfg, model, rag_passages(int(eng.codes.shape[0]), cfg.vocab_size),
                    SearchConfig(**SEARCH), layout=layout)
    queries = np.load(os.path.join(d, "queries.npy"))
    toks, _ = srv.generate(rag_requests(queries, cfg.vocab_size, RAGRequest),
                           max_new_tokens=RAG_NEW)
    return toks


REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys, traceback
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.distributed.sharding import NULL_LAYOUT, make_layout, tree_pspecs
    from repro.models import transformer as tfm
    from repro.models import zoo
    from repro.serve import make_prefill_step, make_serve_step
    from repro.serve.decode import cache_pspecs

    d = sys.argv[1]
    spec = json.load(open(d + "/cases.json"))
    key = lambda k: str(getattr(k, "key", getattr(k, "idx", k)))


    def load(arch):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        flat = dict(np.load(f"{d}/weights_{arch}.npz"))
        struct = jax.eval_shape(lambda k: tfm.init_model(k, cfg)[0], jax.random.PRNGKey(0))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(struct)
        return cfg, jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(flat["/".join(key(k) for k in path)]) for path, _ in leaves])


    def decode(cfg, params, toks, length, new, step=None, caches=None):
        step = step or jax.jit(make_serve_step(cfg, NULL_LAYOUT))
        c = caches if caches is not None else tfm.init_caches(cfg, toks.shape[0], length,
                                                              jnp.float32)
        tok, logits, nexts = jnp.asarray(toks[:, :1]), [], []
        for t in range(toks.shape[1] + new - 1):
            r = step(params, c, tok, jnp.int32(t))
            logits.append(np.asarray(r["logits"])[:, 0])
            nexts.append(np.asarray(r["next_tokens"])[:, 0])
            c = r["caches"]
            tok = jnp.asarray(toks[:, t + 1:t + 2]) if t + 1 < toks.shape[1] else r["next_tokens"]
        return np.stack(logits), np.stack(nexts), c


    out, notes = {}, {}
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for name, arch, length, new in spec["decode"]:
        cfg, params = load(arch)
        toks = np.load(f"{d}/in_{arch}_{name}.npy")
        lg, nx, c = decode(cfg, params, toks, length, new)
        out[f"{name}_{arch}/logits"], out[f"{name}_{arch}/tokens"] = lg, nx
        for i, layer in enumerate(c):
            for k, v in layer.items():
                out[f"{name}_{arch}/cache{i}/{k}"] = np.asarray(v, np.float32)
    for arch in spec["sharded"]:
        # the reference's own jitted step on (2, 4) under the decode layout,
        # in_shardings and out_shardings as its dry run builds them
        cfg, params = load(arch)
        layout = make_layout("decode", mesh)
        try:
            ns = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                                           is_leaf=lambda x: isinstance(x, P))
            p_sh = ns(tree_pspecs(zoo.param_axes(cfg), params, layout, stored=False))
            c_sh = ns(cache_pspecs(cfg, layout))
            ab = layout.act_axes("act_batch")
            step = jax.jit(make_serve_step(cfg, layout),
                           in_shardings=(p_sh, c_sh, NamedSharding(mesh, P(ab, None)),
                                         NamedSharding(mesh, P())),
                           out_shardings={"logits": NamedSharding(mesh, P(ab, None, None)),
                                          "next_tokens": NamedSharding(mesh, P(ab, None)),
                                          "caches": c_sh})
            toks = np.load(f"{d}/in_{arch}_decode.npy")
            caches = jax.device_put(tfm.init_caches(cfg, toks.shape[0], spec["even"], jnp.float32),
                                    c_sh)
            lg, nx, _ = decode(cfg, params, toks, spec["even"], spec["new"], step, caches)
            out[f"sharded_{arch}/logits"], out[f"sharded_{arch}/tokens"] = lg, nx
            lg, nx, _ = decode(cfg, params, toks, spec["even"], spec["new"])
            out[f"even_{arch}/logits"], out[f"even_{arch}/tokens"] = lg, nx
        except Exception as e:  # recorded: the test reports what did not run
            notes[f"sharded_{arch}"] = "".join(traceback.format_exception_only(e))[-600:]
    for arch in spec["prefill"]:
        cfg, params = load(arch)
        batch = {k: jnp.asarray(v) for k, v in np.load(f"{d}/in_{arch}_prefill.npz").items()}
        r = jax.jit(make_prefill_step(cfg, NULL_LAYOUT))(params, batch)
        out[f"prefill_{arch}/logits"] = np.asarray(r["logits"])
        caches = list(r["caches"])
        units = caches.pop(0) if cfg.n_units else ()
        n_unit = len(cfg.pattern_unit)
        unit_attn = [p for p, k in enumerate(cfg.pattern_unit) if k in ("attn", "moe")]
        attn = [i for i, k in enumerate(cfg.layer_kinds) if k in ("attn", "moe")]
        for j, i in enumerate(attn):
            if i < cfg.n_units * n_unit:
                u, pos = divmod(i, n_unit)
                kv = [np.asarray(a[u]) for a in units[unit_attn.index(pos)]]
            else:
                kv = [np.asarray(a) for a in caches.pop(0)]
            out[f"prefill_{arch}/k{j}"], out[f"prefill_{arch}/v{j}"] = kv
    # w8a16: the reference's quantize_tree of each tree, then its one-device steps,
    # its leaves and their compute specs under decode (long's are the same)
    from repro.models.layers import quantize_axes, quantize_tree
    norm = lambda s: [None if e is None else ([e] if isinstance(e, str) else list(e)) for e in s]
    qspecs = {}
    for arch in spec["w8_blocks"]:
        cfg, params = load(arch)
        axes = zoo.param_axes(cfg)
        qp, qaxes = quantize_tree(params, axes), quantize_axes(axes)
        sp = tree_pspecs(qaxes, qp, make_layout("decode", mesh), stored=False)
        flat_q = jax.tree_util.tree_flatten_with_path(qp)[0]
        flat_s = dict(jax.tree_util.tree_flatten_with_path(
            sp, is_leaf=lambda x: isinstance(x, P))[0])
        for path, leaf in flat_q:
            name = "/".join(key(k) for k in path)
            if name.endswith(("w_q", "w_s")):
                out[f"q_{arch}/{name}"] = np.asarray(leaf)
                qspecs[f"{arch}/{name}"] = norm(flat_s[path])
        for name, a2, length, new in spec["w8_decode"]:
            if a2 == arch:
                toks = np.load(f"{d}/in_{arch}_{name}.npy")
                lg, nx, _ = decode(cfg, qp, toks, length, new)
                out[f"w8_{name}_{arch}/logits"], out[f"w8_{name}_{arch}/tokens"] = lg, nx
        if arch in spec["w8_prefill"]:
            batch = {k: jnp.asarray(v) for k, v in np.load(f"{d}/in_{arch}_prefill.npz").items()}
            r = jax.jit(make_prefill_step(cfg, NULL_LAYOUT))(qp, batch)
            out[f"w8_prefill_{arch}/logits"] = np.asarray(r["logits"])
    json.dump(qspecs, open(d + "/ref_qspecs.json", "w"))
    np.savez(d + "/ref_out.npz", **out)
    json.dump(notes, open(d + "/ref_notes.json", "w"))
""")


def flat_ref(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat_ref(sub, prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat_ref(sub, prefix + (str(i),)).items()}
    return {"/".join(prefix): np.asarray(tree)}


def write_cases(d: str, sharded: tuple) -> None:
    """The weights (the port's seeded init in the reference's layout), the
    inputs and the list of reference runs, for the subprocess."""
    decode = []
    for a in PREFILL_ARCHS:
        np.savez(os.path.join(d, f"weights_{a}.npz"), **flat_ref(params_to_reference(model_of(a))))
        ins = inputs_of(a)
        for name in ("decode", "long", "wrap"):
            np.save(os.path.join(d, f"in_{a}_{name}.npy"), ins[name])
        np.savez(os.path.join(d, f"in_{a}_prefill.npz"),
                 **{k.split("/")[1]: v for k, v in ins.items() if k.startswith("prefill/")})
        if a in DECODE_ARCHS:
            decode.append(("decode", a, LENGTH, NEW))
        if a in LONG_ARCHS:
            decode.append(("long", a, LENGTH, NEW))
    decode.append(("wrap", "gemma3-4b", WRAP[2], WRAP[1]))
    w8 = [(name, a, LENGTH, NEW) for a in DECODE_ARCHS for name in ("decode", "long")
          if name == "decode" or a in LONG_ARCHS]
    json.dump({"decode": decode, "prefill": PREFILL_ARCHS, "sharded": sharded, "even": EVEN,
               "new": NEW, "w8_decode": w8, "w8_prefill": W8_PREFILL_ARCHS,
               "w8_blocks": DECODE_ARCHS}, open(os.path.join(d, "cases.json"), "w"))


def reference(d: str) -> subprocess.Popen:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", REFERENCE, d], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait(proc: subprocess.Popen) -> None:
    _, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err


@pytest.fixture(scope="module")
def results(tmp_path_factory, tiny_engine, tiny_corpus):
    from repro.core import SearchConfig as JSearchConfig
    from repro.distributed.sharding import NULL_LAYOUT
    from repro.serve import RAGRequest as JRequest
    from repro.serve import RAGServer as JRAGServer

    d = str(tmp_path_factory.mktemp("sharded_serve"))
    write_cases(d, SHARDED_REF_ARCHS)
    tiny_engine.save(os.path.join(d, "tiny.gann"))
    np.save(os.path.join(d, "queries.npy"), tiny_corpus[2])
    ref = reference(d)
    try:  # the two worlds at once, each on its own store
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            w24 = pool.submit(spawn_local, _rank_2x4, (2, 4), backend="gloo", device="cpu",
                              timeout_s=TIMEOUT_S, args=(d,))
            w14 = pool.submit(spawn_local, _rank_1x4, (1, 4), backend="gloo", device="cpu",
                              timeout_s=TIMEOUT_S, args=(d,))
            r24, r14 = w24.result(), w14.result()
    finally:
        wait(ref)
    from repro.configs import get_smoke_config as jsmoke

    jcfg = dataclasses.replace(jsmoke("gemma3-4b"), dtype="float32")
    n = int(tiny_engine.codes.shape[0])
    jsrv = JRAGServer(engine=tiny_engine, cfg=jcfg, params=params_to_reference(model_of("gemma3-4b")),
                      layout=NULL_LAYOUT, passage_tokens=rag_passages(n, jcfg.vocab_size),
                      search_config=JSearchConfig(**SEARCH))
    want, _ = jsrv.generate(rag_requests(tiny_corpus[2], jcfg.vocab_size, JRequest),
                            max_new_tokens=RAG_NEW)
    return {"dir": d, "2x4": r24, "1x4": r14, "ref": dict(np.load(os.path.join(d, "ref_out.npz"))),
            "qspecs": json.load(open(os.path.join(d, "ref_qspecs.json"))),
            "notes": json.load(open(os.path.join(d, "ref_notes.json"))), "generate": want}


def close(got, want, what: str) -> float:
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) if want.size else 0.0
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    assert err <= F32_BAR * scale, f"{what}: max |err| {err} at scale {scale}"
    return err


def held_decode(ranks: list, ref: dict, key: str, what: str) -> None:
    """Every rank's logits and tokens against the reference's rows."""
    for r in ranks:
        rows = slice(*r["rows"])
        np.testing.assert_array_equal(r["tokens"], ref[f"{key}/tokens"][:, rows], err_msg=what)
        close(r["logits"], ref[f"{key}/logits"][:, rows], what)


def held_caches(ranks: list, ref: dict, key: str, cfg, kind: str, shape: tuple) -> None:
    """Each rank's final cache blocks against slices of the reference's
    caches (``cache_pspecs``' blocks); a short block's padded slots empty."""
    mesh = AbstractMesh(("data", "model"), shape)
    specs = cache_pspecs(cfg, make_layout(kind, mesh))
    for rank, r in enumerate(ranks):
        for i, (spec, cache) in enumerate(zip(specs, r["caches"])):
            for name, got in cache.items():
                want = ref[f"{key}/cache{i}/{name}"]
                blk = NamedSharding(mesh, spec[name]).block(want.shape, rank)
                part = want[blk]
                inner = tuple(slice(0, n) for n in part.shape)
                close(got[inner], part, f"{key} rank {rank} cache {i} {name}")
                pad = np.ones(got.shape, bool)
                pad[inner] = False
                assert np.all(got[pad] == (-1 if name == "pos" else 0)), (key, i, name)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
@pytest.mark.parametrize("mesh", ["2x4", "1x4"])
def test_decode_equals_reference(results, arch, mesh):
    """``decode`` at a cache length (13) that divides by neither axis:
    logits, greedy tokens and cache blocks equal the reference's one-device
    decode; gemma's rings (13 slots for a window of 16) are shorter than
    their window."""
    ranks = [r[f"decode_{arch}"] for r in results[mesh]]
    held_decode(ranks, results["ref"], f"decode_{arch}", f"{arch} decode {mesh}")
    held_caches(ranks, results["ref"], f"decode_{arch}", cfg_of(arch), "decode",
                (2, 4) if mesh == "2x4" else (1, 4))


def test_moe_decode_drops_the_pairs_of_one_device(results):
    """dbrx-132b's decode routes the global batch: on (2, 4) (two halves of
    the batch over ``data``) and on (1, 4) every rank counts one device's
    dropped pairs at every step, and some pairs drop."""
    model = model_of("dbrx-132b")
    want = count_drops(model)
    decode_run(model, make_serve_step(cfg_of("dbrx-132b")), inputs_of("dbrx-132b")["decode"],
               NEW, LENGTH)
    assert sum(want) > 0
    for mesh in ("2x4", "1x4"):
        for r in results[mesh]:
            assert r["decode_dbrx-132b"]["drops"] == want, mesh


def test_decode_past_the_ring_wrap(results):
    """gemma3-4b on (1, 4) decodes 40 positions into 42 slots (4 ranks:
    blocks of 11, the last of 9 and 2 empty slots) with window-16 rings
    that wrap."""
    ranks = [r["wrap"] for r in results["1x4"]]
    held_decode(ranks, results["ref"], "wrap_gemma3-4b", "gemma3-4b wrap")
    held_caches(ranks, results["ref"], "wrap_gemma3-4b", cfg_of("gemma3-4b"), "decode", (1, 4))


@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_long_equals_reference(results, arch):
    """``long`` on (2, 2): B = 1, every cache over data x model (data-major),
    the softmax reduced over the world."""
    ranks = [r["long"][arch] for r in results["1x4"]]
    held_decode(ranks, results["ref"], f"long_{arch}", f"{arch} long")
    held_caches(ranks, results["ref"], f"long_{arch}", cfg_of(arch), "long", (2, 2))


@pytest.mark.parametrize("arch,mesh", [(a, "2x2") for a in PREFILL_ARCHS]
                         + [("gemma3-4b", "2x4"), ("internvl2-2b", "2x4")])
def test_prefill_equals_reference(results, arch, mesh):
    """``prefill`` with ZeRO-stored parameters gathered a layer at a time:
    each rank's rows' last logits, equal on every ``model`` rank, and its
    (rows, sequence) block of every attention layer's K/V."""
    ranks = ([r["prefill"][arch] for r in results["1x4"]] if mesh == "2x2"
             else [r[f"prefill_{arch}"] for r in results["2x4"]])
    ref = results["ref"]
    n_attn = sum(k in ("attn", "moe") for k in cfg_of(arch).layer_kinds)
    for r in ranks:
        rows, seq = slice(*r["rows"]), slice(*r["seq"])
        close(r["logits"], ref[f"prefill_{arch}/logits"][rows], f"{arch} prefill logits")
        assert len(r["caches"]) == n_attn
        for j, (k, v) in enumerate(r["caches"]):
            close(k, ref[f"prefill_{arch}/k{j}"][rows, seq], f"{arch} prefill k{j}")
            close(v, ref[f"prefill_{arch}/v{j}"][rows, seq], f"{arch} prefill v{j}")
        assert r["gathered_bytes"] > 0


@pytest.mark.parametrize("arch", SHARDED_REF_ARCHS)
def test_reference_sharded_decode_step(results, arch):
    """The reference's own jitted decode step under its (2, 4) decode layout
    runs on this jax and equals its one-device step (cache length 16),
    within the bar; the port's (2, 4) ranks are held to the one-device
    step too."""
    ref = results["ref"]
    assert f"sharded_{arch}" not in results["notes"], results["notes"]
    np.testing.assert_array_equal(ref[f"sharded_{arch}/tokens"], ref[f"even_{arch}/tokens"])
    close(ref[f"sharded_{arch}/logits"], ref[f"even_{arch}/logits"], f"{arch} reference sharded")
    np.testing.assert_array_equal(ref[f"even_{arch}/tokens"], ref[f"decode_{arch}/tokens"])


def test_int8_kv_decode(results):
    """``REPRO_KV_INT8=1`` under ``decode`` on (1, 4): the rank's int8 code
    and scale blocks are one device's (the port's, held to the reference's
    in ``test_torch_lm_serve.py``), but for codes whose quotient sits at a
    rounding tie (one step apart), and the tokens equal."""
    mesh = AbstractMesh(("data", "model"), (1, 4))
    os.environ["REPRO_KV_INT8"] = "1"
    try:
        one = decode_run(model_of("gemma3-4b"), make_serve_step(cfg_of("gemma3-4b")),
                         inputs_of("gemma3-4b")["decode"], NEW, LENGTH)
        specs = cache_pspecs(cfg_of("gemma3-4b"), make_layout("decode", mesh))
    finally:
        del os.environ["REPRO_KV_INT8"]
    ranks = [r["int8"] for r in results["1x4"]]
    held = {f"int8/{k}": v for k, v in (("logits", one["logits"]), ("tokens", one["tokens"]))}
    for i, c in enumerate(one["caches"]):
        assert sorted(c) == ["k_q", "k_s", "pos", "v_q", "v_s"]
        held.update({f"int8/cache{i}/{k}": v for k, v in c.items()})
    held_decode(ranks, held, "int8", "int8 kv")
    flips = total = 0
    for rank, r in enumerate(ranks):
        for i, spec in enumerate(specs):
            for name in ("k_q", "v_q"):
                want = one["caches"][i][name]
                part = want[NamedSharding(mesh, spec[name]).block(want.shape, rank)]
                got = r["caches"][i][name][tuple(slice(0, n) for n in part.shape)]
                assert np.abs(got - part).max() <= 1, (i, name)
                flips += int((got != part).sum())
                total += part.size
    assert flips <= total * 1e-3, (flips, total)


def test_generate_under_the_decode_layout(results):
    """``RAGServer(..., layout=decode)`` on (1, 4), each rank retrieving with
    its own engine (loaded from one index file): every rank returns the
    reference's ``generate`` tokens."""
    for r in results["1x4"]:
        assert r["generate"].dtype == np.int32 and r["generate"].shape == (B, RAG_NEW)
        np.testing.assert_array_equal(r["generate"], results["generate"])


@pytest.mark.parametrize("arch", DECODE_ARCHS)
@pytest.mark.parametrize("mesh", ["2x4", "1x4"])
def test_w8a16_decode_equals_reference(results, arch, mesh):
    """w8a16 weights under ``decode`` (drawn a leaf at a time, each linear
    quantised whole before it is cut): logits and greedy tokens equal the
    reference's one-device step on its ``quantize_tree`` of the same
    weights."""
    ranks = [r[f"w8_decode_{arch}"] for r in results[mesh]]
    held_decode(ranks, results["ref"], f"w8_decode_{arch}", f"{arch} w8a16 decode {mesh}")


@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_w8a16_long_equals_reference(results, arch):
    """w8a16 weights under ``long`` on (2, 2) against the reference's
    one-device w8a16 step."""
    ranks = [r["w8_long"][arch] for r in results["1x4"]]
    held_decode(ranks, results["ref"], f"w8_long_{arch}", f"{arch} w8a16 long")


@pytest.mark.parametrize("arch", W8_PREFILL_ARCHS)
def test_w8a16_prefill_equals_reference(results, arch):
    """w8a16 codes and scales stored ZeRO-sharded under ``prefill`` on
    (2, 2), gathered a layer at a time: each rank's rows' logits against
    the reference's one-device w8a16 prefill."""
    for r in results["1x4"]:
        got = r["w8_prefill"][arch]
        close(got["logits"], results["ref"][f"w8_prefill_{arch}/logits"][slice(*got["rows"])],
              f"{arch} w8a16 prefill")


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_w8a16_blocks_equal_reference_leaves(results, arch):
    """Every rank's w8a16 codes and scales, on (2, 4), (1, 4) and (2, 2),
    bit for bit the reference's ``quantize_tree`` leaves sliced by its
    ``quantize_axes`` specs: a stacked leaf's scales (units, *out) carry
    the axes of ``w[1:]``, so the units split over ``model`` and a rank
    holds those rows (ROADMAP, Queue 3)."""
    ref, specs = results["ref"], results["qspecs"]
    runs = [("2x4", (2, 4), lambda r: r[f"w8_decode_{arch}"]),
            ("1x4", (1, 4), lambda r: r[f"w8_decode_{arch}"]),
            ("1x4", (2, 2), lambda r: r["w8_long"][arch] if arch in LONG_ARCHS else None)]
    if arch == "gemma3-4b":
        runs.append(("1x4", (1, 4), lambda r: {"blocks": r["w8_shard_model"]}))
    quirk = 0
    for mesh_name, shape, pick in runs:
        mesh = AbstractMesh(("data", "model"), shape)
        for rank, r in enumerate(results[mesh_name]):
            got = pick(r)
            if got is None:
                continue
            paths = {k.split("/", 1)[1] for k in specs if k.startswith(arch + "/")}
            assert set(got["blocks"]) == paths, (arch, shape)
            for path, block in got["blocks"].items():
                want = ref[f"q_{arch}/{path}"]
                spec = PartitionSpec(*[None if e is None else tuple(e)
                                       for e in specs[f"{arch}/{path}"]])
                part = want[NamedSharding(mesh, spec).block(want.shape, rank)]
                assert block.dtype == part.dtype and np.array_equal(block, part), \
                    (arch, shape, rank, path)
                quirk += path.startswith("units/") and path.endswith("w_s") and spec[0] is not None
    assert quirk > 0  # the stacked scales' quirk was held


def test_w8a16_with_int8_kv_decode(results):
    """w8a16 weights and the int8 KV cache together under ``decode`` on
    (1, 4): logits and tokens equal one device's w8a16 + int8 KV decode
    (the port's, held to the reference's in ``test_torch_lm_serve.py``)."""
    os.environ["REPRO_KV_INT8"] = "1"
    try:
        one = decode_run(quantize_model(model_of("gemma3-4b")), make_serve_step(cfg_of("gemma3-4b")),
                         inputs_of("gemma3-4b")["decode"], NEW, LENGTH)
    finally:
        del os.environ["REPRO_KV_INT8"]
    assert "k_q" in results["1x4"][0]["w8_int8"]["caches"][0]
    held = {"w8_int8/logits": one["logits"], "w8_int8/tokens": one["tokens"]}
    held_decode([r["w8_int8"] for r in results["1x4"]], held, "w8_int8", "w8a16 + int8 kv")


def test_refusals_without_a_live_mesh():
    """An ``AbstractMesh`` plans but does not execute: every serving entry
    point raises on one; a step given a layout kind it does not run
    raises; the train step refuses the serving layouts."""
    from repro_torch.train.train_step import TrainHParams, make_train_step

    cfg = cfg_of("gemma3-4b")
    mesh = AbstractMesh(("data", "model"), (2, 2))
    for kind in ("prefill", "decode", "long"):
        layout = make_layout(kind, mesh)
        step = make_prefill_step if kind == "prefill" else make_serve_step
        with pytest.raises(ValueError, match="joins no world"):
            step(cfg, layout=layout)
        with pytest.raises(ValueError, match="joins no world"):
            zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", layout=layout)
        with pytest.raises(NotImplementedError):
            make_train_step(cfg, TrainHParams(), layout=layout)
    with pytest.raises(NotImplementedError, match="not executed by this step"):
        make_prefill_step(cfg, layout=make_layout("decode", mesh))
    with pytest.raises(NotImplementedError, match="not executed by this step"):
        make_serve_step(cfg, layout=make_layout("prefill", mesh))


def test_uneven_blocks_as_xla_splits():
    """``NamedSharding`` splits a dimension that does not divide as XLA does:
    ceiling-sized blocks, the last ones short or empty, ``shard_shape`` the
    padded block."""
    mesh = AbstractMesh(("data", "model"), (1, 4))
    sh = NamedSharding(mesh, cache_pspecs(cfg_of("gemma3-4b"),
                                          make_layout("decode", mesh))[0]["k"])
    shape = (4, 5, 2, 16)
    assert sh.shard_shape(shape) == (4, 2, 2, 16)
    assert [sh.block(shape, r)[1] for r in range(4)] == [slice(0, 2), slice(2, 4), slice(4, 5),
                                                        slice(5, 5)]


# ------------------------------------------------------------ the slow lattice
def _rank_lattice(mesh, dtype: str):
    torch.set_num_threads(1)
    out = {}
    for shape in ((1, 4), (2, 2)):
        m = mesh.reshape(shape)
        for a in DECODE_ARCHS:
            out[f"decode_{a}_{shape}"] = rank_decode(m, "decode", a, inputs_of(a)["decode"], NEW,
                                                     LENGTH, dtype)
            out[f"long_{a}_{shape}"] = rank_decode(m, "long", a, inputs_of(a)["long"], NEW,
                                                   LENGTH, dtype)
        for a in PREFILL_ARCHS:
            out[f"prefill_{a}_{shape}"] = rank_prefill(m, a, dtype)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lattice_against_one_device(dtype):
    """Every config x layout x mesh shape, float32 and bf16, against the
    port's one-device steps (held to the reference in
    ``test_torch_lm_serve.py`` / ``test_torch_models.py``): logits within
    2e-5 (float32) or 3e-2 (bf16) of their largest magnitude, greedy
    tokens equal (bf16: up to the first step whose one-device top-2 gap is
    under the bar)."""
    bar = F32_BAR if dtype == "float32" else 3e-2
    ranks = spawn_local(_rank_lattice, (1, 4), backend="gloo", device="cpu", timeout_s=600,
                        args=(dtype,))
    for a in PREFILL_ARCHS:
        model = model_of(a, dtype)
        batch = {k.split("/")[1]: v for k, v in inputs_of(a).items() if k.startswith("prefill/")}
        want = make_prefill_step(cfg_of(a, dtype))(model, batch)
        runs = {}
        if a in DECODE_ARCHS:
            for kind in ("decode", "long"):
                runs[kind] = decode_run(model, make_serve_step(cfg_of(a, dtype)),
                                        inputs_of(a)[kind], NEW, LENGTH)
        for shape in ((1, 4), (2, 2)):
            for r in ranks:
                p = r[f"prefill_{a}_{shape}"]
                rows, seq = slice(*p["rows"]), slice(*p["seq"])
                w = want["logits"][rows].float().numpy()
                assert np.abs(p["logits"] - w).max() <= bar * max(np.abs(w).max(), 1), (a, shape)
                for (k, v), (wk, wv) in zip(p["caches"], want["caches"]):
                    for g, x in ((k, wk), (v, wv)):
                        x = x[rows, seq].float().numpy()
                        assert np.abs(g - x).max() <= bar * max(np.abs(x).max(), 1), (a, shape)
                for kind, run in runs.items():
                    g = r[f"{kind}_{a}_{shape}"]
                    rows = slice(*g["rows"])
                    logits, toks = run["logits"][:, rows], run["tokens"][:, rows]
                    top2 = np.sort(logits, axis=-1)[..., -2:]
                    gap = (top2[..., 1] - top2[..., 0]).min(axis=1)
                    close_at = next((i for i, x in enumerate(gap) if x < bar * 10), len(gap))
                    np.testing.assert_array_equal(g["tokens"][:close_at], toks[:close_at])
                    upto = min(close_at + 1, len(gap))
                    scale = max(np.abs(logits[:upto]).max(), 1)
                    assert np.abs(g["logits"][:upto] - logits[:upto]).max() <= bar * scale, \
                        (a, kind, shape)


@pytest.mark.slow
def test_reference_sharded_decode_step_every_kind(tmp_path):
    """The reference's own jitted decode step under its (2, 4) decode layout
    for every layer kind runs on this jax (with ``out_shardings`` as its
    dry run passes them: without them xlstm-350m's state does not come
    back in ``cache_pspecs``' sharding, ROADMAP Queue 3) and equals its
    one-device step within the bar."""
    d = str(tmp_path)
    write_cases(d, DECODE_ARCHS)
    wait(reference(d))
    ref, notes = dict(np.load(os.path.join(d, "ref_out.npz"))), json.load(
        open(os.path.join(d, "ref_notes.json")))
    assert not notes, notes
    for arch in DECODE_ARCHS:
        np.testing.assert_array_equal(ref[f"sharded_{arch}/tokens"], ref[f"even_{arch}/tokens"])
        close(ref[f"sharded_{arch}/logits"], ref[f"even_{arch}/logits"], f"{arch} reference sharded")
