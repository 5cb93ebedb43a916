"""The port's command-line surface against the reference's, on the CPU.

Each entry point of ``examples/torch_*.py`` and ``scripts/torch_*.py``
is held to the reference on one tiny index the reference builds and
saves (N = 1,500, D = 24, labels, norms and tag bits): both packages load
that file, so they search the same graph.  The port's row functions
equal the reference's library calls on its engine — ids, recall and
every per-query counter exactly, the cost model's latency and QPS to
1e-6 relative, the neighbour store's bytes exactly; ``inspect`` and the
obs report print the reference's text; files each tool shards or merges
load and verify in the other; ``generate`` returns the reference's
tokens and ``io_report``; the training example resumes bit for bit.
"""
import argparse
import contextlib
import dataclasses
import importlib.util
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import GateANNEngine as JEngine  # noqa: E402
from repro.core import SearchConfig as JConfig  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro.core import recall_at_k as jrecall  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.filter_store import AndFilter as JAndFilter  # noqa: E402
from repro.core.filter_store import pack_query_tags as jpack_query_tags  # noqa: E402
from repro.core.filter_store import pack_tags as jpack_tags  # noqa: E402
from repro.core.neighbor_store import NeighborStore as JNeighborStore  # noqa: E402
from repro.distributed.sharding import NULL_LAYOUT  # noqa: E402
from repro.models import transformer as tfm  # noqa: E402
from repro.serve import RAGRequest as JRequest  # noqa: E402
from repro.serve import RAGServer as JRAGServer  # noqa: E402
from repro.store import read_header as jread_header  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import GateANNEngine  # noqa: E402
from repro_torch.core import pq as pqm  # noqa: E402
from repro_torch.core.filter_store import pack_query_tags, pack_tags  # noqa: E402
from repro_torch.data import (  # noqa: E402
    filtered_ground_truth,
    make_bigann_like,
    make_queries,
    multilabel_tags,
    norm_bin_attribute,
    uniform_labels,
)
from repro_torch.models import params_from_reference  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
N, D, NQ, VOCAB = 1_500, 24, 16, 512
CONFIG = dict(degree=20, build_l=40, pq_chunks=8, r_max=10)
REL = 1e-6  # the cost model's figures


def load_entry(rel: str):
    """Import an entry point by path (its ``main`` does not run)."""
    name = "cli_" + os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


qs = load_entry("examples/torch_quickstart.py")
demo = load_entry("examples/torch_filtered_search_demo.py")
rag = load_entry("examples/torch_rag_serve.py")
train_lm = load_entry("examples/torch_train_lm.py")
convert = load_entry("scripts/torch_convert_index.py")
obs_report = load_entry("scripts/torch_obs_report.py")
smoke_core = load_entry("scripts/torch_smoke_core.py")
diag = load_entry("scripts/torch_diag_recall.py")
smoke_models = load_entry("scripts/torch_smoke_models.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test workers on the machine's cores: one
    torch thread a worker keeps them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The reference builds and saves one tiny index; each package loads it."""
    corpus = make_bigann_like(N, D, seed=0)
    labels = uniform_labels(N, 10, seed=0)
    norms, edges = norm_bin_attribute(corpus, 10)
    tags = multilabel_tags(N, vocab=VOCAB, mean_tags=5.0, seed=0)
    built = JEngine.build(corpus, config=JEngineConfig(**CONFIG), labels=labels,
                          attributes=norms, tag_bits=jpack_tags(tags, VOCAB))
    path = str(tmp_path_factory.mktemp("torch_cli") / "shared.gann")
    built.save(path)
    return argparse.Namespace(
        path=path, corpus=corpus, labels=labels, norms=norms, edges=edges, tags=tags,
        queries=make_queries(corpus, NQ, seed=1), target=np.zeros(NQ, np.int32),
        jeng=JEngine.load(path), peng=GateANNEngine.load(path, device="cpu"))


def captured(fn, *args, **kwargs):
    """``fn``'s result and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def jmean(x) -> float:
    return float(np.mean(np.asarray(x)))


def close(got: float, want: float) -> bool:
    return abs(got - want) <= REL * max(abs(want), 1e-30)


# ----------------------------------------------------------------- quickstart
def test_quickstart_mode_rows_equal_reference(shared):
    gt = filtered_ground_truth(shared.corpus, shared.queries, shared.labels == 0, k=10)
    rows, text = captured(qs.mode_rows, shared.peng, shared.queries, shared.target, gt)
    assert [r["mode"] for r in rows] == list(qs.MODES) and text == ""
    for r in rows:
        out = shared.jeng.search(shared.queries, filter_kind="label", filter_params=shared.target,
                                 search_config=JConfig(mode=r["mode"], search_l=100, beam_width=8))
        np.testing.assert_array_equal(r["ids"], np.asarray(out.ids))
        assert r["recall"] == jrecall(out.ids, gt, 10)
        assert r["ios"] == jmean(out.stats.n_ios) and r["tunnels"] == jmean(out.stats.n_tunnels)
        assert close(r["latency_us"], shared.jeng.modeled_latency_us(out.stats))
        assert close(r["qps"], shared.jeng.modeled_qps(out.stats))
    gate, post = (next(r for r in rows if r["mode"] == m) for m in ("gate", "post"))
    assert gate["ios"] < post["ios"]


def test_quickstart_cache_rows_equal_reference(shared):
    rows = qs.cache_rows(shared.peng, shared.queries, shared.target)
    assert [r["records"] for r in rows] == list(qs.CACHE_RECORDS)
    for r in rows:
        cached = shared.jeng.with_cache(r["records"] * 4096)
        out = cached.search(shared.queries, filter_kind="label", filter_params=shared.target,
                            search_config=JConfig(mode="gate", search_l=100, beam_width=8))
        np.testing.assert_array_equal(r["ids"], np.asarray(out.ids))
        np.testing.assert_array_equal(r["n_ios"], np.asarray(out.stats.n_ios))
        np.testing.assert_array_equal(r["n_cache_hits"], np.asarray(out.stats.n_cache_hits))
        assert r["ios"] == jmean(out.stats.n_ios) and r["hits"] == jmean(out.stats.n_cache_hits)
        assert close(r["qps"], cached.modeled_qps(out.stats))
        # every budget: slow reads + hits == the uncached run's reads
        np.testing.assert_array_equal(r["n_ios"] + r["n_cache_hits"], rows[0]["n_ios"])
    assert rows[-1]["hits"] > 0


def test_quickstart_disk_rows_equal_reference(shared):
    rows, io_mode = qs.disk_rows(shared.peng, shared.path, shared.queries, shared.target)
    disk = JEngine.load(shared.path, store_tier="disk")
    store = disk.record_store
    assert io_mode == store.io_mode
    for r in rows:
        cfg = JConfig(mode=r["mode"], search_l=100, beam_width=8)
        before = store.io_counters()
        out = disk.search(shared.queries, filter_kind="label", filter_params=shared.target,
                          search_config=cfg)
        ids = np.asarray(out.ids)
        d = {k: v - before[k] for k, v in store.io_counters().items()}
        np.testing.assert_array_equal(r["ids"], ids)
        assert r["match"] is True
        assert r["pages"] == d["pages_read"] / NQ and r["uniq"] == d["unique_sectors_read"] / NQ
        assert r["ios"] == jmean(out.stats.n_ios)
        assert r["sys_per_round"] == d["syscalls"] / max(d["read_rounds"], 1)
    store.close()


# --------------------------------------------------------------------- demo
def test_demo_family_rows_equal_reference(shared):
    s = shared
    rows, text = captured(demo.family_rows, s.peng, s.queries, s.labels, s.norms, s.edges, s.tags)
    assert [r["clean"] for r in rows] == [True] * 4
    assert text.count("predicate-clean=True") == 4
    cfg = JConfig(mode="gate", search_l=80, beam_width=8)
    lo, hi = float(s.edges[3]), float(s.edges[4])
    bounds = (np.full(NQ, lo, np.float32), np.full(NQ, hi, np.float32))
    qtags = demo.multilabel_queries(s.tags, NQ, n_tags=(1, 2), seed=2)
    want = [
        s.jeng.search(s.queries, filter_kind="label", filter_params=s.target, search_config=cfg),
        s.jeng.search(s.queries, filter_kind="range", filter_params=bounds, search_config=cfg),
        s.jeng.search(s.queries, filter_kind="tags",
                      filter_params=jnp.asarray(jpack_tags(qtags, VOCAB)), search_config=cfg),
        jsearch.filtered_search(
            fetch=s.jeng.record_store.fetch_fn(), neighbor_store=s.jeng.neighbor_store,
            filter_check=JAndFilter((s.jeng.filters["label"], s.jeng.filters["range"])).bind(
                s.target, bounds),
            lut=jpq.build_lut(s.jeng.codec, jnp.asarray(s.queries)), codes=s.jeng.codes,
            entry=s.jeng.medoid, queries=jnp.asarray(s.queries), config=cfg),
    ]
    for r, out in zip(rows, want):
        np.testing.assert_array_equal(r["ids"], np.asarray(out.ids), err_msg=r["name"])
        assert r["ios"] == jmean(out.stats.n_ios) and r["tunnels"] == jmean(out.stats.n_tunnels)


def test_demo_rmax_rows_equal_reference(shared):
    eng = dataclasses.replace(shared.peng)  # the sweep swaps the engine's neighbour store
    jeng = dataclasses.replace(shared.jeng)
    rows = demo.rmax_rows(eng, shared.queries)
    cfg = JConfig(mode="gate", search_l=80, beam_width=8)
    for r in rows:
        jeng.neighbor_store = JNeighborStore.from_graph(jeng.record_store.neighbors, r["r_max"])
        out = jeng.search(shared.queries, filter_kind="label", filter_params=shared.target,
                          search_config=cfg)
        assert r["dram_bytes"] == jeng.neighbor_store.memory_bytes()
        assert r["ios"] == jmean(out.stats.n_ios)
    assert [r["dram_bytes"] for r in rows] == sorted({r["dram_bytes"] for r in rows})
    assert shared.peng.neighbor_store.r_max == CONFIG["r_max"]


# ---------------------------------------------------- smoke_core, diag_recall
def test_smoke_core_rows_equal_reference(shared):
    gt = filtered_ground_truth(shared.corpus, shared.queries, shared.labels == 0, k=10)
    rows, text = captured(smoke_core.mode_rows, shared.peng, shared.queries, shared.target, gt)
    assert text.count("recall@10=") == len(smoke_core.MODES)
    for r in rows:
        out = shared.jeng.search(shared.queries, filter_kind="label", filter_params=shared.target,
                                 search_config=JConfig(mode=r["mode"], search_l=48, beam_width=4))
        np.testing.assert_array_equal(r["ids"], np.asarray(out.ids))
        assert r["recall"] == jrecall(out.ids, gt, 10)
        assert (r["ios"], r["tunnels"], r["hops"]) == (
            jmean(out.stats.n_ios), jmean(out.stats.n_tunnels), jmean(out.stats.n_hops))
        assert close(r["qps"], shared.jeng.modeled_qps(out.stats))


def test_diag_recall_rows_equal_reference(shared):
    gt_all = filtered_ground_truth(shared.corpus, shared.queries, np.ones(N, bool), k=10)
    gt_f = filtered_ground_truth(shared.corpus, shared.queries, shared.labels == 0, k=10)
    ls = diag.LS[::2]  # L = 16 and 64: each L is a jit of its own in the reference
    rows, text = captured(diag.l_rows, shared.peng, shared.queries, gt_all, gt_f, shared.target,
                          ls=ls)
    assert [r["L"] for r in rows] == list(ls) and text.count("unfilt=") == len(ls)
    for r in rows:
        for mode, gt in (("unfiltered", gt_all), ("gate", gt_f), ("post", gt_f)):
            kw = {} if mode == "unfiltered" else dict(filter_kind="label",
                                                      filter_params=shared.target)
            out = shared.jeng.search(shared.queries, search_config=JConfig(
                mode=mode, search_l=r["L"], result_k=10, beam_width=4), **kw)
            np.testing.assert_array_equal(r["ids"][mode], np.asarray(out.ids))
            assert r[mode] == jrecall(out.ids, gt, 10)
            assert r[f"{mode}_ios"] == jmean(out.stats.n_ios)
            if mode == "gate":
                assert r["gate_tunnels"] == jmean(out.stats.n_tunnels)


# ------------------------------------------------------------ convert_index
@pytest.fixture(scope="module")
def sharded(shared, tmp_path_factory):
    """The shared file sharded by the port, then merged back by the port."""
    d = tmp_path_factory.mktemp("torch_cli_convert")
    paths = {"sharded": str(d / "sharded.gann"), "merged": str(d / "merged.gann")}
    rc, _ = captured(convert.main, ["shard", "--index", shared.path, "--out", paths["sharded"],
                                    "--shards", "4"])
    assert rc == 0
    rc, _ = captured(convert.main, ["merge", "--index", paths["sharded"], "--out",
                                    paths["merged"]])
    assert rc == 0
    return paths


@pytest.mark.parametrize("which", ["shared", "sharded", "merged"])
def test_convert_inspect_prints_the_reference_text(shared, sharded, which):
    path = shared.path if which == "shared" else sharded[which]
    rc, text = captured(convert.main, ["inspect", "--index", path])
    assert rc == 0
    assert text == jread_header(path).describe() + "\n"
    assert ("record segments: 4 shards" in text) == (which == "sharded")


def test_convert_port_shard_and_merge_load_in_the_reference(shared, sharded):
    cfg = JConfig(mode="gate", search_l=48, beam_width=4)
    want = shared.jeng.search(shared.queries, filter_kind="label", filter_params=shared.target,
                              search_config=cfg)
    for name, path in sharded.items():
        for tier in ("memory", "disk"):
            eng = JEngine.load(path, store_tier=tier)
            got = eng.search(shared.queries, filter_kind="label", filter_params=shared.target,
                             search_config=cfg)
            np.testing.assert_array_equal(np.asarray(got.ids), np.asarray(want.ids), err_msg=name)
            np.testing.assert_array_equal(np.asarray(got.dists), np.asarray(want.dists))
            for f in want.stats._fields:
                np.testing.assert_array_equal(np.asarray(getattr(got.stats, f)),
                                              np.asarray(getattr(want.stats, f)))
            if tier == "disk":
                eng.record_store.close()


def test_convert_reference_shard_passes_port_verify(shared, tmp_path):
    ref = load_entry("scripts/convert_index.py")
    out = str(tmp_path / "ref_sharded.gann")
    with contextlib.redirect_stdout(io.StringIO()):
        assert ref.cmd_shard(argparse.Namespace(index=shared.path, out=out, shards=4)) == 0
    for path in (shared.path, out):
        rc, text = captured(convert.main, ["verify", "--index", path, "--device", "cpu"])
        assert rc == 0, text
        assert text.count("ids_match=True") == 2 and text.count("reconciled=True") == 2
        assert text.rstrip().endswith("verify: OK")


def test_convert_build_writes_what_the_reference_loads(tmp_path):
    corpus = make_bigann_like(300, 8, seed=0)
    labels = uniform_labels(300, 10, seed=0)
    np.save(tmp_path / "corpus.npy", corpus)
    np.save(tmp_path / "labels.npy", labels)
    out = str(tmp_path / "built.gann")
    rc, text = captured(convert.main, [
        "build", "--corpus", str(tmp_path / "corpus.npy"), "--labels", str(tmp_path / "labels.npy"),
        "--out", out, "--degree", "8", "--build-l", "16", "--pq-chunks", "4", "--device", "cpu"])
    assert rc == 0 and text == jread_header(out).describe() + "\n"
    h = jread_header(out)
    assert (h.n, h.dim, h.degree) == (300, 8, 8) and h.config["pq_chunks"] == 4
    eng = JEngine.load(out)
    np.testing.assert_array_equal(np.asarray(eng.filters["label"].labels), labels)


def test_convert_verify_fails_on_a_truncated_file(shared, tmp_path):
    bad = str(tmp_path / "truncated.gann")
    shutil.copyfile(shared.path, bad)
    with open(bad, "r+b") as f:
        f.truncate(os.path.getsize(bad) - 8192)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    rcs = []
    for script, extra in (("scripts/torch_convert_index.py", ["--device", "cpu"]),
                          ("scripts/convert_index.py", [])):
        out = subprocess.run([sys.executable, os.path.join(REPO, script), "verify", "--index", bad,
                              *extra], capture_output=True, text=True, cwd=REPO, env=env,
                             timeout=120)
        assert "verify: OK" not in out.stdout, script
        rcs.append(out.returncode)
    assert rcs[0] != 0 and rcs[1] != 0


# --------------------------------------------------------------- obs_report
@pytest.fixture(scope="module")
def snapshot(shared, tmp_path_factory):
    """An artifact written after one disk-tier gate search with telemetry
    on (the registry and the span tracer), and the live registry."""
    path = str(tmp_path_factory.mktemp("torch_cli_obs") / "obs.json")
    reg = obs.MetricsRegistry(enabled=True)
    tracer = obs.trace.default_tracer()
    with obs.use_registry(reg):
        eng = GateANNEngine.load(shared.path, store_tier="disk", device="cpu")
        tracer.enable()
        try:
            out = eng.search(shared.queries, filter_kind="label", filter_params=shared.target,
                             search_config=qs.search_config("gate"))
            out.ids.cpu()
            obs.export.write_obs_json(path, sections={"serve": (reg, None)})
        finally:
            tracer.disable()
            tracer.reset()
        eng.measured_store().close()
    return path, reg


def reference_report(args: list) -> str:
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts/obs_report.py"), *args],
                         capture_output=True, text=True, cwd=REPO, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("extra", [[], ["--section", "process"], ["--prom"]],
                         ids=["report", "section", "prom"])
def test_obs_report_prints_the_reference_text(snapshot, extra):
    path, reg = snapshot
    _, text = captured(obs_report.main, [path, *extra])
    assert text == reference_report([path, *extra])
    if extra == ["--prom"]:
        assert text == 2 * obs.export.to_prometheus(reg)
    else:
        assert "disk.records_read" in text and "engine.search" in text


# ----------------------------------------------------------------- rag_serve
def test_rag_serve_equals_reference(shared):
    cfg = rag.model_config()
    jcfg = dataclasses.replace(jsmoke("gemma3-4b"), dtype="float32")
    tree = jax.tree.map(np.asarray, tfm.init_model(jax.random.PRNGKey(0), jcfg)[0])
    model = params_from_reference(tree, cfg, device="cpu")
    rng = np.random.default_rng(0)
    passages = rng.integers(0, cfg.vocab_size, size=(N, rag.PASSAGE)).astype(np.int32)
    requests = rag.make_requests(shared.corpus, cfg.vocab_size, rng)
    cache = dict(cache_budget_bytes=rag.CONFIG.cache_budget_bytes, cache_policy="adaptive",
                 refresh_every=1)
    got = rag.serve(GateANNEngine.load(shared.path, device="cpu", **cache), cfg, model, passages,
                    requests)

    jsrv = JRAGServer(engine=JEngine.load(shared.path, **cache), cfg=jcfg, params=tree,
                      layout=NULL_LAYOUT, passage_tokens=passages,
                      search_config=JConfig(mode="gate", search_l=48, result_k=3, beam_width=4))
    jreqs = [JRequest(**dataclasses.asdict(r)) for r in requests]
    tokens, stats = jsrv.generate(jreqs, max_new_tokens=8)
    assert got["tokens"].shape == (rag.N_REQUESTS, 8)
    np.testing.assert_array_equal(got["tokens"], tokens)
    for f in stats._fields:
        np.testing.assert_array_equal(getattr(got["stats"], f).numpy(), np.asarray(getattr(stats, f)))
    assert got["report"] == jsrv.io_report()
    ids, _ = jsrv.retrieve(jreqs)
    np.testing.assert_array_equal(got["ids"], np.asarray(ids))
    assert got["report_after"] == jsrv.io_report()
    assert got["report_after"]["cache_refreshes"] > 0
    assert all(shared.labels[i] == rag.CATEGORY for i in got["ids"].ravel() if i >= 0)


# ------------------------------------------------------------------ train_lm
# 2 layers x 64 wide; at B = 8, T = 64 its loss falls over steps 0-2 and
# 3-4 alike, so the example's closing check holds in both runs
TINY_LM = ModelConfig(name="tiny-lm", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512, act="silu",
                      dtype="float32")


def test_train_lm_resumes_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setattr(train_lm, "CFG", TINY_LM)
    args = ["--batch", "8", "--seq-len", "64", "--device", "cpu"]
    cut, whole = str(tmp_path / "cut"), str(tmp_path / "whole")
    first, _ = captured(train_lm.main, ["--steps", "3", "--ckpt", cut, *args])
    rest, text = captured(train_lm.main, ["--steps", "5", "--ckpt", cut, *args])
    assert "resumed at step 3" in text and len(first) == 3 and len(rest) == 2
    again, text = captured(train_lm.main, ["--steps", "5", "--ckpt", cut, *args])
    assert again == [] and "already trained to step 5; nothing to do" in text
    unbroken, _ = captured(train_lm.main, ["--steps", "5", "--ckpt", whole, *args])
    assert first + rest == unbroken
    # the reference's labels: one save a run, at --steps
    assert sorted(os.listdir(cut)) == ["step_0000000003", "step_0000000005"]
    assert sorted(os.listdir(whole)) == ["step_0000000005"]
    a, b = (os.path.join(d, "step_0000000005") for d in (cut, whole))
    files = sorted(f for f in os.listdir(a) if f.endswith(".npy"))
    assert files == sorted(f for f in os.listdir(b) if f.endswith(".npy")) and files
    for f in files:
        np.testing.assert_array_equal(np.load(os.path.join(a, f)), np.load(os.path.join(b, f)),
                                      err_msg=f)
    step = np.load(os.path.join(a, next(f for f in files if f.startswith("step"))))
    assert int(step) == 5


# -------------------------------------------------------------- smoke_models
@pytest.mark.parametrize("arch", [
    a if a in ("gemma-7b", "xlstm-350m") else pytest.param(a, marks=pytest.mark.slow)
    for a in ARCH_IDS])
def test_smoke_models_equals_reference(arch):
    from repro.models import zoo as jzoo
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import params_to_reference, zoo

    row = smoke_models.smoke_arch(arch, torch.device("cpu"))
    jcfg = dataclasses.replace(jsmoke(arch), dtype="float32")
    cfg = dataclasses.replace(smoke_models.get_smoke_config(arch), dtype="float32")
    tree = params_to_reference(zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    assert row["params"] == sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(tree))
    batch = {k: jnp.asarray(v) for k, v in zoo.make_concrete_batch(
        cfg, ShapeConfig("smoke", 32, 2, "train")).items()}
    jbatch = jzoo.make_concrete_batch(jcfg, ShapeConfig("smoke", 32, 2, "train"))
    for k in batch:
        np.testing.assert_array_equal(np.asarray(batch[k]), np.asarray(jbatch[k]))
    loss_fn = lambda p: tfm.lm_loss(p, jcfg, NULL_LAYOUT, batch)  # noqa: E731
    loss, grads = jax.value_and_grad(loss_fn)(tree)
    gnorm = float(jnp.sqrt(sum(jnp.sum(g.astype(jnp.float32) ** 2) for g in jax.tree.leaves(grads))))
    np.testing.assert_allclose(row["loss"], float(loss), rtol=2e-5)
    np.testing.assert_allclose(row["gnorm"], gnorm, rtol=1e-4)


def test_smoke_models_run_reports_every_arch():
    ok, text = captured(smoke_models.run, ("gemma3-4b",), torch.device("cpu"))
    assert ok[0] and len(ok[1]) == 1
    assert text.startswith("OK   gemma3-4b") and text.rstrip().endswith("ALL OK")
    ok, text = captured(smoke_models.run, ("no-such-arch",), torch.device("cpu"))
    assert ok == (False, []) and "FAIL no-such-arch" in text and text.rstrip().endswith("FAILURES")


# ----------------------------------------------------------- entry points
@pytest.mark.parametrize("mod,argv", [
    (qs, []), (demo, []), (rag, []), (train_lm, ["--steps", "1"]), (smoke_core, []),
    (diag, []), (smoke_models, []), (convert, ["verify", "--index", "IDX"]),
], ids=["quickstart", "demo", "rag_serve", "train_lm", "smoke_core", "diag_recall",
        "smoke_models", "convert_index"])
def test_entry_points_default_to_the_card(shared, tmp_path, mod, argv):
    """Without ``--device`` an entry point runs on the card: here, with no
    CUDA device, it raises rather than carry on on the CPU."""
    argv = [shared.path if a == "IDX" else a for a in argv]
    if mod is train_lm:
        argv += ["--ckpt", str(tmp_path / "ckpt")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main(argv)


# ------------------------------------------------------------ the helpers
def test_pq_memory_bytes_equals_reference():
    for n, c in ((0, 32), (1_000_000, 32), (1_500, 8)):
        assert pqm.pq_memory_bytes(n, c) == jpq.pq_memory_bytes(n, c)
    assert pqm.pq_memory_bytes(10) == jpq.pq_memory_bytes(10)


@pytest.mark.parametrize("n", [1_000, 70_000])
def test_train_pq_numpy_samples_the_reference_rows(monkeypatch, n):
    """Past 65,536 rows both train on the same rows (the reference's
    ``default_rng(seed).choice``); below it, on every row."""
    x = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32)
    seen = {}
    monkeypatch.setattr(jpq, "train_pq", lambda sample, **kw: seen.setdefault(
        "ref", (np.asarray(sample), kw["n_chunks"], kw["n_centroids"], kw["iters"])))
    monkeypatch.setattr(pqm, "train_pq", lambda sample, **kw: seen.setdefault(
        "port", (sample.numpy(), kw["n_chunks"], kw["n_centroids"], kw["iters"],
                 kw["generator"].initial_seed())))
    jpq.train_pq_numpy(x, n_chunks=2, n_centroids=4, iters=3, seed=7)
    pqm.train_pq_numpy(x, n_chunks=2, n_centroids=4, iters=3, seed=7, device="cpu")
    np.testing.assert_array_equal(seen["port"][0], seen["ref"][0])
    assert seen["port"][1:4] == seen["ref"][1:] == (2, 4, 3) and seen["port"][4] == 7
    # the sample is the reference's: every row, or the rows its draw picks
    idx = np.random.default_rng(7).choice(n, 65_536, replace=False) if n > 65_536 else slice(None)
    np.testing.assert_array_equal(seen["port"][0], x[idx])


def test_train_pq_numpy_trains_the_port_codebooks():
    x = np.random.default_rng(1).normal(size=(400, 8)).astype(np.float32)
    got = pqm.train_pq_numpy(x, n_chunks=2, n_centroids=8, iters=2, seed=3, device="cpu")
    want = pqm.train_pq(torch.from_numpy(x), n_chunks=2, n_centroids=8, iters=2,
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(got.books, want.books) and (got.n_chunks, got.n_centroids) == (2, 8)


def test_pack_query_tags_is_pack_tags():
    assert pack_query_tags is pack_tags
    tags = [[0, 33], [511], []]
    np.testing.assert_array_equal(pack_query_tags(tags, VOCAB), jpack_query_tags(tags, VOCAB))
