"""The port's ``GateANNEngine.build`` and ``save`` against the reference.

On the tiny fixture's float corpus the two builds cannot match bit for
bit (``train_pq``'s random draws come from ``torch.Generator`` in the
port and ``jax.random`` in the reference), so they are held to the
reference's own bar for a rebuilt index:

  * a port-built index file loads in the reference, and the reference's
    in the port, and each searches bit-identically to the engine that
    saved it (in its own package) and to the other package on the same
    file;
  * ``encode_pq`` on given codebooks is exact (``test_torch_substrate.py``);
  * recall@10 of the two builds, searched by the same package at the same
    settings, within 0.02.

The build runs on every tier with label, range and tags filters; ``save``
over a cache tier writes the backing adjacency; an adaptive cache's
learned counters survive save/load through ``export_state`` /
``restore_state``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EngineConfig as JEngineConfig  # noqa: E402
from repro.core import GateANNEngine as JEngine  # noqa: E402
from repro.core import SearchConfig as JConfig  # noqa: E402
from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig, recall_at_k  # noqa: E402
from repro_torch.core.filter_store import pack_tags  # noqa: E402
from repro_torch.data import filtered_ground_truth, multilabel_tags  # noqa: E402
from repro_torch.store import CachedRecordStore, DiskRecordStore, InMemoryRecordStore  # noqa: E402
from repro_torch.store import HostOffloadRecordStore  # noqa: E402

RECORD = 4096
TINY = dict(degree=20, build_l=40, pq_chunks=8, r_max=10)  # the tiny fixture's config
VOCAB = 40  # tags a node may carry


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test workers on the machine's cores: one
    torch thread a worker keeps them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(corpus):
    n = corpus.shape[0]
    return dict(attributes=np.linalg.norm(corpus, axis=1).astype(np.float32),
                tag_bits=pack_tags(multilabel_tags(n, VOCAB, 3.0, seed=0), VOCAB))


def _same(a, b, ctx=""):
    assert torch.equal(a.ids, b.ids), ctx
    assert torch.equal(a.dists, b.dists), ctx
    for x, y, f in zip(a.stats, b.stats, a.stats._fields):
        assert torch.equal(x, y), f"{ctx}: stats.{f}"


def _queries_kw(corpus, queries, kind):
    b = queries.shape[0]
    if kind == "label":
        return dict(filter_kind="label", filter_params=np.arange(b, dtype=np.int32) % 10)
    if kind == "range":
        norms = np.linalg.norm(corpus, axis=1)
        return dict(filter_kind="range", filter_params=(
            np.full(b, np.quantile(norms, 0.3), np.float32),
            np.full(b, np.quantile(norms, 0.7), np.float32)))
    # one of the three most common tags a query
    return dict(filter_kind="tags", filter_params=pack_tags([[q % 3] for q in range(b)], VOCAB))


@pytest.fixture(scope="module")
def port_built(tiny_corpus):
    corpus, labels, _ = tiny_corpus
    timings = {}
    eng = GateANNEngine.build(corpus, config=EngineConfig(**TINY), labels=labels,
                              device="cpu", timings=timings, **_meta(corpus))
    return eng, timings


@pytest.fixture(scope="module")
def port_file(port_built, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_build") / "port.gann")
    port_built[0].save(path)
    return path


@pytest.fixture(scope="module")
def ref_file(tiny_engine, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_build") / "ref.gann")
    tiny_engine.save(path)
    return path


def test_build_reports_its_parts(port_built, tiny_corpus):
    eng, timings = port_built
    corpus, _, _ = tiny_corpus
    assert set(timings) == {"beam_search", "prune", "reverse_edges", "pq"}
    assert isinstance(eng.record_store, InMemoryRecordStore)
    assert tuple(eng.record_store.neighbors.shape) == (corpus.shape[0], TINY["degree"])
    assert set(eng.filters) == {"label", "range", "tags"}
    assert eng.codec.n_chunks == TINY["pq_chunks"]
    assert eng.config == EngineConfig(**TINY)


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_build_on_every_tier(port_built, tiny_corpus, tmp_path, tier):
    """The same build on the host and disk tiers (the disk tier writes its
    file first and serves off it) searches as the memory tier does, with
    every filter kind."""
    corpus, labels, queries = tiny_corpus
    mem = port_built[0]
    path = str(tmp_path / "disk.gann")
    eng = GateANNEngine.build(corpus, config=EngineConfig(store_tier=tier, **TINY),
                              labels=labels, device="cpu",
                              index_path=path if tier == "disk" else None, **_meta(corpus))
    want_cls = DiskRecordStore if tier == "disk" else HostOffloadRecordStore
    assert isinstance(eng.record_store, want_cls)
    assert torch.equal(torch.as_tensor(np.array(eng.record_store.neighbors)),
                       mem.record_store.neighbors)
    for kind in ("label", "range", "tags"):
        kw = _queries_kw(corpus, queries, kind)
        for depth in (1, 3):
            cfg = SearchConfig(mode="gate", search_l=32, beam_width=4, pipeline_depth=depth)
            _same(eng.search(queries, search_config=cfg, **kw),
                  mem.search(queries, search_config=cfg, **kw), (tier, kind, depth))
    if tier == "disk":
        assert eng.memory_report()["disk_path"] == path
        eng.measured_store().close()


def test_disk_build_needs_an_index_path(tiny_corpus):
    corpus, _, _ = tiny_corpus
    with pytest.raises(ValueError, match="index_path"):
        GateANNEngine.build(corpus[:50], config=EngineConfig(store_tier="disk", degree=4),
                            device="cpu")


def test_build_without_device_raises_without_cuda(tiny_corpus, monkeypatch):
    corpus, _, _ = tiny_corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GateANNEngine.build(corpus[:50], config=EngineConfig(degree=4))


@pytest.mark.parametrize("kind", ["label", "range", "tags"])
def test_port_saved_index_loads_in_both_packages(port_built, port_file, tiny_corpus, kind):
    """A port-built index: the port's load searches as the saving engine,
    and the reference's load of the same file gives the same bits."""
    corpus, _, queries = tiny_corpus
    eng = port_built[0]
    kw = _queries_kw(corpus, queries, kind)
    loaded = GateANNEngine.load(port_file, device="cpu")
    assert loaded.config == eng.config
    for fused in (False, True):
        cfg = dict(mode="gate", search_l=32, beam_width=4, use_fused_kernel=fused)
        want = eng.search(queries, search_config=SearchConfig(**cfg), **kw)
        _same(loaded.search(queries, search_config=SearchConfig(**cfg), **kw), want,
              (kind, fused))
        ref = JEngine.load(port_file).search(queries, search_config=JConfig(**cfg), **kw)
        np.testing.assert_array_equal(want.ids.numpy(), np.asarray(ref.ids))
        np.testing.assert_array_equal(want.dists.numpy(), np.asarray(ref.dists))
        for f in ref.stats._fields:
            np.testing.assert_array_equal(getattr(want.stats, f).numpy(),
                                          np.asarray(getattr(ref.stats, f)), err_msg=f)


def test_reference_saved_index_loads_in_the_port(tiny_engine, ref_file, tiny_corpus):
    """The reference's build and save: its own load searches as it does, the
    port's load gives the same bits, and the port's config equals the
    reference's field for field."""
    corpus, _, queries = tiny_corpus
    kw = _queries_kw(corpus, queries, "label")
    want = tiny_engine.search(queries, search_config=JConfig(mode="gate"), **kw)
    again = JEngine.load(ref_file).search(queries, search_config=JConfig(mode="gate"), **kw)
    np.testing.assert_array_equal(np.asarray(again.ids), np.asarray(want.ids))
    port = GateANNEngine.load(ref_file, device="cpu")
    assert dataclasses.asdict(port.config) == dataclasses.asdict(tiny_engine.config)
    got = port.search(queries, search_config=SearchConfig(mode="gate"), **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))


def test_recall_of_the_two_builds(port_file, ref_file, tiny_corpus):
    """Both builds searched by the port at the same settings: recall@10
    against exact filtered ground truth within 0.02."""
    corpus, labels, queries = tiny_corpus
    targets = np.arange(queries.shape[0], dtype=np.int32) % 10
    gt = filtered_ground_truth(corpus, queries, np.asarray(labels)[None] == targets[:, None])
    recalls = {}
    for name, path in (("port", port_file), ("reference", ref_file)):
        eng = GateANNEngine.load(path, device="cpu")
        out = eng.search(queries, filter_kind="label", filter_params=targets,
                         search_config=SearchConfig(mode="gate", search_l=64, beam_width=4))
        recalls[name] = recall_at_k(out.ids, gt, 10)
    assert abs(recalls["port"] - recalls["reference"]) <= 0.02, recalls
    assert recalls["port"] > 0.5, recalls


def test_save_over_a_cache_writes_the_backing_adjacency(port_built, tiny_corpus, tmp_path):
    """The file holds the backing store's adjacency; the cache knobs stay in
    its config, so a load (in either package) wraps the same tier again."""
    corpus, _, queries = tiny_corpus
    eng = port_built[0]
    kw = _queries_kw(corpus, queries, "label")
    for knobs in (dict(policy="visit_freq"), dict(policy="adaptive")):
        cached = eng.with_cache(64 * RECORD, **knobs)
        assert not isinstance(cached.record_store, InMemoryRecordStore)
        path = str(tmp_path / f"{knobs['policy']}.gann")
        cached.save(path)
        loaded = GateANNEngine.load(path, device="cpu")
        assert loaded.config.cache_policy == knobs["policy"]
        assert loaded.record_store.policy == knobs["policy"]
        assert torch.equal(loaded.record_store.backing.neighbors, eng.record_store.neighbors)
        plain = GateANNEngine.load(path, device="cpu", cache_budget_bytes=0)
        assert isinstance(plain.record_store, InMemoryRecordStore)
        _same(plain.search(queries, **kw), eng.search(queries, **kw), knobs["policy"])
        ref = JEngine.load(path)
        assert ref.record_store.policy == knobs["policy"]
        np.testing.assert_array_equal(np.asarray(ref.record_store.backing.neighbors),
                                      eng.record_store.neighbors.numpy())


def test_sharded_save_loads_in_the_reference(port_built, tiny_corpus, tmp_path):
    corpus, _, queries = tiny_corpus
    eng = port_built[0]
    path = str(tmp_path / "sharded.gann")
    eng.save(path, shards=2)
    kw = _queries_kw(corpus, queries, "label")
    want = eng.search(queries, **kw)
    disk = GateANNEngine.load(path, device="cpu", store_tier="disk")
    assert disk.measured_store().n_shards == 2
    _same(disk.search(queries, **kw), want, "port disk")
    ref = JEngine.load(path, store_tier="disk").search(queries, **kw)
    np.testing.assert_array_equal(want.ids.numpy(), np.asarray(ref.ids))
    disk.measured_store().close()


def test_export_restore_carries_workload_across_save_load(port_built, tiny_corpus, tmp_path):
    """export_state before save, restore_state after load: the first search
    after the restore serves the learned hot set, with identical results;
    a plain load starts from the cold-start seed."""
    _, _, queries = tiny_corpus
    eng = port_built[0]
    tgt = np.zeros(queries.shape[0], np.int32)

    def search(e):
        return e.search(queries, filter_kind="label", filter_params=tgt,
                        search_config=SearchConfig(mode="gate", search_l=64, beam_width=4))

    warm = eng.with_cache(128 * RECORD, policy="adaptive", refresh_every=0)
    for _ in range(3):
        search(warm)
    warm.record_store.refresh()
    state = warm.record_store.export_state()
    warm_hits = int(search(warm).stats.n_cache_hits.sum())
    path = str(tmp_path / "adaptive.gann")
    warm.save(path)
    loaded = GateANNEngine.load(path, device="cpu", cache_budget_bytes=128 * RECORD,
                                cache_policy="adaptive", refresh_every=0)
    store = loaded.record_store
    assert float(store.counts.sum()) == 0.0 and len(store.partitions) == 0
    np.testing.assert_array_equal(store.hot_ids(), store.seed_hot_ids)
    store.restore_state(state)
    np.testing.assert_array_equal(store.counts.numpy(), state["counts"])
    assert set(store.partitions) == {k for k, _ in state["partitions"]}
    for part in store.partitions.values():
        assert part.store is not None
    out = search(loaded)
    assert int(out.stats.n_cache_hits.sum()) == warm_hits
    assert torch.equal(out.ids, search(eng).ids)


def test_build_accepts_a_given_graph(port_built, tiny_corpus):
    """build(graph=...) skips the Vamana build and keeps that adjacency."""
    from repro_torch.core.graph import VamanaGraph

    corpus, labels, queries = tiny_corpus
    eng = port_built[0]
    again = GateANNEngine.build(
        corpus, config=EngineConfig(**TINY), labels=labels, device="cpu",
        graph=VamanaGraph(neighbors=eng.record_store.neighbors, medoid=eng.medoid))
    assert torch.equal(again.codes, eng.codes)  # train_pq seeded from config.seed
    kw = _queries_kw(corpus, queries, "label")
    _same(again.search(queries, **kw), eng.search(queries, **kw))


def test_config_fields_are_the_references():
    """Field for field, and every default the reference's but one:
    ``use_fused_kernel`` is None in the port (the device decides), which
    the reference's config takes and runs as its unfused loop."""
    assert [f.name for f in dataclasses.fields(EngineConfig)] == \
        [f.name for f in dataclasses.fields(JEngineConfig)]
    port, ref = dataclasses.asdict(EngineConfig()), dataclasses.asdict(JEngineConfig())
    assert port.pop("use_fused_kernel") is None and ref.pop("use_fused_kernel") is False
    assert port == ref
    assert not JEngineConfig(**dataclasses.asdict(EngineConfig())).use_fused_kernel


def test_cached_build_serves_the_cache(tiny_corpus):
    corpus, labels, queries = tiny_corpus
    sub = corpus[:600]
    eng = GateANNEngine.build(sub, config=EngineConfig(cache_budget_bytes=32 * RECORD, degree=8,
                                                       build_l=16, pq_chunks=8, r_max=4),
                              labels=labels[:600], device="cpu")
    assert isinstance(eng.record_store, CachedRecordStore) and eng.record_store.n_cached == 32
    out = eng.search(queries, filter_kind="label",
                     filter_params=np.zeros(queries.shape[0], np.int32))
    base = eng.with_cache(0).search(queries, filter_kind="label",
                                    filter_params=np.zeros(queries.shape[0], np.int32))
    assert torch.equal(out.ids, base.ids)
    assert torch.equal(out.stats.n_ios + out.stats.n_cache_hits, base.stats.n_ios)
