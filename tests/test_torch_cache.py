"""The port's cache tiers against the reference, on one saved index.

Exact, with no tolerance: ``record_nbytes``, ``bfs_hot_set``,
``filter_bucket``, ``_hot_from_counts`` and ``visit_freq_hot_set`` (on
integer-valued data).  Cached search: the same hot ids go into both
packages' ``CachedRecordStore.wrap`` at budgets of 0, 1, 8, 32 and all
records, and the port — memory tier, and disk tier at pipeline depths 1
and 4, unfused and fused, in all five modes — gives the reference's ids,
distances' bits and every ``SearchStats`` field (the reference's output
is the same on every tier and depth, by its own tests); ``n_ios +
n_cache_hits`` stays the uncached ``n_ios``, and on disk ``records_read
== Σ n_ios``.  The adaptive cache over 6 batches with two filter buckets
and an LRU of one: counters' bits, partitions, hot ids, ``n_refreshes``
and ``last_refresh_sets``, the LRU's evictions in the registry.  The cost
model on the same stats.  Then the
reference's ``test_cache.py`` and ``test_adaptive_cache.py`` on the port
(the serving-loop case waits for the serving port; the save/load case is
in ``test_torch_build.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SearchConfig as JConfig  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.store import CachedRecordStore as JCache  # noqa: E402
from repro.store import adaptive as jadaptive  # noqa: E402
from repro.store import cache as jcache  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core import pq as tpqm  # noqa: E402
from repro_torch.kernels import l2_dist as tl2  # noqa: E402
from repro_torch.kernels import pq_lookup as tpq  # noqa: E402
from repro_torch.store import AdaptiveRecordCache, CachedRecordStore, filter_bucket  # noqa: E402
from repro_torch.store import adaptive as tadaptive  # noqa: E402
from repro_torch.store import cache as tcache  # noqa: E402

MODES = ("gate", "post", "early", "pre_naive", "unfiltered")
RECORD = 4096  # tiny-corpus records round up to one 4 KB sector
SEARCH = dict(search_l=32, beam_width=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test workers on the machine's cores: one
    torch thread a worker keeps them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index_path(tiny_engine, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_cache") / "tiny.gann")
    tiny_engine.save(path)
    return path


@pytest.fixture(scope="module")
def port(index_path):
    return GateANNEngine.load(index_path, device="cpu")


@pytest.fixture(scope="module")
def port_disk(index_path):
    eng = GateANNEngine.load(index_path, device="cpu", store_tier="disk", max_gap_sectors=0)
    yield eng
    eng.measured_store().close()


@pytest.fixture(scope="module")
def hot_order(tiny_engine):
    """Every node, hottest first: the reference's visit_freq order."""
    n = int(tiny_engine.vectors.shape[0])
    return jcache.select_hot_set(neighbors=tiny_engine.record_store.neighbors,
                                 medoid=int(tiny_engine.medoid), budget_bytes=n * RECORD,
                                 vectors=tiny_engine.vectors)


def _args(mode, queries):
    if mode == "unfiltered":
        return {}
    return dict(filter_kind="label", filter_params=np.arange(queries.shape[0], dtype=np.int32) % 10)


def _same(got, want, ctx):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids), err_msg=str(ctx))
    np.testing.assert_array_equal(got.dists.numpy().view(np.int32),
                                  np.asarray(want.dists).view(np.int32), err_msg=str(ctx))
    for f in want.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, f).numpy(),
                                      np.asarray(getattr(want.stats, f)),
                                      err_msg=f"{ctx}: stats.{f}")


def _port_cached(eng, hot):
    store = eng.record_store
    wrapped = CachedRecordStore.wrap(store, vectors=eng.vectors, neighbors=store.neighbors,
                                     hot_ids=hot, device="cpu")
    return dataclasses.replace(eng, record_store=wrapped)


# ------------------------------------------------------------------ exact pieces
def test_record_nbytes_matches():
    for dim in (8, 24, 96, 128, 960, 1024):
        for degree in (8, 20, 64, 128):
            assert tcache.record_nbytes(dim, degree) == jcache.record_nbytes(dim, degree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bfs_hot_set_matches(seed):
    rng = np.random.default_rng(seed)
    n = 300
    nbrs = rng.integers(-1, n, (n, 6)).astype(np.int32)
    for medoid, slots in ((0, 1), (5, 40), (17, n), (3, 2 * n), (9, 0)):
        np.testing.assert_array_equal(tcache.bfs_hot_set(nbrs, medoid, slots),
                                      jcache.bfs_hot_set(nbrs, medoid, slots))
        np.testing.assert_array_equal(
            tcache.bfs_hot_set(torch.from_numpy(nbrs), medoid, slots),
            jcache.bfs_hot_set(nbrs, medoid, slots))


def test_filter_bucket_matches():
    lo, hi = np.asarray([0.5, 0.52], np.float32), np.asarray([1.5, 1.49], np.float32)
    cases = [(None, None), ("label", np.asarray([3, 3, 1])), ("label", np.int32(4)),
             ("range", (lo, hi)), ("range", np.stack([lo, hi])), ("range", (0.25, 0.75)),
             ("tags", np.asarray([[3, 0], [1, 1]], np.uint32)),
             ("tags", np.asarray([7, 2**31], np.uint32))]
    for kind, params in cases:
        assert filter_bucket(kind, params) == jadaptive.filter_bucket(kind, params), kind
    # tensors give the host arrays' keys
    assert filter_bucket("label", torch.tensor([3, 3, 1])) == ("label", 3)
    assert filter_bucket("range", (torch.from_numpy(lo), torch.from_numpy(hi))) == \
        jadaptive.filter_bucket("range", (lo, hi))


def test_hot_from_counts_matches(tiny_engine, port):
    """Counters with ties, zeros and more live ids than slots, and fewer."""
    j = tiny_engine.with_cache(64 * RECORD, policy="adaptive").record_store
    t = port.with_cache(64 * RECORD, policy="adaptive").record_store
    np.testing.assert_array_equal(t.seed_hot_ids, j.seed_hot_ids)
    rng = np.random.default_rng(0)
    n = int(t.counts.shape[0])
    for live in (5, 64, 700):
        c = np.zeros(n, np.float32)
        c[rng.choice(n, live, replace=False)] = rng.integers(1, 6, live).astype(np.float32)
        np.testing.assert_array_equal(t._hot_from_counts(torch.from_numpy(c)),
                                      j._hot_from_counts(c), err_msg=str(live))


def test_visit_freq_hot_set_matches_on_integer_data():
    x = np.random.default_rng(8).integers(-8, 9, (400, 16)).astype(np.float32)
    g = jg.build_vamana(x, degree=10, build_l=20, batch_size=128, seed=0)
    nbrs = np.array(g.neighbors)
    # 2 samples expand fewer nodes than 300 slots: the BFS padding path
    for slots, seed, samples in ((16, 0, 32), (120, 3, 32), (400, 1, 32), (300, 2, 2)):
        want = jcache.visit_freq_hot_set(x, nbrs, int(g.medoid), slots, n_samples=samples,
                                         seed=seed)
        got = tcache.visit_freq_hot_set(torch.from_numpy(x), nbrs, int(g.medoid), slots,
                                        n_samples=samples, seed=seed)
        np.testing.assert_array_equal(got, want, err_msg=str((slots, seed)))


def test_select_hot_set_on_a_lazy_view_takes_bfs(port_disk, tiny_engine):
    """The disk tier's vectors are a lazy host view: visit_freq falls back
    to BFS order, as in the reference."""
    store = port_disk.measured_store()
    got = tcache.select_hot_set(neighbors=store.neighbors, medoid=port_disk.medoid,
                                budget_bytes=50 * RECORD, vectors=store.vectors)
    want = jcache.bfs_hot_set(np.asarray(tiny_engine.record_store.neighbors),
                              int(tiny_engine.medoid), 50)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------- cached search
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", MODES)
def test_cached_search_matches_reference(tiny_engine, tiny_corpus, port, port_disk, hot_order,
                                         mode, fused):
    _, _, queries = tiny_corpus
    n = int(tiny_engine.vectors.shape[0])
    jback = tiny_engine.record_store
    kw = _args(mode, queries)
    disk = port_disk.measured_store()
    base_ios = None
    for budget in (0, 1, 8, 32, n):
        hot = hot_order[:budget]
        # one block shape at every budget: the reference compiles once
        jstore = JCache.wrap(jback, vectors=tiny_engine.vectors, neighbors=jback.neighbors,
                             hot_ids=hot, n_slots=n)
        want = dataclasses.replace(tiny_engine, record_store=jstore).search(
            queries, search_config=JConfig(mode=mode, use_fused_kernel=fused, **SEARCH), **kw)
        if base_ios is None:
            base_ios = np.asarray(want.stats.n_ios)
        np.testing.assert_array_equal(
            np.asarray(want.stats.n_ios) + np.asarray(want.stats.n_cache_hits), base_ios)
        runs = {"memory": (_port_cached(port, hot), 1)}
        for depth in (1, 4):
            runs[f"disk_d{depth}"] = (_port_cached(port_disk, hot), depth)
        for tier, (eng, depth) in runs.items():
            ctx = (mode, fused, budget, tier)
            disk.reset_io_counters()
            got = eng.search(queries, search_config=SearchConfig(
                mode=mode, use_fused_kernel=fused, pipeline_depth=depth, **SEARCH), **kw)
            _same(got, want, ctx)
            if tier != "memory":
                io = disk.io_counters()
                assert io["records_read"] == int(got.stats.n_ios.sum()), ctx
                assert io["abandoned_tokens"] == 0, ctx
    assert int(got.stats.n_ios.sum()) == 0  # every record cached


def test_cached_store_keeps_the_async_pair_of_its_backing(port, port_disk, hot_order):
    mem = _port_cached(port, hot_order[:8]).record_store
    disk = _port_cached(port_disk, hot_order[:8]).record_store
    assert mem.submit is None and mem.drain is None
    assert disk.submit is not None and disk.drain is not None
    ids = torch.tensor([[int(hot_order[0]), 5, -1, int(hot_order[3])]], dtype=torch.int32)
    token, nbrs = disk.submit(ids)
    vecs = disk.drain(token, ids, True)
    want_v, want_n = disk.fetch(ids)
    assert torch.equal(vecs, want_v) and torch.equal(nbrs, want_n)
    assert port_disk.measured_store().io_counters()["abandoned_tokens"] == 0


# -------------------------------------------------------------- the adaptive cache
@pytest.mark.parametrize("refresh_every", [1, 2])
def test_adaptive_matches_reference(tiny_engine, tiny_corpus, port, refresh_every):
    """Six batches alternating two filter buckets through an LRU of one
    partition: the EMA counters bit for bit after every batch, the
    partitions and their counters, the hot ids, the refresh counts."""
    _, _, queries = tiny_corpus
    knobs = dict(policy="adaptive", refresh_every=refresh_every, cache_partitions=1)
    j = tiny_engine.with_cache(64 * RECORD, **knobs)
    t = port.with_cache(64 * RECORD, **knobs)
    js, ts = j.record_store, t.record_store
    assert isinstance(ts, AdaptiveRecordCache)
    np.testing.assert_array_equal(ts.seed_hot_ids, js.seed_hot_ids)
    reg = obs.MetricsRegistry(enabled=True)
    for batch in range(6):
        target = np.full(queries.shape[0], batch % 2, np.int32)
        cfg = dict(mode="gate", **SEARCH)
        want = j.search(queries, filter_kind="label", filter_params=target,
                        search_config=JConfig(**cfg))
        with obs.use_registry(reg):
            got = t.search(queries, filter_kind="label", filter_params=target,
                           search_config=SearchConfig(**cfg))
        ctx = f"batch {batch}"
        _same(got, want, ctx)
        np.testing.assert_array_equal(got.visit_counts.numpy(), np.asarray(want.visit_counts))
        np.testing.assert_array_equal(ts.counts.numpy().view(np.int32),
                                      np.asarray(js.counts).view(np.int32), err_msg=ctx)
        assert list(ts.partitions) == list(js.partitions), ctx
        for key in js.partitions:
            np.testing.assert_array_equal(
                ts.partitions[key].counts.numpy().view(np.int32),
                np.asarray(js.partitions[key].counts).view(np.int32), err_msg=ctx)
        assert (ts.n_refreshes, ts.last_refresh_sets, ts.batches_since_refresh) == \
            (js.n_refreshes, js.last_refresh_sets, js.batches_since_refresh), ctx
        np.testing.assert_array_equal(ts.hot_ids(), js.hot_ids(), err_msg=ctx)
        bucket = filter_bucket("label", target)
        np.testing.assert_array_equal(ts.store_for(bucket).hot_ids(),
                                      js.store_for(bucket).hot_ids(), err_msg=ctx)
    assert ts.n_refreshes == js.n_refreshes > 0
    # the LRU of one dropped every other bucket
    assert reg.family_total("cache.partition_evictions") == 5


def test_modeled_cost_matches_reference(tiny_engine, tiny_corpus, port):
    _, _, queries = tiny_corpus
    target = np.zeros(queries.shape[0], np.int32)
    for budget, knobs in ((0, {}), (128 * RECORD, {}),
                          (128 * RECORD, dict(policy="adaptive", refresh_every=2))):
        j = tiny_engine.with_cache(budget, **knobs)
        t = port.with_cache(budget, **knobs)
        cfg = dict(mode="gate", **SEARCH)
        want = j.search(queries, filter_kind="label", filter_params=target,
                        search_config=JConfig(**cfg)).stats
        got = t.search(queries, filter_kind="label", filter_params=target,
                       search_config=SearchConfig(**cfg)).stats
        assert t.modeled_qps(got) == j.modeled_qps(want)
        assert t.modeled_qps(got, n_threads=4) == j.modeled_qps(want, n_threads=4)
        for kw in ({}, dict(pipeline_depth=1), dict(overlap_depth=4)):
            assert t.modeled_latency_us(got, **kw) == j.modeled_latency_us(want, **kw)


# ------------------------------------ the reference's test_cache.py, on the port
def _search(engine, queries, mode="gate", target=0):
    tgt = np.full(queries.shape[0], target, np.int32)
    return engine.search(queries, filter_kind="label", filter_params=tgt,
                         search_config=SearchConfig(mode=mode, search_l=64, beam_width=4))


@pytest.fixture(scope="module")
def cache_runs(port, tiny_corpus):
    _, _, queries = tiny_corpus
    budgets = (0, 32 * RECORD, 128 * RECORD, 512 * RECORD)
    return {bud: _search(port.with_cache(bud), queries) for bud in budgets}


def test_cached_results_identical(cache_runs):
    base = cache_runs[0]
    for bud, out in cache_runs.items():
        assert torch.equal(out.ids, base.ids), bud
        assert torch.equal(out.dists, base.dists), bud


def test_io_conservation(cache_runs):
    """Every cache hit is exactly one slow-tier read saved."""
    base_ios = cache_runs[0].stats.n_ios
    assert int(cache_runs[0].stats.n_cache_hits.abs().sum()) == 0
    for bud, out in cache_runs.items():
        assert torch.equal(out.stats.n_ios + out.stats.n_cache_hits, base_ios), bud


def test_hits_monotone_in_cache_size(cache_runs):
    budgets = sorted(cache_runs)
    total_hits = [int(cache_runs[b].stats.n_cache_hits.sum()) for b in budgets]
    assert total_hits == sorted(total_hits), dict(zip(budgets, total_hits))
    assert total_hits[-1] > 0


def test_tunnels_and_recall_untouched(cache_runs):
    base = cache_runs[0].stats.n_tunnels
    for out in cache_runs.values():
        assert torch.equal(out.stats.n_tunnels, base)


@pytest.mark.parametrize("policy", ["visit_freq", "bfs"])
def test_policies_cache_the_medoid(port, policy):
    eng = port.with_cache(16 * RECORD, policy=policy)
    store = eng.record_store
    assert isinstance(store, CachedRecordStore)
    assert store.n_cached == 16
    assert eng.medoid in set(store.hot_ids().tolist())


def test_cache_serves_correct_records(port):
    store = port.with_cache(128 * RECORD).record_store
    ids = torch.from_numpy(np.r_[store.hot_ids()[:4], [0, 1, -1, 1999]][None].astype(np.int32))
    vecs_c, nbrs_c = store.fetch(ids)
    vecs_b, nbrs_b = store.backing.fetch(ids)
    assert torch.equal(vecs_c, vecs_b) and torch.equal(nbrs_c, nbrs_b)


def test_cached_mask_matches_hot_set(port):
    store = port.with_cache(128 * RECORD).record_store
    hot = set(store.hot_ids().tolist())
    probe = np.r_[store.hot_ids()[:3], [5, 7, -1]].astype(np.int32)
    got = store.cached_mask(torch.from_numpy(probe[None]))[0]
    assert got.tolist() == [int(i) in hot and i >= 0 for i in probe]


def test_bfs_hot_set_order_and_bounds():
    nbrs = np.asarray([[1, 2], [3, -1], [3, 4], [-1, -1], [0, -1]], np.int32)
    assert tcache.bfs_hot_set(nbrs, 0, 3).tolist() == [0, 1, 2]
    assert tcache.bfs_hot_set(nbrs, 0, 99).tolist() == [0, 1, 2, 3, 4]
    assert tcache.bfs_hot_set(nbrs, 0, 0).tolist() == []


def test_sub_record_budget_leaves_tier_off(port, tiny_corpus):
    _, _, queries = tiny_corpus
    eng = port.with_cache(100)
    assert not isinstance(eng.record_store, CachedRecordStore)
    assert int(_search(eng, queries[:4]).stats.n_cache_hits.sum()) == 0


def test_empty_wrap_is_safe(port):
    backing = port.record_store
    store = CachedRecordStore.wrap(backing, vectors=port.vectors, neighbors=backing.neighbors,
                                   hot_ids=np.zeros((0,), np.int32), device="cpu")
    assert store.n_cached == 0 and store.cache_bytes() == 0
    ids = torch.tensor([[0, 5, -1]], dtype=torch.int32)
    vecs_c, nbrs_c = store.fetch(ids)
    vecs_b, nbrs_b = backing.fetch(ids)
    assert torch.equal(vecs_c, vecs_b) and torch.equal(nbrs_c, nbrs_b)


def test_select_hot_set_respects_budget(port):
    nbrs = port.record_store.neighbors
    per = tcache.record_nbytes(port.vectors.shape[1], nbrs.shape[1])
    hot = tcache.select_hot_set(neighbors=nbrs, medoid=port.medoid,
                                budget_bytes=10 * per + per // 2, policy="bfs")
    assert hot.size == 10
    with pytest.raises(ValueError, match="cache policy"):
        tcache.select_hot_set(neighbors=nbrs, medoid=port.medoid, budget_bytes=per,
                              policy="lru")


def test_memory_report_has_cache_lines(port, tiny_engine):
    got = port.with_cache(64 * RECORD).memory_report()
    want = tiny_engine.with_cache(64 * RECORD).memory_report()
    assert got["cache_nodes"] == 64 and got["cache_bytes"] == 64 * RECORD
    assert got["cache_policy"] == "visit_freq"
    assert 0 < got["cache_device_bytes"] < got["cache_bytes"]
    for key in ("cache_nodes", "cache_bytes", "cache_device_bytes", "cache_policy",
                "record_tier", "record_tier_bytes"):
        assert got[key] == want[key], key
    assert "cache_nodes" not in port.memory_report()


def test_modeled_qps_improves_with_cache(port, tiny_corpus):
    _, _, queries = tiny_corpus
    out0 = _search(port, queries)
    out1 = _search(port.with_cache(512 * RECORD), queries)
    assert port.modeled_qps(out1.stats) > port.modeled_qps(out0.stats)
    assert port.modeled_latency_us(out1.stats, pipeline_depth=1) < \
        port.modeled_latency_us(out0.stats, pipeline_depth=1)


CONSERVATION_GRID = [
    # (policy, budget_records, refresh_every, mode, n_batches)
    ("visit_freq", 32, 0, "gate", 1),
    ("visit_freq", 512, 0, "post", 1),
    ("bfs", 128, 0, "gate", 1),
    ("adaptive", 32, 1, "gate", 3),
    ("adaptive", 128, 2, "gate", 3),
    ("adaptive", 128, 1, "post", 2),
    ("adaptive", 512, 4, "unfiltered", 2),
]


@pytest.mark.parametrize("policy,nrec,refresh_every,mode,n_batches", CONSERVATION_GRID)
def test_io_conservation_every_policy(port, tiny_corpus, policy, nrec, refresh_every, mode,
                                      n_batches):
    _, _, queries = tiny_corpus

    def run(eng):
        if mode == "unfiltered":
            return eng.search(queries, search_config=SearchConfig(mode=mode, search_l=64,
                                                                  beam_width=4))
        return _search(eng, queries, mode=mode)

    base = run(port)
    eng = port.with_cache(nrec * RECORD, policy=policy, refresh_every=refresh_every)
    for batch in range(n_batches):
        out = run(eng)
        msg = f"policy={policy} nrec={nrec} batch={batch}"
        assert torch.equal(out.ids, base.ids), msg
        assert torch.equal(out.dists, base.dists), msg
        assert torch.equal(out.stats.n_ios + out.stats.n_cache_hits, base.stats.n_ios), msg
        assert torch.equal(out.stats.n_tunnels, base.stats.n_tunnels), msg


def test_cached_gate_matches_oracle(port, tiny_corpus):
    """The cached engine against the reference's NumPy oracle with the same
    hot set, the n_ios / n_cache_hits split included."""
    from tests.test_search_oracle import oracle_search

    corpus, labels, queries = tiny_corpus
    queries = queries[:4]
    eng = port.with_cache(128 * RECORD)
    out = _search(eng, queries)
    n, b = corpus.shape[0], queries.shape[0]
    q = torch.from_numpy(queries)
    lut = tpqm.build_lut(eng.codec, q)
    all_ids = torch.arange(n, dtype=torch.int32).expand(b, n).contiguous()
    pq_d = tpq.adc_ids(lut, eng.codes, all_ids).numpy()
    exact_d = tl2.l2_tree_ref(q, eng.vectors[None].expand(b, n, -1)).numpy()
    ora = oracle_search(
        pq_dist=pq_d, exact_dist=exact_d, passes=np.asarray(labels) == 0,
        full_nbrs=eng.record_store.neighbors.numpy(),
        mem_nbrs=eng.neighbor_store.neighbors.numpy(),
        entry=eng.medoid, mode="gate", L=64, W=4, K=10,
        cached=eng.record_store.slot_of.numpy() >= 0,
    )
    np.testing.assert_array_equal(out.ids.numpy(), ora.ids)
    np.testing.assert_array_equal(out.stats.n_ios.numpy(), ora.n_ios)
    np.testing.assert_array_equal(out.stats.n_cache_hits.numpy(), ora.n_cache_hits)


# ---------------------------- the reference's test_adaptive_cache.py, on the port
@pytest.fixture()
def adaptive_engine(port):
    """Fresh adaptive engine per test — the cache is stateful."""
    return port.with_cache(128 * RECORD, policy="adaptive", refresh_every=2)


def test_visit_counts_conserve_fetches(adaptive_engine, tiny_corpus):
    _, labels, queries = tiny_corpus
    out = _search(adaptive_engine, queries)
    counts = adaptive_engine.record_store.counts.numpy()
    assert int(counts.sum()) == int((out.stats.n_ios + out.stats.n_cache_hits).sum())
    assert (np.asarray(labels)[counts > 0] == 0).all()


def test_adaptive_ids_identical_across_batches(adaptive_engine, port, tiny_corpus):
    _, _, queries = tiny_corpus
    base = _search(port, queries)
    for batch in range(5):
        out = _search(adaptive_engine, queries)
        assert torch.equal(out.ids, base.ids) and torch.equal(out.dists, base.dists), batch
        assert torch.equal(out.stats.n_ios + out.stats.n_cache_hits, base.stats.n_ios), batch
    assert adaptive_engine.record_store.n_refreshes == 2


def test_adaptation_beats_static_on_repeated_workload(port, tiny_corpus):
    _, _, queries = tiny_corpus
    static = port.with_cache(128 * RECORD, policy="visit_freq")
    adapt = port.with_cache(128 * RECORD, policy="adaptive")
    adapt.warm(queries, filter_kind="label", filter_params=np.zeros(queries.shape[0], np.int32),
               search_config=SearchConfig(mode="gate", search_l=64, beam_width=4))
    out_s, out_a = _search(static, queries), _search(adapt, queries)
    assert int(out_a.stats.n_cache_hits.sum()) > int(out_s.stats.n_cache_hits.sum())
    assert torch.equal(out_a.ids, out_s.ids)


def test_refresh_keeps_shapes_stable(adaptive_engine, tiny_corpus):
    _, _, queries = tiny_corpus
    store = adaptive_engine.record_store
    shape0 = tuple(store.global_store.cache_vectors.shape)
    slot0 = tuple(store.global_store.slot_of.shape)
    for _ in range(3):
        _search(adaptive_engine, queries)
        store.refresh()
        assert tuple(store.global_store.cache_vectors.shape) == shape0
        assert tuple(store.global_store.slot_of.shape) == slot0
        for part in store.partitions.values():
            assert tuple(part.store.cache_vectors.shape) == shape0
    assert store.n_cached <= store.n_slots


def test_per_filter_partitions_and_lru(port, tiny_corpus):
    _, labels, queries = tiny_corpus
    eng = port.with_cache(64 * RECORD, policy="adaptive", refresh_every=0, cache_partitions=2)
    store = eng.record_store
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        for target in (0, 1, 2, 3):
            _search(eng, queries[:4], target=target)
        assert set(store.partitions) == {("label", 2), ("label", 3)}
        assert reg.family_total("cache.partition_evictions") == 2
        store.refresh()
        for (kind, tgt), part in store.partitions.items():
            assert (np.asarray(labels)[part.counts.numpy() > 0] == tgt).all()
            assert isinstance(part.store, CachedRecordStore)
        assert store.last_refresh_sets == 3
        store.refresh()
    assert store.last_refresh_sets == 1
    assert reg.family_total("cache.refresh_sets") == 4
    assert reg.family_total("cache.refreshes") == 2
    assert reg.family_total("cache.partitions") == 2


def test_partition_snapshot_served_after_refresh(port, tiny_corpus):
    _, _, queries = tiny_corpus
    eng = port.with_cache(64 * RECORD, policy="adaptive", refresh_every=0)
    store = eng.record_store
    _search(eng, queries, target=0)
    bucket = filter_bucket("label", np.zeros(4, np.int32))
    assert store.store_for(bucket) is store.global_store
    store.refresh()
    assert store.store_for(bucket) is store.partitions[bucket].store


def test_filter_bucket_keys():
    assert filter_bucket(None, None) is None
    assert filter_bucket("label", np.asarray([3, 3, 1])) == ("label", 3)
    lo, hi = np.asarray([0.5, 0.5]), np.asarray([1.5, 1.5])
    assert filter_bucket("range", np.stack([lo, hi])) == ("range", 0.5, 1.5)
    b1 = filter_bucket("tags", np.asarray([[3, 0]], np.uint32))
    b2 = filter_bucket("tags", np.asarray([[3, 0]], np.uint32))
    assert b1 == b2 and b1[0] == "tags"


def test_wrap_pads_to_fixed_slots(port):
    backing = port.record_store
    vecs, nbrs = port.vectors, backing.neighbors
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        store = CachedRecordStore.wrap(backing, vectors=vecs, neighbors=nbrs,
                                       hot_ids=np.asarray([5, 9], np.int32), policy="adaptive",
                                       n_slots=16, device="cpu")
        assert tuple(store.cache_vectors.shape) == (16, vecs.shape[1])
        assert store.n_cached == 2 and store.hot_ids().tolist() == [5, 9]
        store2 = CachedRecordStore.wrap(backing, vectors=vecs, neighbors=nbrs,
                                        hot_ids=np.arange(32, dtype=np.int32), policy="adaptive",
                                        n_slots=16, device="cpu")
    assert store2.n_cached == 16 and tuple(store2.cache_vectors.shape) == (16, vecs.shape[1])
    assert reg.family_total("cache.materializations", policy="adaptive") == 2


def test_sub_record_budget_leaves_adaptive_off(port, tiny_corpus):
    _, _, queries = tiny_corpus
    eng = port.with_cache(100, policy="adaptive")
    assert not isinstance(eng.record_store, AdaptiveRecordCache)
    assert int(_search(eng, queries[:4]).stats.n_cache_hits.sum()) == 0


def test_modeled_cost_prices_refresh(port, tiny_corpus):
    _, _, queries = tiny_corpus
    fast = port.with_cache(128 * RECORD, policy="adaptive", refresh_every=1)
    slow = port.with_cache(128 * RECORD, policy="adaptive", refresh_every=8)
    static = port.with_cache(128 * RECORD)
    out = _search(static, queries)
    assert fast.modeled_latency_us(out.stats) > slow.modeled_latency_us(out.stats) > \
        static.modeled_latency_us(out.stats)


def test_restore_state_rejects_mismatched_corpus(adaptive_engine, tiny_corpus):
    _, _, queries = tiny_corpus
    _search(adaptive_engine, queries[:4])
    store = adaptive_engine.record_store
    state = store.export_state()
    with pytest.raises(ValueError, match="keyed to node ids"):
        store.restore_state(dict(state, n=state["n"] + 1))
    with pytest.raises(ValueError, match="keyed to node ids"):
        store.restore_state(dict(state, counts=state["counts"][:-1]))


def test_reset_counters_forgets_workload(adaptive_engine, tiny_corpus):
    _, _, queries = tiny_corpus
    for _ in range(3):
        _search(adaptive_engine, queries)
    store = adaptive_engine.record_store
    assert float(store.counts.sum()) > 0
    store.reset_counters()
    assert float(store.counts.sum()) == 0.0
    assert len(store.partitions) == 0 and store.batches_since_refresh == 0
    np.testing.assert_array_equal(store.hot_ids(), store.seed_hot_ids)
    out = _search(adaptive_engine, queries)
    base = _search(adaptive_engine.with_cache(0), queries)
    assert torch.equal(out.ids, base.ids)


def test_export_restore_matches_reference_state(tiny_engine, port, tiny_corpus):
    """The exported state of the two packages after the same batches, and a
    restore of the reference's state into the port, hot sets included."""
    _, _, queries = tiny_corpus
    j = tiny_engine.with_cache(128 * RECORD, policy="adaptive", refresh_every=0)
    t = port.with_cache(128 * RECORD, policy="adaptive", refresh_every=0)
    for target in (0, 1, 0):
        tgt = np.full(queries.shape[0], target, np.int32)
        j.search(queries, filter_kind="label", filter_params=tgt,
                 search_config=JConfig(mode="gate", **SEARCH))
        t.search(queries, filter_kind="label", filter_params=tgt,
                 search_config=SearchConfig(mode="gate", **SEARCH))
    js, ts = j.record_store.export_state(), t.record_store.export_state()
    assert js["n"] == ts["n"]
    np.testing.assert_array_equal(ts["counts"], js["counts"])
    assert [k for k, _ in ts["partitions"]] == [k for k, _ in js["partitions"]]
    fresh = port.with_cache(128 * RECORD, policy="adaptive", refresh_every=0)
    fresh.record_store.restore_state(js)
    j.record_store.restore_state(js)
    np.testing.assert_array_equal(fresh.record_store.hot_ids(), j.record_store.hot_ids())
    for key in j.record_store.partitions:
        np.testing.assert_array_equal(fresh.record_store.partitions[key].store.hot_ids(),
                                      j.record_store.partitions[key].store.hot_ids())


def test_adaptive_over_the_disk_tier(port_disk, tiny_corpus):
    """The adaptive cache on the disk tier (lazy vectors: the seed is the BFS
    order, refreshes gather hot rows off the file): results equal the
    uncached disk tier's, and the reads stay reconciled."""
    _, _, queries = tiny_corpus
    base = _search(port_disk, queries)
    eng = port_disk.with_cache(64 * RECORD, policy="adaptive", refresh_every=1)
    np.testing.assert_array_equal(eng.record_store.seed_hot_ids,
                                  tcache.bfs_hot_set(eng.record_store.neighbors, eng.medoid, 64))
    disk = eng.measured_store()
    for batch in range(3):
        disk.reset_io_counters()
        out = eng.search(queries, filter_kind="label",
                         filter_params=np.zeros(queries.shape[0], np.int32),
                         search_config=SearchConfig(mode="gate", search_l=64, beam_width=4,
                                                    pipeline_depth=1 + 2 * (batch % 2)))
        assert torch.equal(out.ids, base.ids) and torch.equal(out.dists, base.dists), batch
        assert torch.equal(out.stats.n_ios + out.stats.n_cache_hits, base.stats.n_ios), batch
        assert disk.io_counters()["records_read"] == int(out.stats.n_ios.sum()), batch
    assert int(out.stats.n_cache_hits.sum()) > 0
    assert eng.io_counters() == disk.io_counters()


def test_cache_tier_is_accepted_on_load(index_path, tiny_corpus):
    _, _, queries = tiny_corpus
    eng = GateANNEngine.load(index_path, device="cpu", cache_budget_bytes=32 * RECORD,
                             cache_policy="bfs")
    assert isinstance(eng.record_store, CachedRecordStore)
    assert eng.record_store.policy == "bfs" and eng.record_store.n_cached == 32
    eng = GateANNEngine.load(index_path, device="cpu", cache_budget_bytes=32 * RECORD,
                             cache_policy="adaptive")
    assert isinstance(eng.record_store, AdaptiveRecordCache)
    assert eng.maybe_refresh() is False
    with pytest.raises(ValueError, match="cache_policy"):
        GateANNEngine.load(index_path, device="cpu", cache_budget_bytes=RECORD,
                           cache_policy="lru")
    assert tadaptive.ADAPTIVE_POLICY == jadaptive.ADAPTIVE_POLICY
