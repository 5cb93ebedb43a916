"""The host tier's fetch telemetry on the CPU (``store/vector_store.py``,
``kernels/host_gather.py``):

  * the plain version of ``host_gather`` is the memory tier's gather, and
    counts the live ids it is given;
  * a host-tier engine gives the memory tier's ids, distances and six stats
    on the unfused and the fused path;
  * ``store.fetch_rows{tier=host}`` is the number of ids >= 0 the slow tier
    was handed over the call, which is ``search.ios`` (also under a cache
    tier, which hands it only the misses), and ``store.fetch_bytes`` is
    that times D x 4 + R x 4; a call made with the registry off counts
    nothing, then or later;
  * the ``store.fetch`` span is recorded once a call while the process
    tracer is on, and never while it is off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.data import make_bigann_like, make_queries, uniform_labels  # noqa: E402
from repro_torch.kernels import host_gather as thg  # noqa: E402
from repro_torch.store import HostOffloadRecordStore, InMemoryRecordStore  # noqa: E402

N, D, R = 1500, 24, 12
ROW = D * 4 + R * 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    """A seeded corpus with its kNN graph, random PQ codes and books, and
    10 uniform labels; 16 queries and their labels."""
    x = make_bigann_like(N, D, seed=3)
    xt = torch.from_numpy(x)
    nbrs = torch.topk(torch.cdist(xt, xt), R + 1, largest=False).indices[:, 1:].int().numpy()
    codes = np.random.default_rng(4).integers(0, 256, size=(N, 8)).astype(np.int32)
    books = np.random.default_rng(5).random((8, 256, 3)).astype(np.float32) * 255
    q = make_queries(x, 16, seed=6)
    return (x, nbrs, books, codes, 0, {"label": uniform_labels(N, 10, seed=7)}), q, \
        np.arange(16, dtype=np.int32) % 10


def engine(arrays, tier):
    return GateANNEngine.from_arrays(*arrays[0], config=EngineConfig(store_tier=tier),
                                     device="cpu")


def search(eng, arrays, **kw):
    _, q, targets = arrays
    cfg = SearchConfig(mode="gate", search_l=32, beam_width=4, **kw)
    return eng.search(q, filter_kind="label", filter_params=targets, search_config=cfg)


class Handed:
    """Wraps a host store's fetch: the live ids each call was handed."""

    def __init__(self, monkeypatch):
        self.live = 0
        real = HostOffloadRecordStore.fetch

        def fetch(store, ids):
            self.live += int((ids >= 0).sum())
            return real(store, ids)

        monkeypatch.setattr(HostOffloadRecordStore, "fetch", fetch)


def test_plain_version_is_the_memory_gather_and_counts_live_ids():
    rng = np.random.default_rng(8)
    vecs = torch.from_numpy(rng.normal(size=(40, 5)).astype(np.float32))
    nbrs = torch.from_numpy(rng.integers(-1, 40, size=(40, 3)).astype(np.int32))
    ids = torch.from_numpy(rng.integers(-1, 40, size=(6, 4)).astype(np.int32))
    rows = torch.zeros((), dtype=torch.int64)
    got = thg.host_gather(vecs, nbrs, ids, rows)
    want = InMemoryRecordStore(vecs, nbrs).fetch(ids)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(rows) == int((ids >= 0).sum())
    thg.host_gather(vecs, nbrs, ids)  # uncounted
    assert int(rows) == int((ids >= 0).sum())


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_host_tier_equals_memory_tier(arrays, fused):
    a = search(engine(arrays, "host"), arrays, use_fused_kernel=fused)
    b = search(engine(arrays, "memory"), arrays, use_fused_kernel=fused)
    for g, w in zip((a.ids, a.dists, *a.stats), (b.ids, b.dists, *b.stats)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "cached"])
def test_fetch_counters_equal_their_definitions(arrays, monkeypatch, cached):
    eng = engine(arrays, "host")
    if cached:
        eng = eng.with_cache(8 * 4096, policy="bfs")
    handed = Handed(monkeypatch)
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        ios = sum(int(search(eng, arrays).stats.n_ios.sum()) for _ in range(2))
    assert handed.live == ios == reg.family_total("search.ios") > 0
    assert reg.family_total("store.fetch_rows") == handed.live
    assert reg.family_total("store.fetch_bytes") == handed.live * ROW
    assert [c.labels for c in reg.children("store.fetch_rows")] == [{"tier": "host"}]
    if cached:
        assert reg.family_total("search.cache_hits") > 0


def test_a_call_with_the_registry_off_counts_nothing(arrays, monkeypatch):
    eng = engine(arrays, "host")
    handed = Handed(monkeypatch)
    with obs.use_registry(obs.MetricsRegistry(enabled=False)):
        search(eng, arrays)
    assert handed.live > 0 and int(eng.record_store.rows_read) == 0
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        ios = int(search(eng, arrays).stats.n_ios.sum())
    assert reg.family_total("store.fetch_rows") == ios == handed.live // 2


@pytest.mark.parametrize("traced", [False, True])
def test_fetch_span_once_a_call(arrays, traced):
    eng = engine(arrays, "host")
    reg = obs.MetricsRegistry(enabled=True)
    tracer = obs.trace.default_tracer()
    with obs.use_registry(reg):
        if traced:
            tracer.enable()
        try:
            for _ in range(3):
                search(eng, arrays)
        finally:
            tracer.disable()
            tracer.reset()
    spans = {c.labels["span"]: c for c in reg.children("trace.span_seconds")}
    if not traced:
        assert spans == {}
        return
    fetch, calls = spans["store.fetch"], spans["engine.search"]
    assert fetch.count == calls.count == 3
    assert 0.0 < fetch.sum <= calls.sum
