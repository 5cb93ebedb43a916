"""The port's engine and search loop against the reference, end to end.

The JAX tiny engine is saved once; the port loads that file on the CPU
(``device="cpu"``: the kernels' plain versions) and must give the ids,
the distances and all six ``SearchStats`` counters of the reference's
``filtered_search`` in all five modes, through the unfused and the fused
loop.  ``from_arrays`` on the reference engine's state must give the
same engine without a file.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import SearchConfig as JConfig  # noqa: E402
from repro.core import recall_at_k as j_recall  # noqa: E402
from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig, recall_at_k  # noqa: E402

MODES = ("gate", "post", "early", "pre_naive", "unfiltered")


@pytest.fixture(scope="module")
def index_path(tiny_engine, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_search") / "tiny.gann")
    tiny_engine.save(path)
    return path


@pytest.fixture(scope="module")
def port(index_path):
    return GateANNEngine.load(index_path, device="cpu")


def _filter(mode, queries):
    if mode == "unfiltered":
        return None, None
    return "label", np.arange(queries.shape[0], dtype=np.int32) % 10


def _assert_same(got, want, ctx):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids), err_msg=str(ctx))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists), err_msg=str(ctx))
    for f in want.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, f).numpy(),
                                      np.asarray(getattr(want.stats, f)),
                                      err_msg=f"{ctx}: stats.{f}")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", MODES)
def test_search_matches_reference(tiny_engine, tiny_corpus, port, mode, fused):
    _, _, queries = tiny_corpus
    kind, params = _filter(mode, queries)
    want = tiny_engine.search(queries, filter_kind=kind, filter_params=params,
                              search_config=JConfig(mode=mode, use_fused_kernel=fused))
    got = port.search(queries, filter_kind=kind, filter_params=params,
                      search_config=SearchConfig(mode=mode, use_fused_kernel=fused))
    _assert_same(got, want, (mode, fused))


def test_range_filter_matches_reference(tiny_engine, tiny_corpus, port):
    corpus, _, queries = tiny_corpus
    norms = np.linalg.norm(corpus, axis=1)
    lo = np.full(queries.shape[0], np.quantile(norms, 0.3), np.float32)
    hi = np.full(queries.shape[0], np.quantile(norms, 0.6), np.float32)
    cfg = dict(mode="gate", search_l=32, beam_width=4)
    want = tiny_engine.search(queries, filter_kind="range", filter_params=(lo, hi),
                              search_config=JConfig(**cfg))
    got = port.search(queries, filter_kind="range", filter_params=(lo, hi),
                      search_config=SearchConfig(**cfg))
    _assert_same(got, want, "range")


def test_from_arrays_equals_load(tiny_engine, tiny_corpus, port):
    """The reference engine's state handed over as numpy arrays."""
    _, _, queries = tiny_corpus
    j = tiny_engine
    served = {f.name for f in dataclasses.fields(EngineConfig)}
    eng = GateANNEngine.from_arrays(
        np.asarray(j.vectors), np.asarray(j.record_store.neighbors), np.asarray(j.codec.books),
        np.asarray(j.codes), int(j.medoid),
        {"label": np.asarray(j.filters["label"].labels),
         "range": np.asarray(j.filters["range"].values)},
        EngineConfig(**{k: v for k, v in dataclasses.asdict(j.config).items() if k in served}),
        device="cpu",
    )
    assert eng.memory_report() == port.memory_report()
    kind, params = _filter("gate", queries)
    a = eng.search(queries, filter_kind=kind, filter_params=params)
    b = port.search(queries, filter_kind=kind, filter_params=params)
    for x, y in zip((a.ids, a.dists, *a.stats), (b.ids, b.dists, *b.stats)):
        assert torch.equal(x, y)


def test_memory_report_matches_reference(tiny_engine, port):
    want = tiny_engine.memory_report()
    got = port.memory_report()
    for key in ("n", "dim", "pq_bytes", "neighbor_store_bytes", "filter_store_bytes",
                "record_tier", "record_tier_bytes"):
        assert got[key] == want[key], key


def test_pipeline_depth_runs_the_synchronous_loop(tiny_corpus, port):
    """The memory tier has no submit/drain: any depth is the synchronous
    loop, as in the reference for such stores."""
    _, _, queries = tiny_corpus
    kind, params = _filter("gate", queries)
    a = port.search(queries, filter_kind=kind, filter_params=params,
                    search_config=SearchConfig(pipeline_depth=1))
    b = port.search(queries, filter_kind=kind, filter_params=params,
                    search_config=SearchConfig(pipeline_depth=3))
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)


def test_recall_at_k_matches_reference():
    rng = np.random.default_rng(0)
    res = rng.integers(-1, 20, size=(6, 10)).astype(np.int32)
    gt = np.stack([rng.permutation(20)[:10] for _ in range(6)]).astype(np.int32)
    gt[0, 5:] = -1
    assert recall_at_k(torch.from_numpy(res), gt) == j_recall(res, gt)


def test_load_without_device_raises_without_cuda(index_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GateANNEngine.load(index_path)


def test_unported_tiers_refused(index_path):
    """Every field of the reference's EngineConfig is served now: the cache
    tiers and the build knobs are accepted on load; a field the port does
    not know is refused by name, and so are a bad tier, a bad cache policy
    and faults= off the disk tier."""
    from repro.core import EngineConfig as JEngineConfig
    from repro_torch.store import AdaptiveRecordCache, CachedRecordStore

    assert [f.name for f in dataclasses.fields(EngineConfig)] == \
        [f.name for f in dataclasses.fields(JEngineConfig)]
    eng = GateANNEngine.load(index_path, device="cpu", cache_budget_bytes=1 << 20)
    assert isinstance(eng.record_store, CachedRecordStore)
    eng = GateANNEngine.load(index_path, device="cpu", cache_budget_bytes=1 << 20,
                             cache_policy="adaptive")
    assert isinstance(eng.record_store, AdaptiveRecordCache)
    assert GateANNEngine.load(index_path, device="cpu", build_l=40).config.build_l == 40
    with pytest.raises(ValueError, match="faults= wraps the disk tier"):
        GateANNEngine.load(index_path, device="cpu", faults=object())
    with pytest.raises(ValueError, match="unknown EngineConfig.*no_such_knob"):
        GateANNEngine.load(index_path, device="cpu", no_such_knob=1)
    with pytest.raises(ValueError, match="store_tier"):
        GateANNEngine.load(index_path, device="cpu", store_tier="ssd")
    with pytest.raises(ValueError, match="cache_policy"):
        GateANNEngine.load(index_path, device="cpu", cache_policy="lru")
    with pytest.raises(ValueError):
        SearchConfig(mode="nope")


def test_from_arrays_refuses_out_of_range_ids():
    rng = np.random.default_rng(3)
    n = 20
    good = dict(vectors=rng.random((n, 8)).astype(np.float32),
                neighbors=rng.integers(-1, n, size=(n, 4)).astype(np.int32),
                pq_books=rng.random((2, 16, 4)).astype(np.float32),
                pq_codes=rng.integers(0, 16, size=(n, 2)).astype(np.int32), medoid=3)
    GateANNEngine.from_arrays(**good, device="cpu")
    for key, bad in (("neighbors", n), ("pq_codes", 16), ("medoid", n)):
        arrays = dict(good)
        if key == "medoid":
            arrays[key] = bad
        else:
            arrays[key] = arrays[key].copy()
            arrays[key][0, 0] = bad
        with pytest.raises(ValueError):
            GateANNEngine.from_arrays(**arrays, device="cpu")
