"""The port's disk and host tiers against the reference's, on the same files.

The JAX tiny engine is saved once monolithic (v1 records) and once in two
record segments (v2).  On those files:

  * the port's ``DiskRecordStore`` and the reference's give the same
    records and the same ``io_counters()`` for every ``io_mode``, on
    duplicate-heavy and all-invalid beams, at ``max_gap_sectors`` in
    {-1, 0, 2}, and under scripted faults (retry, degrade, fail, short
    reads); ``merge_ranges`` is the reference's;
  * a port disk engine searches exactly as the reference's disk tier and
    as the port's memory tier, in all five modes, unfused and fused —
    ids, distances, the six ``SearchStats`` and the read counters;
  * the pipelined loops at depths 2-4 equal depth 1, with
    ``records_read == sum(n_ios)``, ``abandoned_tokens == 0`` and real
    overlap; the submit/drain pair serves what ``fetch`` serves;
  * failures: unknown tokens raise, ``abandon_pending`` retires orphans,
    the engine abandons in-flight rounds when a search fails, and a
    scripted ``FaultPlan`` under ``io_on_error="degrade"`` degrades the
    same slots as the reference's;
  * the host tier equals the memory tier.

Everything runs on the CPU (``device="cpu"``); ``tests/test_torch_cuda.py``
holds the disk tier on the card to the CPU.
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GateANNEngine as JEngine  # noqa: E402
from repro.core import SearchConfig as JConfig  # noqa: E402
from repro.store import DiskRecordStore as JDisk  # noqa: E402
from repro.store import FaultPlan as JPlan  # noqa: E402
from repro.store import RetryPolicy as JRetry  # noqa: E402
from repro.store import disk as jdisk  # noqa: E402
from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.store import DiskRecordStore, FaultPlan, RetryPolicy  # noqa: E402
from repro_torch.store import disk as tdisk  # noqa: E402

MODES = ("gate", "post", "early", "pre_naive", "unfiltered")
IO_MODES = ("preadv", "pread", "gather")


@pytest.fixture(scope="module")
def saved(tiny_engine, tmp_path_factory):
    paths = {}
    for shards in (1, 2):
        path = str(tmp_path_factory.mktemp(f"disk{shards}") / "tiny.gann")
        tiny_engine.save(path, shards=shards)
        paths[shards] = path
    return paths


@pytest.fixture(scope="module")
def mem(saved):
    return GateANNEngine.load(saved[1], device="cpu")


@pytest.fixture(scope="module")
def disk(saved):
    return {s: GateANNEngine.load(p, device="cpu", store_tier="disk") for s, p in saved.items()}


def _filter(mode, n):
    if mode == "unfiltered":
        return None, None
    return "label", np.arange(n, dtype=np.int32) % 10


def _search(eng, queries, mode="gate", **cfg):
    kind, params = _filter(mode, queries.shape[0])
    return eng.search(queries, filter_kind=kind, filter_params=params,
                      search_config=SearchConfig(mode=mode, **cfg))


def _assert_same(got, want, ctx):
    np.testing.assert_array_equal(np.asarray(got.ids), np.asarray(want.ids), err_msg=str(ctx))
    np.testing.assert_array_equal(np.asarray(got.dists), np.asarray(want.dists), err_msg=str(ctx))
    for f in want.stats._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got.stats, f)),
                                      np.asarray(getattr(want.stats, f)),
                                      err_msg=f"{ctx}: stats.{f}")


def _beam(kind, n):
    """(4, 12) id beams: duplicate-heavy (repeats, -1s, clustered ids a few
    sectors apart so the gap bound matters) or all invalid."""
    rng = np.random.default_rng(17)
    if kind == "invalid":
        return np.full((4, 12), -1, np.int32)
    base = rng.integers(0, n - 40, size=3)
    pool = np.concatenate([b + np.array([0, 1, 2, 4, 7, 11]) for b in base] + [[n - 1, 0]])
    ids = rng.choice(pool, size=(4, 12)).astype(np.int32)
    ids[rng.random((4, 12)) < 0.2] = -1
    ids[1, :4] = ids[0, 3]
    return ids


# ------------------------------------------------------------- the store --
def test_merge_ranges_matches_reference():
    rng = np.random.default_rng(5)
    cases = [np.zeros(0, np.int64), np.array([7]), np.arange(3, 9),
             np.array([0, 1, 3, 4, 5, 9, 20, 21])]
    cases += [np.unique(rng.integers(0, 60, size=s)) for s in (5, 30, 80)]
    for sectors in cases:
        np.testing.assert_array_equal(tdisk.merge_ranges(sectors), jdisk.merge_ranges(sectors))


@pytest.mark.parametrize("beam", ["dups", "invalid"])
@pytest.mark.parametrize("max_gap", [-1, 0, 2])
@pytest.mark.parametrize("io_mode", IO_MODES)
@pytest.mark.parametrize("shards", [1, 2])
def test_fetch_and_counters_match_reference(saved, shards, io_mode, max_gap, beam):
    j = JDisk.open(saved[shards], io_mode=io_mode, max_gap_sectors=max_gap)
    t = DiskRecordStore.open(saved[shards], device="cpu", io_mode=io_mode, max_gap_sectors=max_gap)
    ids = _beam(beam, t.n)
    for _ in range(2):  # counters accumulate across rounds
        jv, jn = j._host_fetch(ids)
        tv, tn = t._host_fetch(ids)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tn, jn)
    vecs, nbrs = t.fetch(torch.from_numpy(ids))
    np.testing.assert_array_equal(vecs.numpy(), jv)
    np.testing.assert_array_equal(nbrs.numpy(), jn)
    j._host_fetch(ids)
    assert t.io_counters() == j.io_counters()
    assert t.n_shards == j.n_shards == shards
    assert t.index_bytes() == j.index_bytes() and t.record_bytes() == j.record_bytes()
    j.close()
    t.close()


def test_submit_neighbors_match_record_neighbors(saved):
    """The sidecar rows submit() serves equal the records' nbrs fields, and
    the drained vectors equal fetch's: what makes the pipeline exact."""
    store = DiskRecordStore.open(saved[2], device="cpu")
    ids = np.random.default_rng(3).integers(-1, store.n, size=(5, 7)).astype(np.int32)
    want_v, want_n = store._host_fetch(ids)
    token, nbrs = store._host_submit(ids)
    vecs = store._host_drain(token, ids, True)
    np.testing.assert_array_equal(nbrs, want_n)
    np.testing.assert_array_equal(vecs, want_v)
    t_ids = torch.from_numpy(ids)
    t_token, t_nbrs = store.submit(t_ids)
    t_vecs = store.drain(t_token, t_ids, True)
    np.testing.assert_array_equal(t_nbrs.numpy(), want_n)
    np.testing.assert_array_equal(t_vecs.numpy(), want_v)
    c = store.io_counters()
    assert c["inflight_depth_max"] == 1 and c["abandoned_tokens"] == 0
    store.close()


def test_drain_unknown_token_raises(saved):
    store = DiskRecordStore.open(saved[1], device="cpu")
    ids = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(KeyError, match="unknown token"):
        store.drain(10**6, ids, True)
    with pytest.raises(KeyError, match="unknown token"):
        store._host_drain(np.int32(10**6), ids.numpy(), True)
    # live=False is the warm-up no-op: zeros, queue untouched
    z = store.drain(10**6, ids, False)
    assert z.shape == (1, 2, store.dim) and not z.any()
    store.close()


def test_abandon_pending_retires_orphaned_rounds(saved):
    store = DiskRecordStore.open(saved[1], device="cpu")
    rng = np.random.default_rng(7)
    beams = [torch.from_numpy(rng.integers(-1, store.n, size=(2, 3)).astype(np.int32))
             for _ in range(3)]
    tokens = [store.submit(b)[0] for b in beams]  # never drained
    assert len(store._pending) == 3
    assert store.abandon_pending() == 3
    assert store.io_counters()["abandoned_tokens"] == 3
    assert not store._pending and not store._staged and store._inflight == 0
    with pytest.raises(KeyError, match="unknown token"):
        store.drain(tokens[0], beams[0], True)
    # the reader pool survived: a fresh round works
    token, _ = store.submit(beams[0])
    got = store.drain(token, beams[0], True)
    np.testing.assert_array_equal(got.numpy(), store._host_fetch(beams[0].numpy())[0])
    assert store.abandon_pending() == 0
    store.close()


def test_faults_copy_decides_as_the_reference():
    from repro.store.faults import FAULT_KINDS as J_KINDS
    from repro_torch.store.faults import FAULT_KINDS

    assert FAULT_KINDS == J_KINDS
    plan = dict(seed=42, p_eio=0.2, p_eagain=0.1, p_short=0.2, p_delay=0.0,
                schedule=((3, "eio"), (9, "short")), max_faults=25)
    a, b = FaultPlan(**plan).injector(), JPlan(**plan).injector()
    assert [a._decide() for _ in range(200)] == [b._decide() for _ in range(200)]
    assert a.counters() == b.counters()
    for bad in (dict(p_eio=0.8, p_short=0.5), dict(short_frac=1.5), dict(schedule=((0, "x"),))):
        with pytest.raises(ValueError):
            FaultPlan(**bad)
    assert RetryPolicy(seed=3).backoff(2) == JRetry(seed=3).backoff(2)


@pytest.mark.parametrize("case", ["eagain_retried", "eio_degraded", "eio_fails", "short_reads"])
@pytest.mark.parametrize("io_mode", ["preadv", "pread"])
def test_faulted_fetch_matches_reference(saved, io_mode, case):
    """Scripted faults under each policy: the same records (degraded slots
    as +inf with sidecar neighbours), the same counters, the same raise."""
    schedule, kw = {
        "eagain_retried": (((0, "eagain"),), dict(retry=(2, 0.0))),
        "eio_degraded": (((0, "eio"), (2, "eio")), dict(on_error="degrade")),
        "eio_fails": (((1, "eio"),), {}),
        "short_reads": (((0, "short"), (1, "short")), {}),
    }[case]
    stores = []
    for on, plan_cls, retry_cls, store_cls in (({}, JPlan, JRetry, JDisk),
                                               ({"device": "cpu"}, FaultPlan, RetryPolicy,
                                                DiskRecordStore)):
        retry = retry_cls(max_retries=kw["retry"][0], backoff_s=kw["retry"][1]) \
            if "retry" in kw else None
        stores.append(store_cls.open(saved[2], io_mode=io_mode, max_gap_sectors=0,
                                     faults=plan_cls(seed=1, schedule=schedule), retry=retry,
                                     on_error=kw.get("on_error", "fail"), **on))
    ids = _beam("dups", stores[0].n)
    outs = []
    for store in stores:
        try:
            outs.append(store._host_fetch(ids))
        except OSError as e:
            outs.append(type(e))
    if case == "eio_fails":
        assert outs == [OSError, OSError]
    else:
        for a, b in zip(*outs):
            np.testing.assert_array_equal(b, a)
    if case == "eio_degraded":
        assert np.isinf(outs[1][0]).any()
    assert stores[1].io_counters() == stores[0].io_counters()
    assert stores[1].fault_counters() == stores[0].fault_counters()
    for store in stores:
        store.close()


def test_warm_and_drop_page_cache(saved, tmp_path):
    store = DiskRecordStore.open(saved[2], device="cpu")
    store.warm(background=False)
    seg_bytes = sum(os.path.getsize(s.path) for s in store._segments)
    assert store.io_counters()["warmed_bytes"] == seg_bytes
    t = store.warm(background=True)
    assert store.warm_wait(timeout=30) and not t.is_alive()
    store.drop_page_cache()
    assert store.io_counters()["warm_errors"] == 0
    store._segments[1].path = str(tmp_path / "gone")  # a vanished segment counts
    store.drop_page_cache()
    assert store.io_counters()["warm_errors"] == 1
    store.close()


def _within(seconds: float, body) -> None:
    """Run ``body`` on a thread and fail the test if it has not returned
    after ``seconds`` (a hung warmer must not cost the suite its clock)."""
    err = []

    def run():
        try:
            body()
        except BaseException as e:  # noqa: BLE001 — re-raised on the test's thread
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds} s"
    if err:
        raise err[0]


def test_warm_reentrant_counts_one_pass(saved):
    """A second warm while one runs stops and joins the first: no deadlock,
    and warmed_bytes never double-counts (one cut-short pass + one full)."""
    def body():
        store = DiskRecordStore.open(saved[2], device="cpu")
        total = sum(os.path.getsize(s.path) for s in store._segments)
        first = store.warm(background=True, chunk_bytes=1 << 12)
        second = store.warm(background=True, chunk_bytes=1 << 16)
        assert not first.is_alive()  # joined before the second started
        assert store.warm_wait(timeout=30.0) and not second.is_alive()
        assert total <= store.io_counters()["warmed_bytes"] < 2 * total
        store.reset_io_counters()
        store.warm(background=True, chunk_bytes=1 << 12)
        store.warm(background=False)
        assert store.io_counters()["warmed_bytes"] < 2 * total
        store.close()
    _within(60.0, body)


def test_close_mid_warm_stops_the_warmer(saved, monkeypatch):
    """close() during a warm signals the thread, which ends promptly and
    reads through its own fds only (none of the store's, all closed); a
    later warm on the closed store raises."""
    def body():
        store = DiskRecordStore.open(saved[2], device="cpu")
        total = sum(os.path.getsize(s.path) for s in store._segments)
        warm_fds, foreign = set(), []  # the fds the warmer opened; reads through others
        real_open, real_pread = os.open, os.pread

        def on_warmer() -> bool:
            return threading.current_thread().name == "gateann-warm"

        def open_(*args, **kwargs):
            fd = real_open(*args, **kwargs)
            if on_warmer():
                warm_fds.add(fd)
            return fd

        def pread(fd, n, off):
            if on_warmer() and fd not in warm_fds:
                foreign.append(fd)
            return real_pread(fd, n, off)

        for seg in store._segments:
            seg.open_fd()
        monkeypatch.setattr(os, "open", open_)
        monkeypatch.setattr(os, "pread", pread)
        t = store.warm(background=True, chunk_bytes=1 << 12)
        store.close()
        assert all(seg.fd < 0 for seg in store._segments)
        assert store.warm_wait(timeout=30.0) and not t.is_alive()
        assert not foreign, f"the warmer read through fds it did not open: {foreign}"
        assert store.io_counters()["warmed_bytes"] <= total
        with pytest.raises(ValueError, match="closed store"):
            store.warm(background=False)
        with pytest.raises(ValueError, match="closed store"):
            store.warm(background=True)
    _within(60.0, body)


def test_open_without_device_raises_without_cuda(saved, monkeypatch):
    """DiskRecordStore's device defaults to the card, as every entry point's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiskRecordStore.open(saved[1])


def test_configure_resilience(saved):
    store = DiskRecordStore.open(saved[1], device="cpu")
    with pytest.raises(ValueError):
        store.configure_resilience(on_error="nope")
    store.configure_resilience(retry=RetryPolicy(max_retries=2), on_error="degrade",
                               round_deadline_s=0.5)
    assert (store.retry_policy.max_retries, store.on_error, store.round_deadline_s) == (
        2, "degrade", 0.5)
    with pytest.raises(ValueError):
        DiskRecordStore.open(saved[1], device="cpu", io_mode="mmap")
    store.close()


# ------------------------------------------------------------ the engine --
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("mode", MODES)
def test_search_matches_reference_disk_tier(saved, tiny_corpus, mem, disk, mode, fused):
    """Port disk tier == reference disk tier == port memory tier, and the
    two disk tiers did the same reads."""
    _, _, queries = tiny_corpus
    jeng = JEngine.load(saved[1], store_tier="disk")
    kind, params = _filter(mode, queries.shape[0])
    want = jeng.search(queries, filter_kind=kind, filter_params=params,
                       search_config=JConfig(mode=mode, use_fused_kernel=fused))
    np.asarray(want.stats.n_ios)  # the reference's reads complete with its outputs
    store = disk[1].measured_store()
    store.reset_io_counters()
    got = _search(disk[1], queries, mode, use_fused_kernel=fused)
    _assert_same(got, want, (mode, fused))
    _assert_same(got, _search(mem, queries, mode, use_fused_kernel=fused), (mode, fused, "mem"))
    assert disk[1].io_counters() == jeng.io_counters()
    jeng.record_store.close()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("shards", [1, 2])
def test_pipelined_depths_equal_depth_one(tiny_corpus, disk, shards, fused):
    _, _, queries = tiny_corpus
    eng = disk[shards]
    store = eng.measured_store()
    store.reset_io_counters()
    sync = _search(eng, queries, use_fused_kernel=fused)
    c = store.io_counters()
    assert c["inflight_depth_max"] == 0 and c["overlapped_rounds"] == 0  # depth 1 never submits
    for depth in (2, 3, 4):
        store.reset_io_counters()
        out = _search(eng, queries, use_fused_kernel=fused, pipeline_depth=depth)
        _assert_same(out, sync, (shards, fused, depth))
        c = store.io_counters()
        assert c["records_read"] == int(out.stats.n_ios.sum())
        assert c["pages_read"] == int(out.stats.n_ios.sum()) * store.pages_per_record
        assert c["unique_sectors_read"] <= c["records_read"]
        assert c["abandoned_tokens"] == 0 and not store._pending and not store._staged
        assert 2 <= c["inflight_depth_max"] <= depth and c["overlapped_rounds"] > 0
        assert c["fetch_rounds"] == int(out.stats.n_hops[0])


@pytest.mark.parametrize("mode", ["post", "pre_naive"])
def test_pipelined_other_modes(tiny_corpus, disk, mode):
    _, _, queries = tiny_corpus
    sync = _search(disk[1], queries, mode)
    _assert_same(_search(disk[1], queries, mode, pipeline_depth=3), sync, mode)


def test_engine_abandons_on_midsearch_failure(tiny_corpus, saved, monkeypatch):
    """The third drain fails with rounds in flight: the engine abandons
    them (counted), and the next search runs clean."""
    _, _, queries = tiny_corpus
    eng = GateANNEngine.load(saved[1], device="cpu", store_tier="disk")
    store = eng.measured_store()
    real = store.drain
    calls = []

    def failing(token, ids, live):
        calls.append(token)
        if len(calls) == 3:
            raise RuntimeError("drain failed mid-search")
        return real(token, ids, live)

    monkeypatch.setattr(store, "drain", failing)
    with pytest.raises(RuntimeError, match="drain failed"):
        _search(eng, queries, pipeline_depth=4)
    assert store.io_counters()["abandoned_tokens"] >= 1
    assert not store._pending and store._inflight == 0
    monkeypatch.undo()
    store.reset_io_counters()
    out = _search(eng, queries, pipeline_depth=4)
    assert store.io_counters()["records_read"] == int(out.stats.n_ios.sum())
    # the failure path of search itself, as the reference tests it
    def boom(**kwargs):
        raise RuntimeError("stage A failed")

    monkeypatch.setattr(tsearch, "filtered_search", boom)
    tokens = [store.submit(torch.zeros((1, 2), dtype=torch.int32))[0]]
    with pytest.raises(RuntimeError, match="stage A failed"):
        _search(eng, queries, pipeline_depth=2)
    assert tokens and not store._pending
    store.close()


def test_degraded_search_matches_reference(saved, tiny_corpus):
    """Scripted EIOs under io_on_error="degrade" in the synchronous loop:
    the reference's degraded slots, ids, distances and stats."""
    _, _, queries = tiny_corpus
    schedule = tuple((i, "eio") for i in (1, 3, 6))
    jeng = JEngine.load(saved[1], store_tier="disk", io_on_error="degrade",
                        faults=JPlan(seed=7, schedule=schedule))
    kind, params = _filter("gate", queries.shape[0])
    cfg = dict(mode="gate", search_l=32, beam_width=4)
    want = jeng.search(queries, filter_kind=kind, filter_params=params,
                       search_config=JConfig(**cfg))
    np.asarray(want.stats.n_degraded)
    eng = GateANNEngine.load(saved[1], device="cpu", store_tier="disk", io_on_error="degrade",
                             faults=FaultPlan(seed=7, schedule=schedule))
    got = _search(eng, queries, **cfg)
    _assert_same(got, want, "degraded")
    assert int(got.stats.n_degraded.sum()) > 0
    assert eng.io_counters() == jeng.io_counters()
    assert eng.io_counters()["degraded_records"] == int(got.stats.n_degraded.sum())
    jeng.record_store.close()
    eng.measured_store().close()


@pytest.mark.parametrize("mode", MODES)
def test_host_tier_equals_memory_tier(saved, tiny_corpus, mem, mode):
    _, _, queries = tiny_corpus
    host = GateANNEngine.load(saved[2], device="cpu", store_tier="host")
    _assert_same(_search(host, queries, mode, pipeline_depth=2), _search(mem, queries, mode),
                 mode)
    assert host.memory_report()["record_tier"] == "host"
    assert host.io_counters() == {} and host.abandon_pending_io() == 0


def test_disk_engine_reports_and_lazy_vectors(saved, disk):
    jeng = JEngine.load(saved[2], store_tier="disk")
    got, want = disk[2].memory_report(), jeng.memory_report()
    for key in ("n", "dim", "pq_bytes", "neighbor_store_bytes", "filter_store_bytes",
                "record_tier", "record_tier_bytes", "disk_index_bytes", "disk_sector_bytes",
                "disk_io_mode", "disk_shards", "disk_max_gap_sectors"):
        assert got[key] == want[key], key
    vecs = disk[2].vectors
    assert not isinstance(vecs, torch.Tensor) and vecs.shape == (2000, 24)
    np.testing.assert_array_equal(vecs[np.array([0, 1999])],
                                  np.asarray(jeng.vectors[np.array([0, 1999])]))
    assert disk[2].measured_store() is disk[2].record_store
    jeng.record_store.close()


def test_disk_tier_refusals(saved):
    with pytest.raises(ValueError, match="index file"):
        GateANNEngine.from_arrays(np.zeros((2, 4), np.float32), np.zeros((2, 1), np.int32),
                                  np.zeros((1, 2, 4), np.float32), np.zeros((2, 1), np.int32),
                                  0, config=EngineConfig(store_tier="disk"), device="cpu")
    with pytest.raises(ValueError, match="on_error"):
        GateANNEngine.load(saved[1], device="cpu", store_tier="disk", io_on_error="retry")
