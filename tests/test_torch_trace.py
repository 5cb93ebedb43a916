"""The port's served path traced from inside (``repro_torch.obs``,
``core/search.py``, ``serve/server.py``):

  * one clock with the device trace: a span's ``start_ns`` holds a
    ``torch.profiler`` event recorded inside it;
  * the round split into phases: ``search.rounds`` is every row's
    ``n_hops``, the five ``search.round_seconds`` phases sum to no more than
    the call's ``engine.search`` span, on the unfused, fused and pipelined
    paths; ``search.scored`` is the plain reference's ``scored``
    (``gatebench/reference.py``), query by query;
  * with the tracer and the registry off the loop reads no clock and
    counts nothing;
  * garbage-collection pauses: the process tracer's hook, and only its;
  * the dispatcher's ``serve.resolve`` and ``serve.batch_gap`` spans, the
    batch's number on its spans and its requests' traces;
  * the front end's batched publication: a histogram's batch observe gives
    what one ``observe`` a value gives, and ``io_report``'s span means are
    the requests' own.
"""
import gc
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.serve.rag import RAGServer  # noqa: E402
from repro_torch.serve.server import ServeFrontend, TenantSpec  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SEARCH = dict(mode="gate", search_l=32, beam_width=4)
WAIT_S = 60.0
# (tier, SearchConfig knobs) of each path of the loop
PATHS = {"unfused": ("memory", {}), "fused": ("memory", {"use_fused_kernel": True}),
         "depth2": ("disk", {"pipeline_depth": 2})}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index_path(tiny_engine, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_trace") / "tiny.gann")
    tiny_engine.save(path)
    return path


@pytest.fixture
def process_tracer():
    """The process-default tracer, enabled for the test and left as found."""
    tr = obs.trace.default_tracer()
    callbacks = list(gc.callbacks)
    tr.enable()
    try:
        yield tr
    finally:
        tr.disable()
        tr.reset()
    assert gc.callbacks == callbacks


def _gate(eng, queries, **kw):
    n = queries.shape[0]
    return eng.search(queries, filter_kind="label",
                      filter_params=np.arange(n, dtype=np.int32) % 10,
                      search_config=SearchConfig(**SEARCH, **kw))


def _engine(index_path, tier):
    return GateANNEngine.load(index_path, device="cpu", store_tier=tier)


def _close(eng):
    store = eng.measured_store()
    if store is not None:
        store.close()


# ------------------------------------------------------------ shared clock
def test_span_holds_a_profiler_event_on_its_clock():
    """A span around a ``record_function`` block under a CPU-activity
    profile contains that event's [start_ns, end_ns], to 1 ms: the span's
    ``start_ns`` is on the profiler's clock."""
    tr = obs.trace.Tracer()
    tr.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("probe"):
            with torch.profiler.record_function("trace_probe"):
                torch.randn(256, 256) @ torch.randn(256, 256)
    ev, = [e for e in prof.profiler.kineto_results.events() if e.name() == "trace_probe"]
    span, = [s for ring in tr.snapshot().values() for s in ring]
    start, end = span["start_ns"], span["start_ns"] + span["dur_s"] * 1e9
    assert start - 1e6 <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= end + 1e6
    assert ev.duration_ns() <= span["dur_s"] * 1e9 + 1e6
    doc = obs.export.to_json(obs.MetricsRegistry(enabled=True), tr)
    assert [s["start_ns"] for ring in doc["spans"].values() for s in ring] == [start]


# ----------------------------------------------------------- round phases
@pytest.mark.parametrize("path", list(PATHS))
def test_rounds_count_every_rows_hops(index_path, tiny_corpus, path):
    """``search.rounds`` == Σ ``n_hops[:, 0]`` over calls (rows hop
    together), on each path of the loop."""
    _, _, queries = tiny_corpus
    tier, kw = PATHS[path]
    reg = obs.MetricsRegistry(enabled=True)
    hops = 0
    with obs.use_registry(reg):
        eng = _engine(index_path, tier)
        try:
            for s in (slice(0, 8), slice(8, 16)):
                n_hops = _gate(eng, queries[s], **kw).stats.n_hops
                assert bool((n_hops == n_hops[0]).all())
                hops += int(n_hops[0])
        finally:
            _close(eng)
    assert hops > 0
    assert reg.family_total("search.rounds") == hops
    assert reg.family_total("search.dispatch") == 2


@pytest.mark.parametrize("path", list(PATHS))
def test_phases_sum_within_the_search_span(index_path, tiny_corpus, path, process_tracer):
    """With the process tracer on, each of the five phases is observed once
    a call, and their sum is no more than the call's ``engine.search``
    span."""
    _, _, queries = tiny_corpus
    tier, kw = PATHS[path]
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        eng = _engine(index_path, tier)
        try:
            _gate(eng, queries, **kw)
        finally:
            _close(eng)
    phases = {c.labels["phase"]: c for c in reg.children("search.round_seconds")}
    assert set(phases) == set(tsearch.PHASES)
    assert all(c.count == 1 and c.sum >= 0.0 for c in phases.values())
    assert phases["sync"].sum > 0.0 and phases["stage_a"].sum > 0.0
    span = reg.histogram("trace.span_seconds", span="engine.search")
    assert span.count == 1
    assert sum(c.sum for c in phases.values()) <= span.sum


def test_scored_is_the_references():
    """``search.scored`` a query (``SearchOutput.n_scored``) equals the
    plain reference's ``scored`` (``gatebench/reference.py``, float64) on
    the benchmark's own corpus, graph, codes and queries at a CPU's size;
    the registry's total is their sum."""
    sys.path.insert(0, str(REPO / "gatebench" / "tests"))
    import gatebench_tiny as tiny

    from gatebench import check

    cell = tiny.tiny_cell(tiny.GATED[0], n=800)
    dep = tiny.harness.setup(cell, 3, "cpu")
    dep.frontend.close()
    pools = np.arange(48)
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        out = dep.engine.search(dep.data["queries"][pools], filter_kind="label",
                                filter_params=dep.data["query_labels"][pools].numpy(),
                                search_config=SearchConfig(**cell.search))
    ref = check.reference_search(dep, pools)
    np.testing.assert_array_equal(out.ids.numpy(), ref["ids"])
    np.testing.assert_array_equal(out.stats.n_ios.numpy(), ref["ios"])
    np.testing.assert_array_equal(out.n_scored.numpy(), ref["scored"])
    assert int(ref["scored"].sum()) > 0
    assert reg.family_total("search.scored") == int(ref["scored"].sum())


def test_off_reads_no_clock_and_counts_nothing(index_path, tiny_corpus, monkeypatch):
    """With the tracer and the registry off, ``n_scored`` is None and the
    search calls ``time.perf_counter`` not once."""
    _, _, queries = tiny_corpus
    assert not obs.trace.default_tracer().enabled
    reg = obs.MetricsRegistry(enabled=False)
    with obs.use_registry(reg):
        eng = _engine(index_path, "memory")
    calls = [0]
    real = time.perf_counter

    def counted():
        calls[0] += 1
        return real()

    for fused in (False, True):
        monkeypatch.setattr(time, "perf_counter", counted)
        with obs.use_registry(reg):
            out = _gate(eng, queries[:4], use_fused_kernel=fused)
        monkeypatch.setattr(time, "perf_counter", real)
        assert out.n_scored is None
        assert int(out.stats.n_hops[0]) > 0
        assert calls[0] == 0, fused
    assert all(fam.get("total", 0) == 0 for fam in reg.snapshot().values())


# -------------------------------------------------------------- gc pauses
def test_gc_pause_is_observed_by_the_process_tracer_only():
    """``gc.collect()`` under the enabled process tracer adds one
    generation-2 ring entry and, at the next span, one
    ``gc.pause_seconds{generation=2}`` observation; ``disable`` leaves
    ``gc.callbacks`` as it was; enabling twice hooks once; a front end's own
    tracer hooks nothing."""
    before = list(gc.callbacks)
    own = obs.trace.Tracer(registry=obs.MetricsRegistry(enabled=True))
    own.enable()
    assert gc.callbacks == before
    tr = obs.trace.default_tracer()
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        tr.enable()
        tr.enable()
        try:
            assert len(gc.callbacks) == len(before) + 1
            gen2 = reg.histogram("gc.pause_seconds", generation="2")
            n0 = gen2.count
            gc.collect()
            with tr.span("after"):
                pass
            entries = tr.snapshot()["gc"]
        finally:
            tr.disable()
            tr.reset()
    assert gc.callbacks == before
    assert gen2.count == n0 + 1 and gen2.sum > 0.0
    assert [e["name"] for e in entries] == ["gc.pause"]
    assert entries[0]["labels"] == {"generation": "2"} and entries[0]["dur_s"] > 0.0
    assert {c.labels["span"] for c in reg.children("trace.span_seconds")} == {"after"}
    assert "gc" not in own.snapshot()


def test_gc_pauses_land_once_under_threads():
    """Threads that allocate (young collections in any of them) and record
    spans (which land the queued pauses) at a short switch interval: every
    collection the hook saw is observed exactly once or still queued."""
    tr = obs.trace.default_tracer()
    reg = obs.MetricsRegistry(enabled=True)
    stops = [0]

    def count(phase, info):
        if phase == "stop":
            stops[0] += 1

    def worker():
        for _ in range(300):
            with tr.span("w"):
                [[] for _ in range(200)]

    switch = sys.getswitchinterval()
    with obs.use_registry(reg):
        tr.enable()
    gc.callbacks.append(count)
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, daemon=True) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
        gc.disable()
        try:
            gc.callbacks.remove(count)
            landed = sum(reg.histogram("gc.pause_seconds", generation=str(g)).count
                         for g in range(3))
            queued = len(tr._gc_queue)
        finally:
            gc.enable()
    finally:
        sys.setswitchinterval(switch)
        if count in gc.callbacks:
            gc.callbacks.remove(count)
        tr.disable()
        tr.reset()
    assert stops[0] > 0
    assert landed + queued == stops[0] and landed > 0


# -------------------------------------------------------- the dispatcher
def _rag(eng):
    return RAGServer(engine=eng, cfg=None, params=None,
                     passage_tokens=np.zeros((int(eng.codes.shape[0]), 4), np.int32),
                     search_config=SearchConfig(**SEARCH), bucket_sizes=(4,))


def _tenants():
    return [TenantSpec(f"t{i}", "label", np.int32(i), max_inflight=32) for i in range(2)]


def _batch(srv, queries, rows, n_batches):
    hs = [srv.submit(f"t{i % 2}", queries[i]) for i in rows]
    for h in hs:
        h.result(timeout=WAIT_S)
    t0 = time.perf_counter()
    while srv.batches < n_batches and time.perf_counter() - t0 < WAIT_S:
        time.sleep(0.001)
    assert srv.batches == n_batches
    return hs


def _serve_spans(reg) -> dict:
    return {c.labels["span"]: c.count for c in reg.children("trace.span_seconds")
            if c.labels["span"].startswith("serve.")}


def test_dispatcher_spans_on_the_process_tracer(index_path, tiny_corpus, process_tracer):
    """One batch gives one ``serve.resolve`` span; ``serve.batch_gap`` comes
    from the second batch on; the batch's number is on its spans, on its
    ``engine.search`` span and on its requests' traces."""
    _, _, queries = tiny_corpus
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        eng = _engine(index_path, "memory")
        with ServeFrontend(_rag(eng), _tenants(), max_batch=4, batch_window_s=0.05) as srv:
            first = _batch(srv, queries, range(4), 1)
            assert _serve_spans(reg) == {"serve.resolve": 1}
            second = _batch(srv, queries, range(4, 8), 2)
            assert _serve_spans(reg) == {"serve.resolve": 2, "serve.batch_gap": 1}
    assert {h.trace.batch for h in first} == {1} and {h.trace.batch for h in second} == {2}
    ring, = [r for name, r in process_tracer.snapshot().items()
             if name.startswith("serve-dispatcher")]
    got = [(s["name"], s["labels"].get("batch")) for s in ring]
    assert got == [("engine.search", 1), ("serve.resolve", 1), ("serve.batch_gap", 2),
                   ("engine.search", 2), ("serve.resolve", 2)]
    # the front end's own ring: one entry a span a batch, not one a request
    own = [s for r in srv.tracer.snapshot().values() for s in r]
    assert len(own) == 2 * 4
    assert {(s["labels"]["batch"], s["labels"]["requests"]) for s in own} == {(1, 4), (2, 4)}


def test_dispatcher_spans_off_without_the_tracer(index_path, tiny_corpus):
    _, _, queries = tiny_corpus
    assert not obs.trace.default_tracer().enabled
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        eng = _engine(index_path, "memory")
        with ServeFrontend(_rag(eng), _tenants(), max_batch=4, batch_window_s=0.05) as srv:
            hs = _batch(srv, queries, range(4), 1)
            _batch(srv, queries, range(4, 8), 2)
    assert _serve_spans(reg) == {}
    assert {h.trace.batch for h in hs} == {1}
    assert reg.children("search.round_seconds") == []


# --------------------------------------------------- batched publication
EDGE_VALUES = [0.0, -1.0, 1e-3, 10 ** 0.25, 0.5, 1e3, 5e3, 1e-3, 7.0]


@pytest.mark.parametrize("case", ["edges", "lognormal", "counts", "repeat", "empty"])
def test_batch_observe_equals_single_observes(case):
    """``observe_many`` of an array (one value repeated, too) gives the same
    snapshot (buckets, sum, count, min, max, quantiles) as one ``observe``
    a value, on a child that already holds values too."""
    rng = np.random.default_rng(7)
    geometry = dict(lo=1e-3, hi=1e3, per_decade=4) if case == "edges" else {}
    values = {"edges": np.array(EDGE_VALUES), "empty": np.zeros(0),
              "lognormal": rng.lognormal(-5.0, 1.0, 1000),
              "counts": rng.integers(0, 60, 1024), "repeat": None}[case]
    single, batch = obs.MetricsRegistry(enabled=True), obs.MetricsRegistry(enabled=True)
    hs, hb = (r.histogram("h", **geometry) for r in (single, batch))
    for h in (hs, hb):
        h.observe(0.25)
    if case == "repeat":
        for _ in range(37):
            hs.observe(0.0123)
        hb.observe_many(np.full(37, 0.0123))
    else:
        for v in values.tolist():
            hs.observe(v)
        hb.observe_many(values)
    assert batch.snapshot() == single.snapshot()
    assert hb.quantile(0.9) == hs.quantile(0.9)
    off = obs.MetricsRegistry(enabled=False).histogram("h")
    off.observe_many(np.ones(4))
    assert off.count == 0


def test_io_report_span_means_are_the_requests(index_path, tiny_corpus):
    """The front end publishes a batch's spans at once: ``io_report``'s
    ``spans_mean_s`` over a served run is each span's mean over the
    requests' ``RequestTrace``."""
    _, _, queries = tiny_corpus
    eng = _engine(index_path, "memory")
    handles, errs = [], []

    def client(rows):
        try:
            for i in rows:
                handles.append(srv.submit(f"t{i % 2}", queries[i]))
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            errs.append(e)

    with ServeFrontend(_rag(eng), _tenants(), max_batch=4, batch_window_s=0.01) as srv:
        threads = [threading.Thread(target=client, args=(range(k, 16, 2),)) for k in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        for h in list(handles):
            h.result(timeout=WAIT_S)
    assert not errs and len(handles) == 16
    rep = srv.io_report()
    assert rep["completed"] == 16 and rep["batches"] >= 4
    for k in ("queue_wait", "batch_form", "search", "drain"):
        want = float(np.mean([getattr(h.trace, k) for h in handles]))
        assert rep["spans_mean_s"][k] == pytest.approx(want, rel=1e-9, abs=1e-12), k
