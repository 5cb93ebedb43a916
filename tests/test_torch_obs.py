"""The port's telemetry (``repro_torch.obs``) against the reference's ``repro.obs``.

Each case gives both packages the same inputs and holds the port to the
reference's output exactly:

  * registry, histograms, tracer, exporters: the same sequence of
    counter, gauge, histogram and span calls gives equal ``snapshot()``
    dicts, quantiles and ``to_prometheus()`` text; disabled registries
    record nothing, the ring overwrites its oldest entry, sampling keeps
    one in N;
  * ``stats_totals`` / ``record_search_stats`` on tensor stats equal the
    reference's on the same numbers as numpy arrays;
  * the disk tier: the port's registry == ``io_counters()`` == Σ
    ``n_ios``, and the families stay monotonic across
    ``reset_io_counters()``;
  * one gate search over one index file written by ``GateANNEngine.save``
    — disk tier, depths 1 and 2, uncached and adaptive — gives equal
    family totals in both packages (``search.*`` less the reference's
    ``search.traces``, which the port drops: it has no jit trace to
    count; ``disk.*``; ``cache.*``), and equal span counts;
  * with telemetry off the stats hook is unreachable.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import GateANNEngine as JEngine  # noqa: E402
from repro.core import SearchConfig as JConfig  # noqa: E402
from repro.store import FaultPlan as JPlan  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.store import FaultPlan  # noqa: E402

RECORD = 4096
SEARCH = dict(mode="gate", search_l=32, beam_width=4)


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
    path = str(tmp_path_factory.mktemp("torch_obs") / "tiny.gann")
    tiny_engine.save(path)
    return path


def _pair():
    return obs.MetricsRegistry(enabled=True), jobs.MetricsRegistry(enabled=True)


# ------------------------------------------------- registry, tracer, export
def _drive(pkg, reg, case: str):
    """One fixed sequence of registry (and span) calls through ``pkg``."""
    rng = np.random.default_rng(0)
    if case == "counters":
        reg.counter("req.total", tenant="a").inc()
        reg.counter("req.total", tenant="a").inc(2)
        reg.counter("req.total", tenant="b").inc(5)
        reg.counter("disk.records_read", store="x.gann").inc(42)
        reg.counter("bytes").inc(1.5)
    elif case == "gauges":
        g = reg.gauge("depth")
        g.set(4)
        g.inc()
        g.dec(2)
        reg.gauge("disk.inflight_depth", store="x.gann").set(3)
    elif case == "histograms":
        h = reg.histogram("lat")
        for v in rng.lognormal(mean=-5.0, sigma=1.0, size=2_000):
            h.observe(v)
        edges = reg.histogram("edges", lo=1e-3, hi=1e3, per_decade=4)
        for v in (0.0, -1.0, 1e-3, 0.5, 1e3, 5e3):  # underflow, edges, overflow
            edges.observe(v)
        for v in rng.integers(0, 60, size=300).tolist():  # per-query counts
            reg.histogram("search.ios_per_query", mode="gate").observe(v)
    elif case == "spans":
        tr = pkg.trace.Tracer(registry=reg)
        tr.enable()
        for i, d in enumerate((1e-4, 2e-4, 5e-3, 0.25)):
            tr.record(f"stage.{i % 2}", d, k="v")
        return tr
    return None


@pytest.mark.parametrize("case", ["counters", "gauges", "histograms", "spans"])
def test_registry_and_exports_match_reference(case):
    """Snapshots, quantiles, family totals and the Prometheus text of the
    same call sequence are equal in both packages."""
    reg, jreg = _pair()
    tr = _drive(obs, reg, case)
    jtr = _drive(jobs, jreg, case)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.families() == jreg.families()
    for name in reg.families():
        kind = reg.snapshot()[name]["kind"]
        if kind == "histogram":
            for c, jc in zip(reg.children(name), jreg.children(name)):
                for q in (0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
                    assert c.quantile(q) == jc.quantile(q), (name, q)
                assert (c.count, c.sum, c.mean) == (jc.count, jc.sum, jc.mean)
        else:
            assert reg.family_total(name) == jreg.family_total(name)
    text = obs.export.to_prometheus(reg)
    assert text == jobs.export.to_prometheus(jreg)
    # a scrape and its JSON artifact agree, across packages too
    doc = obs.export.to_json(reg, tr or obs.trace.Tracer())
    jdoc = jobs.export.to_json(jreg, jtr or jobs.trace.Tracer())
    assert doc["schema_version"] == jdoc["schema_version"]
    assert doc["families"] == jdoc["families"]
    assert obs.export.to_prometheus(doc) == text == jobs.export.to_prometheus(doc)
    spans = [(s["name"], s["labels"], s["dur_s"]) for ring in doc["spans"].values() for s in ring]
    jspans = [(s["name"], s["labels"], s["dur_s"]) for ring in jdoc["spans"].values() for s in ring]
    assert spans == jspans


def test_registry_rejects_what_the_reference_rejects():
    for pkg in (obs, jobs):
        reg = pkg.MetricsRegistry(enabled=True)
        reg.counter("req.total", tenant="a").inc()
        with pytest.raises(TypeError, match="is a counter"):
            reg.gauge("req.total", tenant="a")
        with pytest.raises(ValueError, match="has labels"):
            reg.counter("req.total", shard="0")
        with pytest.raises(TypeError):
            reg.counter("x", name="y")  # `name` is the family-name parameter


def test_disabled_registry_records_nothing():
    reg = obs.MetricsRegistry(enabled=False)
    c, g, h = reg.counter("n"), reg.gauge("g"), reg.histogram("h")
    c.inc(100)
    g.set(3)
    h.observe(1.0)
    assert (c.value, g.value, h.count) == (0, 0.0, 0)
    reg.enable()
    c.inc(1)
    assert c.value == 1
    reg.disable()
    c.inc(1)
    assert c.value == 1
    tr = obs.trace.Tracer(registry=reg)
    assert tr.span("x") is obs.trace._NOP  # disabled tracer: the shared no-op


def test_ring_overwrites_oldest():
    names = []
    for pkg in (obs, jobs):
        tr = pkg.trace.Tracer(ring_size=4)
        tr.enable()
        for i in range(10):
            tr.record(f"s{i}", 0.0)
        names.append([s["name"] for ring in tr.snapshot().values() for s in ring])
    assert names[0] == names[1] == ["s6", "s7", "s8", "s9"]


def test_sampling_keeps_one_in_n():
    reg = obs.MetricsRegistry(enabled=True)
    tr = obs.trace.Tracer(registry=reg)
    tr.enable(sample_rate=0.25)
    for _ in range(100):
        with tr.span("s"):
            pass
    assert reg.histogram("trace.span_seconds", span="s").count == 25
    with pytest.raises(ValueError, match="sample_rate"):
        tr.enable(sample_rate=0.0)


def test_write_obs_json_sections(tmp_path):
    reg = obs.MetricsRegistry(enabled=True)
    reg.counter("serve.admitted", tenant="t0").inc(5)
    path = tmp_path / "obs.json"
    payload = obs.export.write_obs_json(str(path), sections={"serve": (reg, obs.trace.Tracer())})
    on_disk = json.loads(path.read_text())
    assert on_disk == json.loads(json.dumps(payload))
    assert on_disk["serve"]["families"]["serve.admitted"]["total"] == 5
    assert "process" in on_disk


def test_use_registry_swaps_and_restores():
    prev = obs.default_registry()
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg) as got:
        assert got is reg and obs.default_registry() is reg
    assert obs.default_registry() is prev


class _ReadThenInterleave:
    """A counter child whose read (by ``snapshot``) gives ``writer`` a
    window of 0.5 s to run in another thread before the snapshot moves on
    to the next family."""

    def __init__(self, inner, writer):
        self.inner, self.writer, self.threads = inner, writer, []

    @property
    def labels(self):
        return self.inner.labels

    @property
    def value(self):
        v = self.inner.value
        t = threading.Thread(target=self.writer, daemon=True)
        t.start()
        t.join(timeout=0.5)
        self.threads.append(t)
        return v


def test_a_disk_read_lands_in_a_snapshot_whole():
    """``snapshot`` reads the families one by one, ``disk.records_read``
    before ``disk.unique_sectors_read``; a disk read's increments made
    between those two reads would show unique above records.  The store
    makes its increments as one ``atomic`` group, which a snapshot holds
    off: here a read lands (in another thread) right after the snapshot
    read ``disk.records_read``, and the snapshot still shows unique <=
    records (the mid-flight invariant of the serve hammer test)."""
    from types import SimpleNamespace

    from repro_torch.store.disk import DiskRecordStore

    reg = obs.MetricsRegistry(enabled=True)
    names = ("records_read", "pages_read", "bytes_read", "unique_sectors_read", "ranges_read",
             "syscalls", "gap_sectors_read", "fetch_rounds", "read_rounds")
    store = SimpleNamespace(_obs=reg, pages_per_record=1, sector_bytes=4096,
                            _obs_counters={n: reg.counter(f"disk.{n}", store="s") for n in names})
    io = {"ranges": 1, "syscalls": 1, "gap_sectors": 0, "retried_ios": 0, "retry_exhausted": 0,
          "deadline_trips": 0}
    DiskRecordStore._obs_read(store, 4, 4, io, 0)  # records == unique == 4
    fam = reg._families["disk.records_read"]
    (key, child), = fam.children.items()
    hook = _ReadThenInterleave(child, lambda: DiskRecordStore._obs_read(store, 3, 3, io, 0))
    fam.children[key] = hook
    snap = reg.snapshot()
    fam.children[key] = child
    for t in hook.threads:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in hook.threads)
    got = {k: snap[f"disk.{k}"]["total"] for k in ("records_read", "unique_sectors_read")}
    assert got == {"records_read": 4, "unique_sectors_read": 4}, got
    assert reg.family_total("disk.records_read") == reg.family_total("disk.unique_sectors_read") == 7


# ------------------------------------------------------------------- stats
@pytest.mark.parametrize("b", [0, 1, 37])
def test_record_search_stats_matches_reference(b):
    """Tensor stats into the port's registry == the same numbers as numpy
    arrays into the reference's, and the same totals."""
    rng = np.random.default_rng(b)
    cols = {f: rng.integers(0, 50, size=b).astype(np.int32) for f in tsearch.SearchStats._fields}
    cols["n_degraded"][rng.random(b) < 0.7] = 0
    tstats = tsearch.SearchStats(**{f: torch.from_numpy(v) for f, v in cols.items()})
    from repro.core.search import SearchStats as JStats

    jstats = JStats(**cols)
    reg, jreg = _pair()
    got = obs.stats.record_search_stats(reg, tstats, mode="gate", tier="disk")
    want = jobs.stats.record_search_stats(jreg, jstats, mode="gate", tier="disk")
    assert got == want == obs.stats.stats_totals(tstats)
    assert reg.snapshot() == jreg.snapshot()
    assert obs.stats.tier_mix(queries=b, ios=got["n_ios"], cache_hits=got["n_cache_hits"],
                              tunnels=got["n_tunnels"]) == \
        jobs.stats.tier_mix(queries=b, ios=want["n_ios"], cache_hits=want["n_cache_hits"],
                            tunnels=want["n_tunnels"])


# ---------------------------------------------------------------- disk tier
def _gate(eng, queries, cfg_cls, **kw):
    n = queries.shape[0]
    return eng.search(queries, filter_kind="label",
                      filter_params=np.arange(n, dtype=np.int32) % 10,
                      search_config=cfg_cls(**SEARCH, **kw))


@pytest.mark.parametrize("depth", [1, 2])
def test_disk_search_reconciles_registry(index_path, tiny_corpus, depth):
    """registry == measured store counters == Σ n_ios, and the families
    stay monotonic across a store reset."""
    _, _, queries = tiny_corpus
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        eng = GateANNEngine.load(index_path, device="cpu", store_tier="disk")
        out = _gate(eng, queries, SearchConfig, pipeline_depth=depth)
    store = eng.measured_store()
    try:
        ios = int(out.stats.n_ios.sum())
        c = store.io_counters()
        assert reg.family_total("disk.records_read") == c["records_read"] == ios
        for key in ("pages_read", "bytes_read", "unique_sectors_read", "ranges_read",
                    "syscalls", "gap_sectors_read", "fetch_rounds", "read_rounds",
                    "overlapped_rounds", "abandoned_tokens"):
            assert reg.family_total(f"disk.{key}") == c[key], key
        assert reg.family_total("search.ios", tier="disk", mode="gate") == ios
        assert reg.family_total("search.queries") == queries.shape[0]
        assert reg.family_total("search.dispatch", pipelined=str(int(depth > 1))) == 1
        if depth > 1:
            assert reg.family_total("disk.submits") == reg.family_total("disk.drains") > 0
            assert reg.family_total("disk.inflight_depth") == 0
        h = reg.histogram("search.ios_per_query", mode="gate")
        assert (h.count, h.sum) == (queries.shape[0], float(ios))
        store.reset_io_counters()
        assert store.io_counters()["records_read"] == 0
        assert reg.family_total("disk.records_read") == ios
        _gate(eng, queries, SearchConfig, pipeline_depth=depth)
        assert reg.family_total("disk.records_read") == 2 * ios
        assert store.io_counters()["records_read"] == ios
    finally:
        store.close()


def _families(reg) -> dict:
    snap = reg.snapshot()
    snap.pop("search.traces", None)  # the reference's, per jit trace: none in the port
    for fam in snap.values():
        for child in fam["children"]:
            if "value" in child:
                child["value"] = float(child["value"])
        if "total" in fam:
            fam["total"] = float(fam["total"])
    return snap


@pytest.mark.parametrize("cached", [False, True], ids=["uncached", "adaptive"])
@pytest.mark.parametrize("depth", [1, 2])
def test_family_totals_match_reference(index_path, tiny_corpus, depth, cached):
    """Both packages load one index file on the disk tier and run the same
    gate batches: every registry family (search.*, disk.*, cache.*) is
    equal, children, totals and histograms."""
    _, _, queries = tiny_corpus
    knobs = dict(store_tier="disk")
    if cached:
        knobs.update(cache_budget_bytes=48 * RECORD, cache_policy="adaptive", refresh_every=1)
    reg, jreg = _pair()
    with obs.use_registry(reg):
        eng = GateANNEngine.load(index_path, device="cpu", **knobs)
        for s in (slice(0, 8), slice(8, 16)):
            _gate(eng, queries[s], SearchConfig, pipeline_depth=depth)
    with jobs.use_registry(jreg):
        jeng = JEngine.load(index_path, **knobs)
        for s in (slice(0, 8), slice(8, 16)):
            out = _gate(jeng, queries[s], JConfig, pipeline_depth=depth)
            np.asarray(out.stats.n_ios)
    try:
        got, want = _families(reg), _families(jreg)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name] == want[name], name
        assert got["disk.records_read"]["total"] == got["search.ios"]["total"] > 0
        if cached:
            assert got["cache.refreshes"]["total"] >= 1
    finally:
        eng.measured_store().close()
        jeng.measured_store().close()


@pytest.mark.parametrize("depth", [1, 2])
def test_span_counts_match_reference(index_path, tiny_corpus, depth):
    """With the process tracer on, a disk search records the same spans,
    as many of each, in both packages: engine.search, disk.preadv, and at
    depth 2 disk.submit and disk.drain_wait; a retried read records
    disk.retry."""
    _, _, queries = tiny_corpus
    plan = dict(seed=3, schedule=((2, "eio"), (5, "eio"))) if depth == 1 else None
    counts = []
    for pkg, eng_cls, cfg_cls, plan_cls, kw in (
            (obs, GateANNEngine, SearchConfig, FaultPlan, dict(device="cpu")),
            (jobs, JEngine, JConfig, JPlan, {})):
        reg = pkg.MetricsRegistry(enabled=True)
        tracer = pkg.trace.default_tracer()
        with pkg.use_registry(reg):
            eng = eng_cls.load(index_path, store_tier="disk", io_retries=2,
                               faults=plan_cls(**plan) if plan else None, **kw)
            tracer.enable()
            try:
                out = _gate(eng, queries, cfg_cls, pipeline_depth=depth)
                np.asarray(out.stats.n_ios)
            finally:
                tracer.disable()
                tracer.reset()
        eng.measured_store().close()
        counts.append({c.labels["span"]: c.count for c in reg.children("trace.span_seconds")})
    got, want = counts
    assert got == want
    expect = {"engine.search", "disk.preadv"}
    expect |= {"disk.retry"} if depth == 1 else {"disk.submit", "disk.drain_wait"}
    assert expect <= set(got) and got["engine.search"] == 1


# --------------------------------------------------------------- overhead
def test_disabled_telemetry_is_structurally_off(index_path, tiny_corpus, monkeypatch):
    """With the registry disabled the stats hook is unreachable (the only
    place telemetry copies a batch's stats to the host), and no family
    counts anything."""
    def boom(*a, **k):  # pragma: no cover - reaching it is the failure
        raise AssertionError("record_search_stats ran with obs disabled")

    monkeypatch.setattr(obs.stats, "record_search_stats", boom)
    _, _, queries = tiny_corpus
    reg = obs.MetricsRegistry(enabled=False)
    with obs.use_registry(reg):
        eng = GateANNEngine.load(index_path, device="cpu", store_tier="disk")
        out = _gate(eng, queries[:4], SearchConfig, pipeline_depth=2)
    eng.measured_store().close()
    assert out.ids.shape[0] == 4
    assert all(fam.get("total", 0) == 0 for fam in reg.snapshot().values())
    assert reg.family_total("search.dispatch") == 0
    assert obs.trace.span("x") is obs.trace._NOP  # the process tracer is off by default
