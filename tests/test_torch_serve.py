"""The port's retrieval serving (``repro_torch.serve``) against the reference's.

The contracts of ``tests/test_serve.py``, on the port, on the CPU:

  * served ids equal a direct ``engine.search`` over the tenant's
    namespace, and equal the reference ``ServeFrontend``'s served ids on
    the same index, tenants and request order;
  * tenant validation, admission timeout, ``close()`` failing queued
    requests, a contained batch failure, empty and unfiltered tenants,
    deadline shedding, the fault policy mapped onto the disk tier;
  * bucket padding reconciles against a measured disk tier under an
    adaptive cache (drift 0), with the reference's ``io_report`` counts;
  * ``retrieve`` on mixed predicate kinds and on an empty batch equals
    the reference's;
  * a small concurrent hammer on the pipelined disk tier.

Threads: every wait is bounded — each ``handle.result`` has a timeout,
every front end closes in a ``finally`` (its context manager), and
client threads are daemons joined with a timeout and then checked — so a
hang fails its own test instead of running the suite into its limit.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import GateANNEngine as JEngine  # noqa: E402
from repro.core import SearchConfig as JConfig  # noqa: E402
from repro.serve import RAGRequest as JRequest  # noqa: E402
from repro.serve import RAGServer as JRAGServer  # noqa: E402
from repro.serve import ServeFrontend as JFrontend  # noqa: E402
from repro.serve import TenantSpec as JTenant  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionError,
    DeadlineExceeded,
    RAGRequest,
    RAGServer,
    ServeFrontend,
    ServerClosed,
    TenantSpec,
)

RECORD = 4096
WAIT_S = 60.0  # the bound on any single wait in this file
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
    path = str(tmp_path_factory.mktemp("torch_serve") / "tiny.gann")
    tiny_engine.save(path)
    return path


@pytest.fixture(scope="module")
def port(index_path):
    return GateANNEngine.load(index_path, device="cpu")


def _rag(engine, *, bucket_sizes=(4,), depth=1):
    return RAGServer(
        engine=engine, cfg=None, params=None,
        passage_tokens=np.zeros((int(engine.codes.shape[0]), 4), np.int32),
        search_config=SearchConfig(**SEARCH, pipeline_depth=depth),
        bucket_sizes=bucket_sizes,
    )


def _jrag(engine, *, bucket_sizes=(4,), depth=1):
    return JRAGServer(
        engine=engine, cfg=None, params=None, layout=None,
        passage_tokens=np.zeros((int(engine.vectors.shape[0]), 4), np.int32),
        search_config=JConfig(**SEARCH, pipeline_depth=depth),
        bucket_sizes=bucket_sizes,
    )


def _tenants(n=2, max_inflight=32, spec=TenantSpec):
    return [spec(f"t{i}", "label", np.int32(i), max_inflight=max_inflight) for i in range(n)]


def _direct(engine, queries, tenant: int, k: int):
    out = engine.search(queries, filter_kind="label",
                        filter_params=np.full(queries.shape[0], tenant, np.int32),
                        search_config=SearchConfig(**SEARCH))
    return out.ids[:, :k].numpy()


def _serve(srv, queries, order):
    """Submit ``(tenant, query index)`` pairs in order; the served ids."""
    handles = [(t, qi, srv.submit(f"t{t}", queries[qi])) for t, qi in order]
    return {(t, qi): np.asarray(h.result(timeout=WAIT_S)) for t, qi, h in handles}, handles


def _in_service(srv) -> None:
    """Wait (bounded) until the dispatcher has taken every queued request."""
    t0 = time.perf_counter()
    while srv.queue_depth() and time.perf_counter() - t0 < WAIT_S:
        time.sleep(0.001)
    assert srv.queue_depth() == 0, "the dispatcher took nothing"


def _blocked(rag):
    """Make ``rag.retrieve`` wait on an event (set it to release)."""
    inner, gate = rag.retrieve, threading.Event()

    def slow_retrieve(reqs):
        gate.wait(timeout=WAIT_S)
        return inner(reqs)

    rag.retrieve = slow_retrieve
    return gate


def test_served_results_match_direct_and_reference(port, index_path, tiny_corpus):
    """Port-served ids == direct port search == the reference front end's
    served ids, request by request; traces and the report are filled."""
    _, _, queries = tiny_corpus
    order = [(i % 2, i) for i in range(8)]
    rag = _rag(port)
    with ServeFrontend(rag, _tenants(), max_batch=4, batch_window_s=0.005) as srv:
        got, handles = _serve(srv, queries, order)
        rep = srv.io_report()
    jeng = JEngine.load(index_path)
    with JFrontend(_jrag(jeng), _tenants(spec=JTenant), max_batch=4,
                   batch_window_s=0.005) as jsrv:
        want, _ = _serve(jsrv, queries, order)
    k = rag.search_config.result_k
    for tenant in (0, 1):
        qis = [qi for t, qi in order if t == tenant]
        direct = _direct(port, queries[qis], tenant, k)
        for row, qi in enumerate(qis):
            np.testing.assert_array_equal(got[(tenant, qi)], direct[row])
            np.testing.assert_array_equal(got[(tenant, qi)], want[(tenant, qi)])
    for _, _, h in handles:
        tr = h.trace
        assert h.done() and tr.batch_size >= 1
        assert tr.queue_wait >= 0 and tr.search > 0 and tr.total > 0
        assert tr.n_ios + tr.n_cache_hits > 0
    assert rep["admitted"] == rep["completed"] == 8
    assert rep["failed"] == rep["rejected"] == 0
    assert sum(t["queries"] for t in rep["per_tenant"].values()) == 8
    assert set(rep["spans_mean_s"]) == {"queue_wait", "batch_form", "search", "drain"}


def test_tenant_validation(port, tiny_corpus):
    _, _, queries = tiny_corpus
    with pytest.raises(ValueError, match="at least one TenantSpec"):
        ServeFrontend(_rag(port), [])
    with pytest.raises(ValueError, match="duplicate tenant"):
        ServeFrontend(_rag(port), [TenantSpec("a"), TenantSpec("a")])
    with pytest.raises(ValueError, match="fault_policy"):
        ServeFrontend(_rag(port), _tenants(), fault_policy="retry_forever")
    with ServeFrontend(_rag(port), _tenants()) as srv:
        with pytest.raises(KeyError, match="unknown tenant"):
            srv.submit("nope", queries[0])


def test_admission_timeout_backpressure(port, tiny_corpus):
    """max_inflight=1: while one request is in service the next submit
    blocks, then raises AdmissionError; the other tenant is untouched."""
    _, _, queries = tiny_corpus
    rag = _rag(port)
    gate = _blocked(rag)
    srv = ServeFrontend(rag, _tenants(max_inflight=1), max_batch=4, batch_window_s=0.0)
    try:
        h = srv.submit("t0", queries[0])
        t0 = time.perf_counter()
        with pytest.raises(AdmissionError, match="max_inflight"):
            srv.submit("t0", queries[1], timeout=0.05)
        assert time.perf_counter() - t0 < 5.0  # timed out, did not hang
        assert srv.rejected == 1
        h2 = srv.submit("t1", queries[2], timeout=0.05)
        gate.set()
        assert h.result(timeout=WAIT_S) is not None
        assert h2.result(timeout=WAIT_S) is not None
    finally:
        gate.set()
        srv.close()


def test_close_fails_queued_requests(port, tiny_corpus):
    _, _, queries = tiny_corpus
    rag = _rag(port)
    gate = _blocked(rag)
    srv = ServeFrontend(rag, _tenants(), max_batch=1, batch_window_s=0.0)
    closer = threading.Thread(target=srv.close, daemon=True)
    try:
        first = srv.submit("t0", queries[0])
        _in_service(srv)  # the first is in service, gated
        queued = [srv.submit("t0", queries[i]) for i in range(1, 4)]
        # close() drains the queue at once, then joins the dispatcher
        # (still gated inside the first batch's retrieve)
        closer.start()
        for h in queued:
            with pytest.raises(ServerClosed):
                h.result(timeout=WAIT_S)
        gate.set()
        closer.join(timeout=WAIT_S)
        assert not closer.is_alive()
        assert first.result(timeout=WAIT_S) is not None  # in service: completes
        with pytest.raises(ServerClosed):
            srv.submit("t0", queries[0])
    finally:
        gate.set()
        srv.close()  # idempotent


def test_batch_failure_contained(port, tiny_corpus):
    """An engine failure fails that batch's handles with the original
    exception, and the server serves the next batch."""
    _, _, queries = tiny_corpus
    rag = _rag(port)
    inner = rag.retrieve
    fail_budget = [2]  # the first two requests, however they were batched

    def flaky_retrieve(reqs):
        if fail_budget[0] > 0:
            fail_budget[0] -= len(reqs)
            raise RuntimeError("injected mid-search failure")
        return inner(reqs)

    rag.retrieve = flaky_retrieve
    with ServeFrontend(rag, _tenants(), max_batch=4, batch_window_s=0.005) as srv:
        bad = [srv.submit("t0", queries[i]) for i in range(2)]
        for h in bad:
            with pytest.raises(RuntimeError, match="injected"):
                h.result(timeout=WAIT_S)
        good = srv.submit("t0", queries[0])
        assert good.result(timeout=WAIT_S) is not None
        rep = srv.io_report()
    assert rep["failed"] == 2 and rep["completed"] == 1
    assert rep["per_tenant"]["t0"]["failed"] == 2
    assert port.abandon_pending_io() == 0  # memory tier: a callable no-op


def test_empty_and_unfiltered_tenants(port, tiny_corpus):
    """A filter-less tenant serves the whole corpus; a server with no
    traffic closes without calling the engine."""
    _, _, queries = tiny_corpus
    rag = _rag(port)
    with ServeFrontend(rag, [TenantSpec("all")], max_batch=4) as srv:
        ids = srv.submit("all", queries[0]).result(timeout=WAIT_S)
    out = port.search(queries[:1], search_config=rag.search_config)
    np.testing.assert_array_equal(ids, out.ids[0, : rag.search_config.result_k].numpy())
    quiet = _rag(port)
    with ServeFrontend(quiet, _tenants()):
        pass
    assert quiet.served_queries == 0


def test_deadline_shed_before_dispatch(port, tiny_corpus):
    """A request whose deadline passes while it waits behind a busy batch
    is shed with DeadlineExceeded and counted; the rest are served."""
    _, _, queries = tiny_corpus
    rag = _rag(port)
    gate = _blocked(rag)
    srv = ServeFrontend(rag, _tenants(), max_batch=1, batch_window_s=0.0)
    try:
        first = srv.submit("t0", queries[0])
        _in_service(srv)
        late = srv.submit("t1", queries[1], deadline_s=0.01)
        kept = srv.submit("t1", queries[2])
        time.sleep(0.05)  # the late request's deadline passes in the queue
        gate.set()
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=WAIT_S)
        assert first.result(timeout=WAIT_S) is not None
        assert kept.result(timeout=WAIT_S) is not None
        rep = srv.io_report()
    finally:
        gate.set()
        srv.close()
    assert rep["deadline_shed"] == 1 and rep["per_tenant"]["t1"]["deadline_shed"] == 1


def test_fault_policy_configures_the_disk_tier(index_path, tiny_corpus):
    _, _, queries = tiny_corpus
    eng = GateANNEngine.load(index_path, device="cpu", store_tier="disk")
    store = eng.measured_store()
    try:
        with ServeFrontend(_rag(eng), _tenants(), fault_policy="retry_then_degrade") as srv:
            assert (store.retry_policy.max_retries, store.on_error) == (3, "degrade")
            assert srv.submit("t0", queries[0]).result(timeout=WAIT_S) is not None
            assert srv.io_report()["fault_policy"] == "retry_then_degrade"
    finally:
        store.close()


def test_retrieve_mixed_kinds_and_empty_match_reference(port, tiny_engine, tiny_corpus):
    """Mixed predicate kinds in one batch scatter back to request order;
    ids, stats and the report equal the reference's.  An empty batch
    returns empty ids and stats."""
    _, _, queries = tiny_corpus
    rag, jrag = _rag(port, bucket_sizes=(4, 8)), _jrag(tiny_engine, bucket_sizes=(4, 8))
    for r in (rag, jrag):
        ids, stats = r.retrieve([])
        assert ids.shape == (0, 10) and all(int(s.shape[0]) == 0 for s in stats)
    kinds = [("label", np.int32(i % 3)) if i % 4 else (None, None) for i in range(7)]
    outs = []
    for cls, r in ((RAGRequest, rag), (JRequest, jrag)):
        reqs = [cls(query_vec=queries[i], prompt_tokens=np.arange(3, dtype=np.int32),
                    filter_kind=k, filter_params=p) for i, (k, p) in enumerate(kinds)]
        ids, stats = r.retrieve(reqs)
        outs.append((ids, stats, r.build_prompts(reqs, ids)))
    (ids, stats, prompts), (jids, jstats, jprompts) = outs
    np.testing.assert_array_equal(ids, np.asarray(jids))
    for f in jstats._fields:
        np.testing.assert_array_equal(getattr(stats, f).numpy(), np.asarray(getattr(jstats, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(prompts, jprompts)
    assert rag.io_report() == jrag.io_report()
    assert rag.padded_rows == 2 + 3  # 2 unfiltered rows pad to 4, 5 labelled to 8


def test_padding_reconciles_measured_disk_adaptive(index_path, tiny_corpus):
    """An adaptive cache above the disk tier and bucketed batches: the
    modeled served/padding split reconciles with the measured
    records_read batch after batch (drift 0), and every io_report count
    equals the reference's on the same batches."""
    _, _, queries = tiny_corpus
    knobs = dict(store_tier="disk", cache_budget_bytes=48 * RECORD, cache_policy="adaptive",
                 refresh_every=1)
    eng = GateANNEngine.load(index_path, device="cpu", **knobs)
    jeng = JEngine.load(index_path, **knobs)
    reports = []
    try:
        for r, cls in ((_rag(eng, bucket_sizes=(4, 8), depth=2), RAGRequest),
                       (_jrag(jeng, bucket_sizes=(4, 8), depth=2), JRequest)):
            # odd group sizes force padding; the hot set refreshes after
            # every batch, so padded rows move between tiers
            for batch in ([0, 1, 2], [3, 4, 5, 6, 7], [1, 2], [0, 1, 2, 3, 4]):
                r.retrieve([cls(query_vec=queries[i], prompt_tokens=np.zeros(4, np.int32),
                                filter_kind="label", filter_params=np.int32(0))
                            for i in batch])
            assert r.padded_rows > 0 and r.reconcile_drift == 0
            assert r.measured_reads == r.served_ios + r.padding_ios
            reports.append(r.io_report())
    finally:
        eng.measured_store().close()
        jeng.measured_store().close()
    got, want = reports
    assert got == want
    assert got["reconcile_drift"] == 0 and got["abandoned_tokens"] == 0


def test_concurrent_hammer_pipelined_disk(index_path, tiny_corpus):
    """Mixed-tenant client threads (more than the machine has cores, with a
    short thread switch interval) through the pipelined disk tier under an
    adaptive cache: every request served and equal to a direct search,
    drift 0, the registry's disk and search families equal the store's
    counters, and mid-flight snapshots keep unique <= records."""
    _, _, queries = tiny_corpus
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        eng = GateANNEngine.load(index_path, device="cpu", store_tier="disk",
                                 cache_budget_bytes=48 * RECORD, cache_policy="adaptive",
                                 refresh_every=2)
    store = eng.measured_store()
    rag = _rag(eng, bucket_sizes=(4, 8), depth=2)
    n_threads, per_thread = max(12, (os.cpu_count() or 1) + 2), 2
    results, errs, snaps, stop = {}, [], [], threading.Event()

    def client(srv, tid):
        try:
            for j in range(per_thread):
                tenant = (tid + j) % 2
                qi = (tid * per_thread + j) % queries.shape[0]
                h = srv.submit(f"t{tenant}", queries[qi], timeout=WAIT_S)
                results[(tid, j, tenant, qi)] = h.result(timeout=WAIT_S)
        except Exception as e:  # noqa: BLE001 — reported by the assert below
            errs.append(e)

    def sampler():
        while not stop.is_set():
            snaps.append(reg.snapshot())
            time.sleep(0.01)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads' lock sections finely
    try:
        with obs.use_registry(reg), ServeFrontend(rag, _tenants(), max_batch=8,
                                                  batch_window_s=0.002) as srv:
            threads = [threading.Thread(target=client, args=(srv, t), daemon=True)
                       for t in range(n_threads)]
            smp = threading.Thread(target=sampler, daemon=True)
            smp.start()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=2 * WAIT_S)
            stop.set()
            smp.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads + [smp]), "a client hung"
            assert not errs, errs
            rep = srv.io_report()
        assert rep["completed"] == n_threads * per_thread and rep["failed"] == 0
        assert rep["reconcile_drift"] == 0 and rep["abandoned_tokens"] == 0
        assert rag.measured_reads == rag.served_ios + rag.padding_ios
        c = store.io_counters()
        assert c["unique_sectors_read"] <= c["records_read"]
        assert snaps, "the sampler took no snapshots"
        for snap in snaps:
            got = {k: snap[k]["total"] if k in snap else 0
                   for k in ("disk.unique_sectors_read", "disk.records_read")}
            assert got["disk.unique_sectors_read"] <= got["disk.records_read"]
        for key in ("records_read", "pages_read", "unique_sectors_read", "syscalls",
                    "read_rounds"):
            assert reg.family_total(f"disk.{key}") == c[key], key
        assert reg.family_total("search.ios", tier="disk") == c["records_read"]
        assert sum(t["queries"] for t in rep["per_tenant"].values()) == rep["completed"]
        for (tid, j, tenant, qi), ids in sorted(results.items()):
            np.testing.assert_array_equal(
                ids, _direct(eng, queries[qi][None], tenant, rag.search_config.result_k)[0],
                err_msg=str((tid, j, tenant, qi)))
    finally:
        sys.setswitchinterval(switch)
        stop.set()
        store.close()


def test_serving_spans_use_the_monotonic_clock(port, tiny_corpus, monkeypatch):
    """Span math uses perf_counter: a wall clock stepping backwards
    mid-request cannot make a span negative."""
    import inspect

    from repro_torch.obs import tracer as tracer_mod
    from repro_torch.serve import server as server_mod

    for mod in (server_mod, tracer_mod):
        assert "time.time(" not in inspect.getsource(mod), mod.__name__
    t0, steps = time.time(), [0.0]

    def backwards():
        steps[0] -= 60.0
        return t0 + steps[0]

    monkeypatch.setattr(time, "time", backwards)
    _, _, queries = tiny_corpus
    with ServeFrontend(_rag(port), [TenantSpec("t0", "label", np.int32(0))], max_batch=4,
                       batch_window_s=0.0) as srv:
        hs = [srv.submit("t0", queries[i]) for i in range(4)]
        for h in hs:
            h.result(timeout=WAIT_S)
        rep = srv.io_report()
    for h in hs:
        for k in ("queue_wait", "batch_form", "search", "drain"):
            assert getattr(h.trace, k) >= 0.0, k
        assert h.trace.search > 0.0
    assert all(v >= 0.0 for v in rep["spans_mean_s"].values())
