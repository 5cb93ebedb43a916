"""Multi-tenant async serving front end over ``RAGServer``.

Port of ``repro.serve.server``: the same admission, batching, deadlines,
fault policies, spans and registry families.

``RAGServer`` is a library loop: the caller owns batching, there is one
implicit tenant, and a slow search blocks everyone behind it.  This
module adds the serving semantics the paper's throughput claims are
quoted under — concurrent clients, admission control, and per-request
latency you can put an SLO on:

  * **tenant namespaces** — a :class:`TenantSpec` binds a tenant name to
    a filter partition (``filter_kind`` + ``filter_params``).  A
    tenant's searches are filtered searches over its namespace, so
    isolation rides on the engine's existing filter machinery (and, with
    ``cache_policy="adaptive"``, each tenant's namespace gets its own
    cache partition via ``filter_bucket``).  No new index structures.
  * **admission control** — each tenant has a bounded in-flight budget
    (``max_inflight`` covers queued + in-service requests).  ``submit``
    blocks up to ``admission_timeout_s`` for a slot and then raises
    :class:`AdmissionError`: backpressure is explicit, never an
    unbounded queue.
  * **batch formation** — ONE dispatcher thread drains the submission
    queue, waits up to ``batch_window_s`` for stragglers, and serves up
    to ``max_batch`` requests per engine call.  Padding to canonical batch
    shapes is delegated to ``RAGServer.bucket_sizes`` — the dispatcher
    only decides batch *membership*; shape discipline stays in one
    place.  The single dispatcher is load-bearing: the engine's adaptive
    cache observe/refresh loop and the measured-counter reconciliation
    in ``RAGServer.retrieve`` are between-batch mutations, safe only
    because exactly one thread runs searches.
  * **per-request tracing** — every request carries a
    :class:`RequestTrace` with queue-wait / batch-form / search / drain
    spans (``time.perf_counter`` seconds — monotonic, never corrupted
    by wall-clock steps) and its batch's number.  A batch's request
    spans are also published into the front end's own ``obs``
    tracer/registry (``trace.span_seconds{span=serve.*}`` histograms),
    once a batch: ``batch_form`` and ``search`` as one value times the
    batch's count, ``queue_wait`` and ``drain`` as one array each, one
    ring entry a span; a request resolved alone (shed, or failed at
    close) publishes its own.  Admission outcomes / per-tenant I/O
    attribution are registry counter families — ``io_report`` is a thin
    view over the registry, layered on the underlying ``RAGServer``
    report.  Pass ``registry=`` to aggregate several front ends into one
    sink; by default each server gets a private, always-enabled registry
    so its accounting works regardless of the process-wide
    ``GATEANN_OBS`` toggle.
  * **the dispatcher's timeline** — on the process tracer (``obs.trace``,
    off unless enabled): ``serve.resolve`` from ``rag.retrieve``'s return
    to the batch's last handle resolved, ``serve.batch_gap`` from there
    to the next ``rag.retrieve`` call (the wait for arrivals, the batch
    window, shedding and the EDF sort).  With the ``engine.search`` span
    inside ``rag.retrieve`` they tile the dispatcher's time; all three
    carry the batch's number (``batch``) in the ring.

Failure containment: if the engine raises mid-batch, the dispatcher
abandons any pipelined disk rounds still in flight
(``engine.abandon_pending_io()`` — no leaked reader slots), fails that
batch's handles with the exception, and keeps serving later arrivals.

**The card from the dispatcher thread.**  Searches run on the
``serve-dispatcher`` thread, not on the thread that loaded the engine.
The kernels launch on that thread's current stream (the default stream
of the engine's device), and the disk tier's reader pool and pinned
staging serve whichever thread calls them.  A batch's results reach the
host inside ``RAGServer.retrieve``, so a handle resolves only after its
device work is done.  Containment is per batch for errors Python can
see (a failed read, a bad argument, a kernel's launch error).  A
*sticky* CUDA error (an illegal address, a device-side assert) poisons
the whole CUDA context: every later batch fails too, and no per-batch
containment can recover it — that process has to restart.

**SLO enforcement** (deadlines + shedding + degraded reads): a
``TenantSpec.deadline_s`` (or per-request ``submit(deadline_s=...)``)
gives each request an absolute deadline from admission.  Batch
formation sheds requests whose deadline already passed (resolved with
:class:`DeadlineExceeded`, counted in ``serve.deadline_shed``) and
orders the rest earliest-deadline-first instead of FIFO — serving a
request its client has already written off burns a batch slot for
nothing.  The ``fault_policy`` knob maps onto the disk tier's
resilience (``DiskRecordStore.configure_resilience``):

  * ``"fail"``              — historical behavior: one failed read
                              fails the batch (contained, not retried)
  * ``"degrade"``           — failed reads become tunneled nodes;
                              queries complete with bounded recall loss
  * ``"retry_then_degrade"``— bounded backoff retries first, degrade
                              only on exhaustion (production default)

Under non-``fail`` policies the dispatcher also propagates the batch's
tightest remaining deadline into the store as its per-round read
deadline, so one slow device round degrades instead of blowing the SLO.
Per-request degraded-slot counts land in ``RequestTrace.n_degraded``
and the ``serve.degraded`` counter family.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

from repro_torch import obs
from repro_torch.serve.rag import RAGRequest, RAGServer
from repro_torch.store.disk import RetryPolicy

# the four per-request stages; each becomes a serve.<name> span family
_SPANS = ("queue_wait", "batch_form", "search", "drain")

FAULT_POLICIES = ("fail", "degrade", "retry_then_degrade")

# shed requests get a deadline budget this small propagated as the
# store's round deadline instead of 0 (0 would DISABLE the deadline)
_MIN_ROUND_DEADLINE_S = 1e-3


class AdmissionError(RuntimeError):
    """Tenant over budget and no slot freed within the admission timeout."""


class ServerClosed(RuntimeError):
    """The request cannot be served because the server is shut down."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it could be dispatched."""


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """A tenant namespace: a name, a filter partition, and an admission
    budget.  ``filter_kind=None`` serves the whole corpus (no filter)."""

    name: str
    filter_kind: str | None = None
    filter_params: object = None
    max_inflight: int = 64  # queued + in-service requests, bounded
    # per-request SLO deadline (seconds from admission; None = none).
    # Overridable per request via submit(deadline_s=...).
    deadline_s: float | None = None


@dataclasses.dataclass
class RequestTrace:
    """Per-request span breakdown (seconds, ``time.perf_counter``).

    ``queue_wait`` = submit -> picked into a batch; ``batch_form`` =
    picked -> search dispatched (request assembly); ``search`` = engine
    call; ``drain`` = results materialized -> handle resolved.
    """

    tenant: str
    batch: int = -1  # the batch's number (its spans' ``batch`` label)
    batch_size: int = 0
    queue_wait: float = 0.0
    batch_form: float = 0.0
    search: float = 0.0
    drain: float = 0.0
    n_ios: int = 0
    n_cache_hits: int = 0
    n_degraded: int = 0  # result slots served degraded (failed disk reads)

    @property
    def total(self) -> float:
        return self.queue_wait + self.batch_form + self.search + self.drain


class ServeHandle:
    """The client's side of one submitted request."""

    def __init__(self, tenant: str):
        self.trace = RequestTrace(tenant=tenant)
        self._done = threading.Event()
        self._ids: np.ndarray | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block for the retrieved ids (raises what the server raised)."""
        if not self._done.wait(timeout):
            raise TimeoutError("request not served within timeout")
        if self._error is not None:
            raise self._error
        return self._ids


@dataclasses.dataclass
class _Pending:
    handle: ServeHandle
    request: RAGRequest
    tenant: TenantSpec
    t_submit: float
    deadline: float | None = None  # absolute perf_counter seconds (or None)


class ServeFrontend:
    """Async request-admission layer in front of a ``RAGServer``.

    Client threads call :meth:`submit` concurrently; one dispatcher
    thread forms batches and runs the engine.  ``close()`` (or the
    context manager) stops the dispatcher, fails undispatched requests
    with :class:`ServerClosed`, and abandons in-flight disk rounds.
    """

    def __init__(
        self,
        rag: RAGServer,
        tenants: list[TenantSpec] | tuple[TenantSpec, ...],
        *,
        max_batch: int = 32,
        batch_window_s: float = 0.002,
        admission_timeout_s: float = 1.0,
        fault_policy: str = "fail",
        registry: obs.MetricsRegistry | None = None,
    ):
        if not tenants:
            raise ValueError("a server needs at least one TenantSpec")
        if fault_policy not in FAULT_POLICIES:
            raise ValueError(
                f"fault_policy={fault_policy!r} not in {FAULT_POLICIES}"
            )
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self.rag = rag
        self.tenants = {t.name: t for t in tenants}
        self.max_batch = int(max_batch)
        self.batch_window_s = float(batch_window_s)
        self.admission_timeout_s = float(admission_timeout_s)
        # fault containment: map the policy onto the measured store's
        # resilience knobs (no-op on modeled tiers, which cannot fail)
        self.fault_policy = fault_policy
        self._store = rag.engine.measured_store()
        self._base_round_deadline_s = (
            self._store.round_deadline_s if self._store is not None else 0.0
        )
        if self._store is not None and fault_policy != "fail":
            retries = 3 if fault_policy == "retry_then_degrade" else 0
            self._store.configure_resilience(
                retry=RetryPolicy(max_retries=retries, backoff_s=5e-4),
                on_error="degrade",
            )

        self._lock = threading.Lock()
        self._slot_freed = threading.Condition(self._lock)
        self._work = threading.Condition(self._lock)
        self._queue: deque[_Pending] = deque()  # guarded by _lock
        self._inflight = {t.name: 0 for t in tenants}  # guarded by _lock
        self._closed = False  # guarded by _lock
        # admission/outcome counters and span histograms live in the
        # registry (``io_report`` is a thin view over it); children are
        # created eagerly so zero-traffic tenants still report
        self.metrics = registry if registry is not None \
            else obs.MetricsRegistry(enabled=True)
        self.tracer = obs.trace.Tracer(registry=self.metrics)
        self.tracer.enable()
        self._counters = {
            key: {t.name: self.metrics.counter(f"serve.{key}", tenant=t.name)
                  for t in tenants}
            for key in ("admitted", "rejected", "completed", "failed",
                        "queries", "ios", "cache_hits",
                        "deadline_shed", "degraded")
        }
        self._c_batches = self.metrics.counter("serve.batches")
        self._g_queue = self.metrics.gauge("serve.queue_depth")
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="serve-dispatcher", daemon=True
        )
        self._dispatcher.start()

    # -- registry views (kept as attributes-in-spirit: tests and callers
    # read e.g. ``srv.rejected`` as a plain int) ---------------------------
    @property
    def admitted(self) -> int:
        return int(self.metrics.family_total("serve.admitted"))

    @property
    def rejected(self) -> int:
        return int(self.metrics.family_total("serve.rejected"))

    @property
    def completed(self) -> int:
        return int(self.metrics.family_total("serve.completed"))

    @property
    def failed(self) -> int:
        return int(self.metrics.family_total("serve.failed"))

    @property
    def batches(self) -> int:
        return int(self._c_batches.value)

    # -- client side -------------------------------------------------------
    def submit(
        self,
        tenant: str,
        query_vec: np.ndarray,
        *,
        prompt_tokens: np.ndarray | None = None,
        timeout: float | None = None,
        deadline_s: float | None = None,
    ) -> ServeHandle:
        """Admit one request into ``tenant``'s namespace.

        Blocks while the tenant is at ``max_inflight`` until a slot
        frees, up to ``timeout`` (default ``admission_timeout_s``), then
        raises :class:`AdmissionError`.  Thread-safe.

        ``deadline_s`` (default: the tenant's ``deadline_s``) starts the
        request's SLO clock at admission: a request still queued when it
        expires is shed with :class:`DeadlineExceeded` instead of served
        late, and queued requests dispatch earliest-deadline-first.
        """
        spec = self.tenants.get(tenant)
        if spec is None:
            raise KeyError(f"unknown tenant {tenant!r}; have {sorted(self.tenants)}")
        if timeout is None:
            timeout = self.admission_timeout_s
        deadline = time.perf_counter() + timeout
        with self._lock:
            while not self._closed and self._inflight[tenant] >= spec.max_inflight:
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or not self._slot_freed.wait(remaining):
                    self._counters["rejected"][tenant].inc()
                    raise AdmissionError(
                        f"tenant {tenant!r} at max_inflight="
                        f"{spec.max_inflight} for {timeout:.3f}s"
                    )
            if self._closed:
                raise ServerClosed("server is closed")
            handle = ServeHandle(tenant)
            req = RAGRequest(
                query_vec=np.asarray(query_vec),
                prompt_tokens=(
                    np.zeros((0,), np.int32) if prompt_tokens is None
                    else np.asarray(prompt_tokens, np.int32)
                ),
                filter_kind=spec.filter_kind,
                filter_params=spec.filter_params,
            )
            self._inflight[tenant] += 1
            self._counters["admitted"][tenant].inc()
            now = time.perf_counter()
            dl = deadline_s if deadline_s is not None else spec.deadline_s
            self._queue.append(_Pending(
                handle, req, spec, now,
                deadline=None if dl is None else now + float(dl),
            ))
            self._g_queue.set(len(self._queue))
            self._work.notify()
        return handle

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- dispatcher side ---------------------------------------------------
    def _take_batch(self) -> list[_Pending] | None:
        """Block for work; once some arrives, hold the batch open for
        ``batch_window_s`` (or until full), then form the batch with the
        SLO in charge instead of arrival order:

          1. **shed** requests whose deadline already passed — they are
             resolved with :class:`DeadlineExceeded` (counted in
             ``serve.deadline_shed``); serving them would spend a batch
             slot on an answer the client has stopped waiting for;
          2. take the rest **earliest-deadline-first** (undeadlined
             requests sort last; FIFO breaks ties, so a deadline-free
             workload keeps the historical order exactly).

        Returns None when the server closes."""
        shed: list[_Pending] = []
        with self._lock:
            while not self._queue and not self._closed:
                self._work.wait()
            if not self._queue:  # closed and drained
                return None
            if self.batch_window_s > 0 and len(self._queue) < self.max_batch:
                self._work.wait(self.batch_window_s)
            now = time.perf_counter()
            live = []
            for p in self._queue:
                if p.deadline is not None and now >= p.deadline:
                    shed.append(p)
                else:
                    live.append(p)
            order = sorted(
                range(len(live)),
                key=lambda i: (
                    live[i].deadline if live[i].deadline is not None
                    else float("inf"),
                    i,
                ),
            )
            taken = set(order[: self.max_batch])
            batch = [live[i] for i in order[: self.max_batch]]
            self._queue = deque(
                live[i] for i in range(len(live)) if i not in taken
            )
            self._g_queue.set(len(self._queue))
        for p in shed:  # resolve outside the lock (_resolve re-takes it)
            self._counters["deadline_shed"][p.tenant.name].inc()
            self._resolve(
                p, None,
                DeadlineExceeded(
                    f"deadline passed before dispatch "
                    f"(tenant {p.tenant.name!r})"
                ),
                time.perf_counter(),
            )
        if not batch:
            # close() drained the queue between wakeup and pop, or every
            # queued request was shed
            with self._lock:
                closed = self._closed
            return None if closed else []
        return batch

    def _resolve(self, p: _Pending, ids, err, t_searched: float,
                 publish: bool = True) -> float:
        """Hand ``p`` its answer; its drain span.  ``publish``: its four
        spans go to the front end's tracer now (a batch's go once, after
        its last handle)."""
        p.handle._ids = ids
        p.handle._error = err
        drain = p.handle.trace.drain = time.perf_counter() - t_searched
        p.handle._done.set()
        name = p.tenant.name
        outcome = "completed" if err is None else "failed"
        self._counters[outcome][name].inc()
        # percentiles and means come out of the
        # trace.span_seconds{span=serve.*} histograms
        if publish:
            for k in _SPANS:
                self.tracer.record(f"serve.{k}", getattr(p.handle.trace, k),
                                   tenant=name)
        with self._lock:
            self._inflight[name] -= 1
            self._slot_freed.notify_all()
        return drain

    def _publish(self, batch: list[_Pending], seq: int, drains: list) -> None:
        """A batch's four request spans, as ``_resolve`` would publish them
        one request at a time: one batch observe a span, one ring entry."""
        tr, n, t = self.tracer, len(batch), batch[0].handle.trace
        tr.record_batch("serve.queue_wait", [p.handle.trace.queue_wait for p in batch],
                        batch=seq)
        tr.record_batch("serve.batch_form", t.batch_form, count=n, batch=seq)
        tr.record_batch("serve.search", t.search, count=n, batch=seq)
        tr.record_batch("serve.drain", drains, batch=seq)

    def _dispatch_loop(self) -> None:
        tracer = obs.trace.default_tracer()
        seq = 0
        t_resolved = None  # the last batch's last handle resolved
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            if not batch:  # spurious wakeup, nothing to serve
                continue
            seq += 1
            t_formed = time.perf_counter()
            for p in batch:
                p.handle.trace.queue_wait = t_formed - p.t_submit
                p.handle.trace.batch = seq
                p.handle.trace.batch_size = len(batch)
            requests = [p.request for p in batch]
            t_dispatch = time.perf_counter()
            for p in batch:
                p.handle.trace.batch_form = t_dispatch - t_formed
            # SLO propagation: under a degrading policy, give the store
            # the batch's tightest remaining deadline as its per-round
            # read budget — a slow device round then degrades the
            # affected slots instead of stalling the whole batch past
            # its deadline.  (Floored at _MIN_ROUND_DEADLINE_S: zero
            # would disable the deadline entirely.)
            budget_set = False
            if self._store is not None and self.fault_policy != "fail":
                dls = [p.deadline for p in batch if p.deadline is not None]
                if dls:
                    remaining = min(dls) - t_dispatch
                    self._store.configure_resilience(
                        round_deadline_s=max(remaining, _MIN_ROUND_DEADLINE_S)
                    )
                    budget_set = True
            traced = tracer.enabled
            if traced and t_resolved is not None:
                tracer.record("serve.batch_gap", time.perf_counter() - t_resolved, batch=seq)
            try:
                with tracer.tagged(batch=seq):
                    ids, stats = self.rag.retrieve(requests)
                err = None
            except BaseException as e:  # noqa: BLE001 — failures are per-batch
                # a mid-search failure may strand a pipelined disk round
                # in flight; abandon it so the reader pool stays usable
                # for the next batch (engine.search also abandons on its
                # own failures — this covers retrieve-level ones too)
                self.rag.engine.abandon_pending_io()
                ids = stats = None
                err = e
            finally:
                if budget_set:  # restore the store-level default
                    self._store.configure_resilience(
                        round_deadline_s=self._base_round_deadline_s
                    )
            t_searched = time.perf_counter()
            # retrieve hands back host stats: no copy and no sync here
            n_ios = stats.n_ios.tolist() if err is None else None
            n_hits = stats.n_cache_hits.tolist() if err is None else None
            n_deg = stats.n_degraded.tolist() if err is None else None
            drains = []
            for i, p in enumerate(batch):
                p.handle.trace.search = t_searched - t_dispatch
                name = p.tenant.name
                self._counters["queries"][name].inc()
                if err is None:
                    p.handle.trace.n_ios = n_ios[i]
                    p.handle.trace.n_cache_hits = n_hits[i]
                    p.handle.trace.n_degraded = n_deg[i]
                    self._counters["ios"][name].inc(n_ios[i])
                    self._counters["cache_hits"][name].inc(n_hits[i])
                    if n_deg[i]:
                        self._counters["degraded"][name].inc(n_deg[i])
                    drains.append(self._resolve(p, ids[i], None, t_searched, publish=False))
                else:
                    drains.append(self._resolve(p, None, err, t_searched, publish=False))
            t_resolved = time.perf_counter()
            if traced:
                tracer.record("serve.resolve", t_resolved - t_searched, batch=seq)
            self._publish(batch, seq, drains)
            self._c_batches.inc()

    # -- reporting / lifecycle ---------------------------------------------
    def io_report(self) -> dict:
        """The ``RAGServer`` report plus serving-layer aggregates:
        admission outcomes, mean span breakdown, per-tenant attribution.

        A thin view over the front end's registry — every value here is
        a family total or histogram mean; nothing is aggregated outside
        ``self.metrics``."""
        rep = self.rag.io_report()
        total = self.metrics.family_total
        done = self.completed + self.failed
        spans = {}
        for k in _SPANS:
            children = [
                c for c in self.metrics.children("trace.span_seconds")
                if c.labels.get("span") == f"serve.{k}"
            ]
            s = sum(c.sum for c in children)
            n = sum(c.count for c in children)
            spans[k] = s / max(n, 1)
        rep.update(
            tenants=sorted(self.tenants),
            admitted=self.admitted,
            rejected=self.rejected,
            completed=self.completed,
            failed=self.failed,
            batches=self.batches,
            queue_depth=self.queue_depth(),
            mean_batch_size=done / max(self.batches, 1),
            spans_mean_s=spans,
            fault_policy=self.fault_policy,
            deadline_shed=int(total("serve.deadline_shed")),
            degraded=int(total("serve.degraded")),
            per_tenant={
                name: {
                    "queries": int(total("serve.queries", tenant=name)),
                    "ios": int(total("serve.ios", tenant=name)),
                    "cache_hits": int(total("serve.cache_hits", tenant=name)),
                    "failed": int(total("serve.failed", tenant=name)),
                    "deadline_shed": int(
                        total("serve.deadline_shed", tenant=name)
                    ),
                    "degraded": int(total("serve.degraded", tenant=name)),
                }
                for name in self.tenants
            },
        )
        return rep

    def close(self) -> None:
        """Stop serving: fail queued requests, join the dispatcher,
        abandon any in-flight disk rounds.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            orphans = list(self._queue)
            self._queue.clear()
            self._work.notify_all()
            self._slot_freed.notify_all()
        for p in orphans:
            self._resolve(p, None, ServerClosed("server closed"),
                          time.perf_counter())
        self._dispatcher.join(timeout=30.0)
        self.rag.engine.abandon_pending_io()

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
