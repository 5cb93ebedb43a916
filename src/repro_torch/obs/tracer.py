"""Span tracer: monotonic-clock stage timing with per-thread ring buffers.

Port of ``repro.obs.tracer``, line for line, plus what the port adds: one
clock with the device trace, batch records, tags and garbage-collection
pauses (below).

``with trace.span("disk.preadv", store=...):`` times one stage of the
I/O path on ``time.perf_counter()`` (monotonic, high-resolution — wall
clock steps can never corrupt a duration) and publishes it two ways:

  * a per-thread **ring buffer** of the most recent spans — the raw
    material for "what did the last few requests actually do", exported
    by ``obs.export`` (``scripts/obs_report.py`` renders the artifact).
    Rings are per-thread so the disk store's reader-pool threads, the serving
    dispatcher, and the client threads never contend on a shared list.
  * a ``trace.span_seconds{span=...}`` **histogram family** in the bound
    registry, so span percentiles ride the same export path as every
    other metric (span labels beyond the name stay in the ring only —
    histogram families need fixed, bounded label sets; ``name`` itself
    is reserved for the registry API).

Overhead budget (host time; ``chip_smoke.py`` measures a batch with
telemetry off and on, on the card):

  * **disabled** (the default): ``span()`` is one attribute read, one
    branch, and a shared no-op context manager — near-zero, safe to
    leave in the hottest host callback.
  * **enabled**: two ``perf_counter`` calls plus a ring append and one
    histogram observe per recorded span, all on the host.  The
    ``sample_rate`` knob (1-in-N per thread, deterministic) cuts it
    further for high-frequency spans.

Pre-measured durations (e.g. the serving dispatcher computes queue-wait
arithmetic itself) enter through ``trace.record(name, dur_s, ...)`` —
same ring, same histogram family, no double clocking; a batch of them
through ``record_batch`` — one batch observe, one ring entry.

**One clock with the device trace.**  ``enable()`` takes one anchor pair
``(time.time_ns(), time.perf_counter_ns())``.  Durations stay on
``perf_counter``; each ring entry's start is also given as ``start_ns`` on
the wall clock, the clock ``torch.profiler`` (kineto) stamps its events
with, so an ``--obs-json`` artifact lays beside a profiler trace.

``tagged(**labels)`` adds labels to every span a thread records inside the
block (ring only): the serving dispatcher tags its batch's spans with the
batch's number.

**Garbage-collection pauses.**  The process-default tracer (and no other)
hooks ``gc.callbacks`` while enabled: every collection is observed into
``gc.pause_seconds{generation=0|1|2}`` (not ``trace.span_seconds``), and
each generation-2 collection is also a ``gc.pause`` entry of a ring of its
own (thread ``gc``), so frequent young collections push no span out of a
thread's ring.  A collection can fire inside any allocation, a read of the
registry too, so the callback only queues its pause; the queue lands in
the histograms at the next span the tracer records (the serving
dispatcher records three a batch), and a read never sees the registry
move under it.  The pause histograms are made in the registry the tracer
writes to when ``enable()`` runs.
"""
from __future__ import annotations

import collections
import gc
import threading
import time

import numpy as np

from repro_torch.obs import registry as regm

RING_SIZE = 512  # spans kept per thread


class _NopSpan:
    """Shared do-nothing context manager — the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOP = _NopSpan()


class _Ring:
    """Fixed-capacity overwrite-oldest span buffer (single-writer)."""

    __slots__ = ("buf", "cap", "i")

    def __init__(self, cap: int):
        self.buf: list = []
        self.cap = cap
        self.i = 0

    def push(self, item) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(item)
        else:
            self.buf[self.i % self.cap] = item
        self.i += 1

    def items(self) -> list:
        if len(self.buf) < self.cap:
            return list(self.buf)
        k = self.i % self.cap
        return self.buf[k:] + self.buf[:k]


class _Tags:
    """The block of ``Tracer.tagged``: this thread's extra ring labels."""

    __slots__ = ("_tls", "labels", "prev")

    def __init__(self, tls, labels: dict):
        self._tls = tls
        self.labels = labels

    def __enter__(self):
        self.prev = getattr(self._tls, "tags", None)
        self._tls.tags = {**(self.prev or {}), **self.labels}
        return self

    def __exit__(self, *exc):
        self._tls.tags = self.prev
        return False


class _Span:
    __slots__ = ("_tracer", "name", "labels", "t0")

    def __init__(self, tracer: "Tracer", name: str, labels: dict):
        self._tracer = tracer
        self.name = name
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._commit(
            self.name, self.labels, self.t0, time.perf_counter() - self.t0
        )
        return False


class Tracer:
    """One span sink: per-thread rings + a span-seconds histogram family.

    The process-default tracer (module-level ``span``/``record``/...)
    binds to whatever the process-default registry currently is; a
    serving front end creates its own ``Tracer(registry=...)`` so its
    request spans land in its own registry regardless of global state.
    """

    def __init__(self, registry: regm.MetricsRegistry | None = None,
                 ring_size: int = RING_SIZE, *, gc_pauses: bool = False):
        self.enabled = False
        self.sample_every = 1
        self._registry = registry
        self._ring_size = ring_size
        self._rings: dict[str, _Ring] = {}
        self._rings_lock = threading.Lock()
        self._tls = threading.local()
        self._anchor = (0, 0)  # (time_ns, perf_counter_ns) at enable()
        self._gc_pauses = gc_pauses
        self._gc_hists = None  # generation -> gc.pause_seconds child, while hooked
        self._gc_ring = None
        self._gc_t0 = 0.0
        self._gc_queue = collections.deque()  # (generation, seconds) not yet observed

    def enable(self, sample_rate: float = 1.0) -> None:
        """Start recording; ``sample_rate`` keeps 1-in-round(1/rate)
        spans per thread (deterministic, counter-based — no RNG in the
        hot path).  Histogram percentiles are over the sampled spans."""
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1], got {sample_rate}")
        self.sample_every = max(1, int(round(1.0 / sample_rate)))
        self._anchor = (time.time_ns(), time.perf_counter_ns())
        if self._gc_pauses and self._gc_hists is None:
            # children and ring made here: the callback may run while its
            # thread holds the registry's or the rings' lock
            reg = self._reg()
            self._gc_hists = [reg.histogram("gc.pause_seconds", generation=str(g))
                              for g in range(3)]
            if self._gc_ring is None:
                self._gc_ring = self._new_gc_ring()
            gc.callbacks.append(self._on_gc)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False
        if self._gc_hists is not None:
            gc.callbacks.remove(self._on_gc)
            self._gc_hists = None
            self._gc_queue.clear()

    def _new_gc_ring(self) -> _Ring:
        ring = _Ring(self._ring_size)
        with self._rings_lock:
            self._rings["gc"] = ring
        return ring

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
            return
        dur = time.perf_counter() - self._gc_t0
        gen = info["generation"]
        # collections never overlap, so the gc ring has one writer at a time
        if gen == 2:
            self._gc_ring.push(("gc.pause", {"generation": "2"}, self._gc_t0, dur))
        self._gc_queue.append((gen, dur))

    def _land_gc(self) -> None:
        """Observe the queued pauses (outside any collection)."""
        hists, queue = self._gc_hists, self._gc_queue
        while hists is not None:
            try:
                gen, dur = queue.popleft()
            except IndexError:
                return
            hists[gen].observe(dur)

    def tagged(self, **labels):
        """Labels added to every span this thread records in the block
        (ring only, beside the span's own)."""
        if not self.enabled:
            return _NOP
        return _Tags(self._tls, labels)

    def _reg(self) -> regm.MetricsRegistry:
        return self._registry if self._registry is not None \
            else regm.default_registry()

    def span(self, name: str, **labels):
        if not self.enabled:
            return _NOP
        return _Span(self, name, labels)

    def record(self, name: str, duration_s: float, **labels) -> None:
        """Publish an externally measured duration as a span."""
        if not self.enabled:
            return
        self._commit(name, labels, time.perf_counter() - duration_s,
                     duration_s)

    def record_batch(self, name: str, durations, *, count: int | None = None,
                     **labels) -> None:
        """Publish a batch of externally measured durations of one span:
        ``count`` equal ones (``durations`` a number) or an array of them.
        The histogram takes them in one batch observe, exactly as one
        ``record`` each; the ring takes one entry, their mean, with
        ``requests`` (how many) in its labels."""
        if not self.enabled:
            return
        if count is not None:
            durations = np.full(count, float(durations))
        durations = np.asarray(durations, dtype=np.float64)
        n = durations.size
        ring = self._kept() if n else None
        if ring is None:
            return
        mean = float(durations.mean())
        ring.push((name, {**labels, "requests": n}, time.perf_counter() - mean, mean))
        self._reg().histogram("trace.span_seconds", span=name).observe_many(durations)

    def _kept(self) -> _Ring | None:
        """Counts one span of this thread: the thread's ring when the span
        is kept (one in ``sample_every``), else None."""
        tls = self._tls
        ring = getattr(tls, "ring", None)
        if ring is None:
            ring = tls.ring = _Ring(self._ring_size)
            tls.n = 0
            t = threading.current_thread()
            with self._rings_lock:
                self._rings[f"{t.name}-{t.ident}"] = ring
        n = tls.n
        tls.n = n + 1
        return None if n % self.sample_every else ring

    def _commit(self, name: str, labels: dict, t0: float, dur: float) -> None:
        if self._gc_queue:
            self._land_gc()
        ring = self._kept()
        if ring is None:
            return
        tags = getattr(self._tls, "tags", None)
        ring.push((name, {**tags, **labels} if tags else labels, t0, dur))
        self._reg().histogram("trace.span_seconds", span=name).observe(dur)

    def snapshot(self) -> dict:
        """``{thread: [span dicts, oldest first]}`` across all threads;
        ``start`` on ``perf_counter``, ``start_ns`` the same instant on the
        profiler's clock (through the anchor ``enable()`` took)."""
        with self._rings_lock:
            rings = list(self._rings.items())
        wall, perf = self._anchor
        return {
            tname: [
                {"name": n, "labels": dict(l), "start": t0,
                 "start_ns": wall + round(t0 * 1e9) - perf, "dur_s": d}
                for (n, l, t0, d) in ring.items()
            ]
            for tname, ring in rings
        }

    def reset(self) -> None:
        with self._rings_lock:
            self._rings.clear()
        self._tls = threading.local()
        self._gc_ring = self._new_gc_ring() if self._gc_hists is not None else None


_tracer = Tracer(gc_pauses=True)


def default_tracer() -> Tracer:
    return _tracer


def span(name: str, **labels):
    return _tracer.span(name, **labels)


def record(name: str, duration_s: float, **labels) -> None:
    _tracer.record(name, duration_s, **labels)


def enable(sample_rate: float = 1.0) -> None:
    _tracer.enable(sample_rate)


def disable() -> None:
    _tracer.disable()


def snapshot() -> dict:
    return _tracer.snapshot()


def tagged(**labels):
    return _tracer.tagged(**labels)
