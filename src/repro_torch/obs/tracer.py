"""Span tracer: monotonic-clock stage timing with per-thread ring buffers.

Port of ``repro.obs.tracer``, line for line.

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
same ring, same histogram family, no double clocking.
"""
from __future__ import annotations

import threading
import time

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
                 ring_size: int = RING_SIZE):
        self.enabled = False
        self.sample_every = 1
        self._registry = registry
        self._ring_size = ring_size
        self._rings: dict[str, _Ring] = {}
        self._rings_lock = threading.Lock()
        self._tls = threading.local()

    def enable(self, sample_rate: float = 1.0) -> None:
        """Start recording; ``sample_rate`` keeps 1-in-round(1/rate)
        spans per thread (deterministic, counter-based — no RNG in the
        hot path).  Histogram percentiles are over the sampled spans."""
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1], got {sample_rate}")
        self.sample_every = max(1, int(round(1.0 / sample_rate)))
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

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

    def _commit(self, name: str, labels: dict, t0: float, dur: float) -> None:
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
        if n % self.sample_every:
            return
        ring.push((name, labels, t0, dur))
        self._reg().histogram("trace.span_seconds", span=name).observe(dur)

    def snapshot(self) -> dict:
        """``{thread: [span dicts, oldest first]}`` across all threads."""
        with self._rings_lock:
            rings = list(self._rings.items())
        return {
            tname: [
                {"name": n, "labels": dict(l), "start": t0, "dur_s": d}
                for (n, l, t0, d) in ring.items()
            ]
            for tname, ring in rings
        }

    def reset(self) -> None:
        with self._rings_lock:
            self._rings.clear()
        self._tls = threading.local()


_tracer = Tracer()


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
