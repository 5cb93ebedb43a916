"""Deterministic, seedable fault injection for the disk read path.

The port's own copy of ``repro.store.faults`` (numpy only, the same
plans and the same decisions): a scripted ``schedule`` injects the
same faults into both packages' disk tiers.

A :class:`FaultPlan` describes *what the SSD does wrong* — transient
``EIO`` / ``EAGAIN`` errors, short reads, injected latency — either as
per-call probabilities or as a scripted schedule of (call_index, kind)
pairs.  :class:`FaultInjector` (one per opened store) turns the plan
into the three fd-read entry points ``DiskRecordStore`` actually
issues:

  * ``preadv(fd, views, offset)``  — the coalesced vectored read
  * ``pread(fd, n, offset)``       — the per-range fallback
  * ``gather(fn)``                 — the memmap oracle's fancy-gather

so every io_mode AND the async ``submit``/``drain`` reader pool (whose
workers call the same ``_host_fetch``) flow through one choke point.
Nothing else in the store changes: with an all-zero plan the wrapper
calls straight through to ``os.preadv``/``os.pread`` and search results
are bit-identical to an uninjected store.

Determinism: fault decisions are a pure function of ``(plan.seed,
call_index)`` — each read call draws its own ``np.random.default_rng``
stream, so the decision for call #17 is the same no matter how calls
interleave across reader threads.  The *set* of faulted calls is stable
under concurrency; which logical round a given call index lands on can
shift with thread scheduling, which is why tier-1 tests use scripted
``schedule`` entries against single-threaded (depth-1) reads and leave
the probabilistic sweeps to the nightly chaos matrix.

Short reads are injected *honestly*: the injector issues a real
``os.preadv``/``os.pread`` truncated to ``short_frac`` of the wanted
bytes, so the resume loops in ``_preadv_full``/``_pread_full`` are
exercised against genuine partial data, not a simulated return code.
"""
from __future__ import annotations

import dataclasses
import errno
import os
import threading
import time

import numpy as np

FAULT_KINDS = ("eio", "eagain", "short", "delay")

_ERRNO = {"eio": errno.EIO, "eagain": errno.EAGAIN}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to inject, how often, and in what order.

    ``p_<kind>`` are per-read-call probabilities (stacked: one uniform
    per call is drawn against cumulative thresholds, so at most one
    fault fires per call and the sum must stay <= 1).  ``schedule``
    overrides the dice for specific call indices — ``((3, "eio"),
    (7, "short"))`` faults exactly calls 3 and 7 — and works with all
    probabilities at zero, which is what deterministic tier-1 tests
    use.  ``max_faults`` bounds the total injected (None = unbounded).
    """

    seed: int = 0
    p_eio: float = 0.0
    p_eagain: float = 0.0
    p_short: float = 0.0
    p_delay: float = 0.0
    delay_s: float = 0.001
    short_frac: float = 0.5  # fraction of wanted bytes a short read returns
    schedule: tuple = ()  # ((call_index, kind), ...) scripted overrides
    max_faults: int | None = None

    def __post_init__(self):
        total = self.p_eio + self.p_eagain + self.p_short + self.p_delay
        if not 0.0 <= total <= 1.0:
            raise ValueError(f"fault probabilities sum to {total}, not in [0, 1]")
        if not 0.0 < self.short_frac < 1.0:
            raise ValueError(f"short_frac={self.short_frac} must be in (0, 1)")
        for idx, kind in self.schedule:
            if kind not in FAULT_KINDS:
                raise ValueError(f"schedule kind {kind!r} not in {FAULT_KINDS}")
            if int(idx) < 0:
                raise ValueError(f"schedule call index {idx} is negative")

    @property
    def active(self) -> bool:
        """True if this plan can ever inject anything."""
        return bool(self.schedule) or (
            self.p_eio + self.p_eagain + self.p_short + self.p_delay
        ) > 0.0

    def injector(self) -> "FaultInjector":
        return FaultInjector(self)


class FaultInjector:
    """One store's live injection state: a call counter plus the three
    wrapped read entry points.  Thread-safe — the reader pool's workers
    share one injector."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._schedule = {int(i): k for i, k in plan.schedule}
        self._p_total = plan.p_eio + plan.p_eagain + plan.p_short + plan.p_delay
        self._lock = threading.Lock()
        self.calls = 0  # guarded by _lock
        self.faults_injected = 0  # guarded by _lock
        self.injected = {k: 0 for k in FAULT_KINDS}  # guarded by _lock

    def counters(self) -> dict:
        with self._lock:
            out = {"read_calls": self.calls, "faults_injected": self.faults_injected}
            out.update({f"injected_{k}": v for k, v in self.injected.items()})
            return out

    def _decide(self) -> str | None:
        """Pick this call's fault (or None), advancing the call counter."""
        with self._lock:
            idx = self.calls
            self.calls += 1
            kind = self._schedule.get(idx)
            if kind is None and self._p_total > 0.0:
                u = float(np.random.default_rng((self.plan.seed, idx)).random())
                acc = 0.0
                for k in FAULT_KINDS:
                    acc += getattr(self.plan, "p_" + k)
                    if u < acc:
                        kind = k
                        break
            if kind is not None:
                if (
                    self.plan.max_faults is not None
                    and self.faults_injected >= self.plan.max_faults
                ):
                    return None
                self.faults_injected += 1
                self.injected[kind] += 1
            return kind

    def _raise(self, kind: str, op: str, offset: int) -> None:
        raise OSError(_ERRNO[kind], f"injected {kind} ({op} at offset {offset})")

    # -- the wrapped read entry points (os.* signatures) -------------------
    def preadv(self, fd: int, views, offset: int) -> int:
        kind = self._decide()
        if kind in ("eio", "eagain"):
            self._raise(kind, "preadv", offset)
        if kind == "delay":
            time.sleep(self.plan.delay_s)
        elif kind == "short":
            batch = list(views)
            want = sum(len(v) for v in batch)
            target = min(max(1, int(want * self.plan.short_frac)), max(want - 1, 1))
            if target < want:
                # issue a REAL read of the truncated prefix: the caller's
                # resume loop re-reads the rest from the actual file
                cut, n = [], 0
                for v in batch:
                    take = min(len(v), target - n)
                    cut.append(v[:take])
                    n += take
                    if n >= target:
                        break
                return os.preadv(fd, cut, offset)
        return os.preadv(fd, views, offset)

    def pread(self, fd: int, n: int, offset: int) -> bytes:
        kind = self._decide()
        if kind in ("eio", "eagain"):
            self._raise(kind, "pread", offset)
        if kind == "delay":
            time.sleep(self.plan.delay_s)
        elif kind == "short":
            k = min(max(1, int(n * self.plan.short_frac)), max(n - 1, 1))
            if k < n:
                return os.pread(fd, k, offset)
        return os.pread(fd, n, offset)

    def gather(self, fn):
        """Wrap one memmap fancy-gather; ``short`` has no meaning for a
        page-faulted read, so only error/delay kinds fire here."""
        kind = self._decide()
        if kind in ("eio", "eagain"):
            self._raise(kind, "gather", 0)
        if kind == "delay":
            time.sleep(self.plan.delay_s)
        return fn()


__all__ = ["FAULT_KINDS", "FaultPlan", "FaultInjector"]
