"""Process-wide metrics registry: counters, gauges, log-scale histograms.

Port of ``repro.obs.registry``, line for line (the module never touched
JAX; the port keeps its own copy so it imports nothing of ``repro``), plus
a histogram's batch observe (``observe_many``).
Every hot layer of the port — the disk store's host reads, the engine's
search dispatch, the cache tiers, the serving front end's admission and
queue path — publishes named metric *families* here, and the exporters
(``obs/export.py``) turn one snapshot into Prometheus text or a JSON
artifact.  Design constraints, in order:

  * **lock-cheap.** One ``threading.Lock`` per metric child; an
    increment is a guarded add (no global lock on the write path), and a
    *disabled* registry early-outs before touching any lock — the
    disabled hot path costs one attribute read and one branch.  On the
    card the search loop is host-bound, so a disabled hook must add no
    device work either: nothing here touches a tensor.
  * **no samples stored.** Histograms use fixed log-scale buckets:
    p50/p99/p99.9 are interpolated from cumulative bucket counts alone,
    so memory per child is O(buckets) regardless of observation count.
    ``sum``/``count`` are tracked exactly, so means are exact even
    though percentiles are bucket-resolution (~26% relative at the
    default 10 buckets/decade).
  * **families.** A family is ``(name, kind, label names)``; children
    are label valuations (``tenant=t0``, ``mode=gate``, ``store=...``).
    Label names are fixed at family creation — mismatched label sets on
    the same name are a bug and raise.  ``name`` is reserved (it is the
    family-name parameter); pick another label key (e.g. ``span``).

Counters are monotonic for the registry's lifetime: notably,
``DiskRecordStore.reset_io_counters()`` resets only the store-local
attributes, never the registry families (reconciliation contracts that
span resets therefore compare registry totals against registry totals).

The process-default registry starts DISABLED unless ``GATEANN_OBS`` is
set to a non-empty, non-"0" value (the reference's variable); ``obs.
enable()`` flips it at runtime.  Tests swap in a private registry with
``use_registry`` instead of mutating the shared one.
"""
from __future__ import annotations

import bisect
import contextlib
import math
import os
import threading

import numpy as np


class Counter:
    """Monotonic counter child.  ``inc`` is the only mutator."""

    kind = "counter"
    __slots__ = ("labels", "_registry", "_lock", "_value")

    def __init__(self, registry: "MetricsRegistry", labels: dict):
        self.labels = labels
        self._registry = registry
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value child (queue depth, inflight reads, ...)."""

    kind = "gauge"
    __slots__ = ("labels", "_registry", "_lock", "_value")

    def __init__(self, registry: "MetricsRegistry", labels: dict):
        self.labels = labels
        self._registry = registry
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        self.inc(-n)

    @property
    def value(self):
        with self._lock:
            return self._value


# default histogram geometry: 10^(-6)..10^6 at 10 buckets per decade
# covers both span durations in seconds (1us..11.6 days) and per-query
# integer counts (I/Os, hops) without storing a single sample
HIST_LO = 1e-6
HIST_HI = 1e6
HIST_PER_DECADE = 10


def log_bucket_edges(lo: float = HIST_LO, hi: float = HIST_HI,
                     per_decade: int = HIST_PER_DECADE) -> list[float]:
    """Upper bucket edges ``10^(k/per_decade)`` spanning [lo, hi]."""
    k0 = math.floor(math.log10(lo) * per_decade)
    k1 = math.ceil(math.log10(hi) * per_decade)
    return [10.0 ** (k / per_decade) for k in range(k0, k1 + 1)]


class Histogram:
    """Fixed log-scale-bucket histogram child.

    ``counts[i]`` counts observations with ``edges[i-1] < v <= edges[i]``
    (``counts[0]`` is the underflow bucket spanning ``(-inf, edges[0]]``,
    the final slot overflow ``> edges[-1]``).  ``sum``/``count``/``min``
    /``max`` are exact; quantiles interpolate geometrically within the
    landing bucket.
    """

    kind = "histogram"
    __slots__ = ("labels", "edges", "_registry", "_lock", "_counts",
                 "_sum", "_count", "_min", "_max", "_edges_arr")

    def __init__(self, registry: "MetricsRegistry", labels: dict,
                 edges: list[float]):
        self.labels = labels
        self.edges = edges
        self._registry = registry
        self._lock = threading.Lock()
        self._counts = [0] * (len(edges) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._edges_arr = None  # ``edges`` as an array, for ``observe_many``

    def observe(self, v: float) -> None:
        if not self._registry.enabled:
            return
        v = float(v)
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    def observe_many(self, values) -> None:
        """``observe`` each of an array's values, in order, under one lock:
        the same buckets (``searchsorted(side="left")`` is ``bisect_left``),
        and sum, count, min and max exactly as one ``observe`` a value gives
        them (the sum adds the values one after another, as ``observe``
        does)."""
        if not self._registry.enabled:
            return
        v = np.asarray(values, dtype=np.float64).reshape(-1)
        if not v.size:
            return
        if self._edges_arr is None:
            self._edges_arr = np.asarray(self.edges, dtype=np.float64)
        bins = np.bincount(np.searchsorted(self._edges_arr, v, side="left"))
        hit = [(int(i), int(bins[i])) for i in np.flatnonzero(bins)]
        lo, hi = float(v.min()), float(v.max())
        with self._lock:
            for i, c in hit:
                self._counts[i] += c
            self._sum = float(np.add.accumulate(np.concatenate(([self._sum], v)))[-1])
            self._count += int(v.size)
            if lo < self._min:
                self._min = lo
            if hi > self._max:
                self._max = hi

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]) from bucket counts.

        Interpolation is geometric within the landing bucket (the
        buckets are log-spaced); the underflow bucket interpolates
        linearly from 0 and the overflow bucket returns the exact
        observed max.  Worst-case relative error is one bucket ratio
        (10^(1/per_decade), ~26% at the default geometry) — tight
        enough to rank stages and watch trends, which is the job.
        """
        with self._lock:
            total = self._count
            if not total:
                return 0.0
            counts = list(self._counts)
            vmin, vmax = self._min, self._max
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if not c:
                continue
            if cum + c < target:
                cum += c
                continue
            frac = min(max((target - cum) / c, 0.0), 1.0)
            if i >= len(self.edges):  # overflow bucket
                return vmax
            hi_e = self.edges[i]
            lo_e = 0.0 if i == 0 else self.edges[i - 1]
            if lo_e <= 0.0:
                v = lo_e + (hi_e - lo_e) * frac
            else:
                v = lo_e * (hi_e / lo_e) ** frac
            # never extrapolate outside the observed range
            return min(max(v, vmin), vmax)
        return vmax

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            out = {
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
            }
        out["buckets"] = [
            [le, c] for le, c in zip(self.edges + [math.inf], counts) if c
        ]
        out["p50"] = self.quantile(0.50)
        out["p99"] = self.quantile(0.99)
        out["p999"] = self.quantile(0.999)
        return out


class _Family:
    __slots__ = ("name", "kind", "label_names", "children", "edges")

    def __init__(self, name, kind, label_names, edges=None):
        self.name = name
        self.kind = kind
        self.label_names = label_names
        self.children: dict[tuple, object] = {}
        self.edges = edges


class MetricsRegistry:
    """A namespace of metric families; see the module docstring."""

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        # held by ``snapshot`` and by a writer's ``atomic`` group of updates,
        # so no snapshot falls inside a group
        self._group_lock = threading.RLock()

    def atomic(self):
        """A context in which a group of updates lands in snapshots all
        together or not at all: ``snapshot`` reads the families one by one,
        so without it a whole group (records and unique sectors of one
        read) can land between two of its reads, and a family read first
        falls behind one read later (``unique_sectors_read`` above
        ``records_read``)."""
        return self._group_lock

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # -- family/child resolution -------------------------------------------
    def _child(self, name: str, kind: str, labels: dict, make):
        key = tuple(sorted(labels.items()))
        fam = self._families.get(name)  # GIL-atomic read, no lock
        # the kind check must run on the fast path too — returning an
        # existing child of the wrong kind would silently hand a Counter
        # to a histogram() caller; mismatched label NAMES can't collide
        # here (a different label set implies a different child key)
        if fam is not None and fam.kind == kind:
            child = fam.children.get(key)
            if child is not None:
                return child
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, tuple(sorted(labels)))
                self._families[name] = fam
            if fam.kind != kind:
                raise TypeError(
                    f"metric family {name!r} is a {fam.kind}, not a {kind}"
                )
            if tuple(sorted(labels)) != fam.label_names:
                raise ValueError(
                    f"family {name!r} has labels {fam.label_names}, "
                    f"got {tuple(sorted(labels))}"
                )
            child = fam.children.get(key)
            if child is None:
                child = make(fam)
                fam.children[key] = child
            return child

    def counter(self, name: str, **labels) -> Counter:
        return self._child(name, "counter", labels,
                           lambda fam: Counter(self, dict(labels)))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._child(name, "gauge", labels,
                           lambda fam: Gauge(self, dict(labels)))

    def histogram(self, name: str, *, lo: float = HIST_LO, hi: float = HIST_HI,
                  per_decade: int = HIST_PER_DECADE, **labels) -> Histogram:
        # bucket geometry is fixed per family (the first creation wins —
        # children of one family must share edges so exports line up)
        def make(fam):
            if fam.edges is None:
                fam.edges = log_bucket_edges(lo, hi, per_decade)
            return Histogram(self, dict(labels), fam.edges)

        return self._child(name, "histogram", labels, make)

    # -- reads --------------------------------------------------------------
    def families(self) -> list[str]:
        with self._lock:
            return sorted(self._families)

    def children(self, name: str) -> list:
        fam = self._families.get(name)
        if fam is None:
            return []
        with self._lock:
            return list(fam.children.values())

    def family_total(self, name: str, **match_labels) -> float:
        """Sum of counter/gauge child values, optionally filtered to
        children whose labels include every ``match_labels`` item."""
        total = 0.0
        for child in self.children(name):
            if match_labels and any(
                child.labels.get(k) != v for k, v in match_labels.items()
            ):
                continue
            total += child.value
        return total

    def snapshot(self) -> dict:
        """Plain-dict view of every family (the JSON/Prometheus source).

        Each child is snapshotted under its own lock, and the whole view
        under ``atomic``'s lock: each child's (value) or (count, sum,
        buckets) tuple is internally coherent, and a group of updates made
        under ``atomic`` is in the view whole or not at all — what the
        mid-flight invariant checks rely on.
        """
        with self._group_lock:
            return self._snapshot()

    def _snapshot(self) -> dict:
        with self._lock:
            fams = [(f.name, f.kind, list(f.children.values()))
                    for f in self._families.values()]
        out = {}
        for name, kind, children in sorted(fams):
            rows = []
            for child in children:
                row = {"labels": dict(child.labels)}
                if kind == "histogram":
                    row.update(child.snapshot())
                else:
                    row["value"] = child.value
                rows.append(row)
            rows.sort(key=lambda r: sorted(r["labels"].items()))
            fam_out = {"kind": kind, "children": rows}
            if kind in ("counter", "gauge"):
                fam_out["total"] = sum(r["value"] for r in rows)
            out[name] = fam_out
        return out

    def reset(self) -> None:
        """Drop every family (tests / explicit restarts only)."""
        with self._lock:
            self._families.clear()


_default = MetricsRegistry(
    enabled=os.environ.get("GATEANN_OBS", "") not in ("", "0")
)


def default_registry() -> MetricsRegistry:
    return _default


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _default
    prev = _default
    _default = reg
    return prev


@contextlib.contextmanager
def use_registry(reg: MetricsRegistry):
    """Swap the process-default registry for the block (test isolation).

    Stores built inside the block capture ``reg`` at construction, so
    their counters keep landing in it even after the block exits —
    exactly what a test wants when it asserts on the swapped registry
    after tearing the engine down.
    """
    prev = set_default_registry(reg)
    try:
        yield reg
    finally:
        set_default_registry(prev)


def enable() -> None:
    """Enable recording on the process-default registry."""
    _default.enabled = True


def disable() -> None:
    _default.enabled = False
