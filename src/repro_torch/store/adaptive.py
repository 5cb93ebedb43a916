"""Adaptive, filter-aware record cache — the static hot set made a control loop.

Port of ``repro.store.adaptive``.  The static ``CachedRecordStore``
(``store/cache.py``) picks its hot set once, from *unfiltered* sample
traversals.  That is the wrong population under a selective predicate:
gate-mode fetches are drawn from the filter-passing nodes only, so a
cache populated for the unfiltered visit distribution thrashes exactly
where filtered search pays the most I/O.  This module closes the loop:

  * **online frequency counting** — the search loop carries an (N,)
    counter tensor on the device and scatter-adds each round's fetch-path
    dispatches (``filtered_search(visit_counts=...)``).  Batch counts are
    folded into an EMA (``counts = decay * counts + batch``) so the hot
    set tracks the *recent* workload and old regimes age out.  The EMA is
    a multiply and then an add, two roundings in float32, as the
    reference's eager (unjitted) ops compute it — no fused multiply-add.
  * **periodic refresh** — ``refresh()`` re-materialises the device hot
    set from the live counters under the same ``budget_bytes``; every
    materialisation packs exactly ``n_slots`` rows (zero-padded), so the
    cache's tensors keep their shapes.
  * **per-filter hot sets** — a small LRU of (filter-kind, param-bucket)
    -> partition, each with its own counters and its own materialised hot
    set.  Each materialised partition is a full ``budget_bytes`` block:
    device residency is up to ``(1 + max_partitions) x budget``
    (``device_bytes()`` reports the true footprint).

Results stay bit-identical to the uncached engine by construction: the
cache only reroutes record fetches between the slow tier (``n_ios``) and
the cache tier (``n_cache_hits``).

Telemetry, as the reference's, in the process registry: the counters
``cache.partition_evictions`` (partitions the LRU dropped),
``cache.refreshes`` and ``cache.refresh_sets`` (hot sets rebuilt), and
the gauge ``cache.partitions``.  ``n_refreshes`` and
``last_refresh_sets`` stay attributes: the cost model reads them.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.store.cache import CachedRecordStore, _host, record_nbytes, select_hot_set

ADAPTIVE_POLICY = "adaptive"


def filter_bucket(kind: str | None, params) -> tuple | None:
    """Hashable (filter-kind, param-bucket) partition key; None = global.

    Buckets are deliberately coarse — a partition should capture a query
    *population* (e.g. "label == 3", "norm in bin 7"), not one batch:

      * equality — the batch's most common target label.
      * range    — (lo, hi) rounded to 3 significant decimals (batch mean).
      * subset   — the bit-pattern of the batch's first query tags.

    ``params`` may hold tensors (on any device) or host arrays.
    """
    if kind is None or params is None:
        return None
    if isinstance(params, (tuple, list)):
        p = np.asarray([_host(x) for x in params])
    else:
        p = _host(params)
    if kind == "label":
        vals, counts = np.unique(p.astype(np.int64), return_counts=True)
        return (kind, int(vals[np.argmax(counts)]))
    if kind == "range":
        # params is a (lo, hi) pair exactly as RangeFilter.bind unpacks it:
        # a 2-tuple of scalars/arrays, or an array whose axis 0 is (lo, hi)
        lo, hi = p[0], p[1]
        return (kind, round(float(np.mean(lo)), 3), round(float(np.mean(hi)), 3))
    if kind == "tags":
        row = p[0] if p.ndim > 1 else p
        return (kind, row.astype(np.uint32).tobytes())
    return (kind, p.tobytes())


@dataclasses.dataclass
class _Partition:
    counts: torch.Tensor  # (N,) f32 EMA of this filter bucket's fetches
    store: CachedRecordStore | None = None  # materialised at refresh
    dirty: bool = True  # saw traffic since its store was last materialised


@dataclasses.dataclass
class AdaptiveRecordCache:
    """Mutable cache controller; the engine routes fetches through it.

    Searches read from an immutable ``CachedRecordStore`` snapshot (the
    partition's if one is materialised for the query's filter bucket, the
    global one otherwise); ``observe`` folds the returned visit counters
    into the EMAs; ``refresh`` republishes the snapshots from the live
    counters.  Mutation happens only between searches.
    """

    backing: Any  # slow-tier record store
    # (N, D) full records for re-materialisation: a tensor for the memory
    # and host tiers, or the disk tier's LAZY host view (refreshes then
    # gather only the hot rows on the host; the corpus stays on disk)
    vectors: Any
    neighbors: Any  # (N, R) int32, a tensor or a host array
    budget_bytes: int
    device: torch.device
    ema_decay: float = 0.9
    refresh_every: int = 4  # batches between refreshes (0 = manual only)
    max_partitions: int = 4  # LRU capacity for per-filter hot sets
    seed_hot_ids: np.ndarray | None = None  # cold-start hot set

    counts: torch.Tensor = None  # (N,) f32 global EMA
    partitions: "OrderedDict[tuple, _Partition]" = None
    global_store: CachedRecordStore = None
    n_refreshes: int = 0
    batches_since_refresh: int = 0
    last_refresh_sets: int = 1  # hot sets rebuilt by the latest refresh

    # -- construction ------------------------------------------------------
    @classmethod
    def create(
        cls,
        backing: Any,
        *,
        vectors,
        neighbors,
        budget_bytes: int,
        medoid: int,
        ema_decay: float = 0.9,
        refresh_every: int = 4,
        max_partitions: int = 4,
        seed: int = 0,
        device=None,
    ) -> "AdaptiveRecordCache":
        """The controller on ``device`` (the card unless the caller asks for
        the CPU), starting from the static ``visit_freq`` hot set — the
        best filter-blind guess until real traffic fills the counters
        (``select_hot_set`` takes BFS when the vectors are a lazy view)."""
        dev = resolve_device(device)
        seed_hot = select_hot_set(
            neighbors=neighbors, medoid=medoid, budget_bytes=budget_bytes,
            policy="visit_freq", vectors=vectors, seed=seed, device=dev,
        )
        self = cls(
            backing=backing,
            vectors=vectors,
            neighbors=neighbors,
            budget_bytes=int(budget_bytes),
            device=dev,
            ema_decay=float(ema_decay),
            refresh_every=int(refresh_every),
            max_partitions=int(max_partitions),
            seed_hot_ids=np.asarray(seed_hot, np.int32),
        )
        self.counts = torch.zeros((int(neighbors.shape[0]),), dtype=torch.float32, device=dev)
        self.partitions = OrderedDict()
        self.global_store = self._materialize(self.seed_hot_ids)
        return self

    @property
    def n_slots(self) -> int:
        d = int(self.vectors.shape[1])
        r = int(self.neighbors.shape[1])
        n = int(self.neighbors.shape[0])
        return min(self.budget_bytes // record_nbytes(d, r), n)

    @property
    def policy(self) -> str:
        return ADAPTIVE_POLICY

    # -- the read path (immutable snapshots) -------------------------------
    def store_for(self, bucket: tuple | None) -> CachedRecordStore:
        """The snapshot serving this filter bucket (LRU-touches it)."""
        part = self.partitions.get(bucket) if bucket is not None else None
        if part is not None:
            self.partitions.move_to_end(bucket)
            if part.store is not None:
                return part.store
        return self.global_store

    # -- the control loop --------------------------------------------------
    def _ema(self, counts: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
        decay = torch.tensor(self.ema_decay, dtype=torch.float32, device=counts.device)
        return decay * counts + batch  # two float32 roundings, as the reference

    def observe(self, bucket: tuple | None, batch_counts) -> None:
        """Fold one batch's visit counters into the EMAs (device math)."""
        bc = torch.as_tensor(batch_counts, dtype=torch.float32, device=self.device)
        self.counts = self._ema(self.counts, bc)
        if bucket is not None:
            part = self.partitions.get(bucket)
            if part is None:
                part = _Partition(counts=torch.zeros_like(self.counts))
                self.partitions[bucket] = part
                while len(self.partitions) > self.max_partitions:
                    self.partitions.popitem(last=False)  # evict LRU
                    obs.default_registry().counter("cache.partition_evictions").inc()
            part.counts = self._ema(part.counts, bc)
            part.dirty = True
            self.partitions.move_to_end(bucket)
        self.batches_since_refresh += 1

    def _materialize(self, hot_ids: np.ndarray) -> CachedRecordStore:
        """A snapshot with a fixed ``n_slots``-row block (only the hot rows
        gathered; a refresh is O(n_slots), never a corpus round-trip)."""
        return CachedRecordStore.wrap(
            self.backing,
            vectors=self.vectors,
            neighbors=self.neighbors,
            hot_ids=hot_ids,
            policy=ADAPTIVE_POLICY,
            n_slots=self.n_slots,
            device=self.device,
        )

    def _hot_from_counts(self, counts: torch.Tensor) -> np.ndarray:
        """Top-``n_slots`` ids by live counter, seed-padded for cold slots.

        O(N + k log k): argpartition isolates the k winners, then only
        those are sorted (count desc, id asc for determinism).
        """
        c = _host(counts)
        k = min(self.n_slots, c.size)
        cand = np.argpartition(-c, k - 1)[:k] if 0 < k < c.size else np.arange(c.size)[:k]
        order = cand[np.lexsort((cand, -c[cand]))]
        hot = order[c[order] > 0].astype(np.int32)
        if hot.size < self.n_slots and self.seed_hot_ids is not None:
            extra = self.seed_hot_ids[~np.isin(self.seed_hot_ids, hot)]
            hot = np.concatenate([hot, extra[: self.n_slots - hot.size]])
        return hot

    def refresh(self) -> None:
        """Re-materialise the stale hot sets from the live counters.

        Only the global set and *dirty* partitions (traffic since their
        last materialisation) are rebuilt — an idle partition keeps its
        snapshot.  ``last_refresh_sets`` records how many sets the refresh
        rebuilt, for the cost model.
        """
        sets = 1
        self.global_store = self._materialize(self._hot_from_counts(self.counts))
        for part in self.partitions.values():
            if part.dirty or part.store is None:
                part.store = self._materialize(self._hot_from_counts(part.counts))
                part.dirty = False
                sets += 1
        self.last_refresh_sets = sets
        self.n_refreshes += 1
        self.batches_since_refresh = 0
        reg = obs.default_registry()
        if reg.enabled:
            reg.counter("cache.refreshes").inc()
            reg.counter("cache.refresh_sets").inc(sets)
            reg.gauge("cache.partitions").set(len(self.partitions))

    def maybe_refresh(self) -> bool:
        """Refresh if the cadence is due; returns whether it ran."""
        if self.refresh_every > 0 and self.batches_since_refresh >= self.refresh_every:
            self.refresh()
            return True
        return False

    # -- state across save()/load() ----------------------------------------
    # The EMA counters are keyed to THIS store's node ids: a freshly loaded
    # engine never inherits them implicitly.  load() starts from
    # reset_counters() semantics; a caller who wants to carry a learned
    # workload across a restart does it explicitly: export_state() before
    # save, restore_state() after load (validated against the new store's
    # geometry, then refreshed).

    def reset_counters(self) -> None:
        """Forget the learned workload: zero the EMAs, drop partitions,
        republish the cold-start seed hot set."""
        self.counts = torch.zeros_like(self.counts)
        self.partitions = OrderedDict()
        self.global_store = self._materialize(self.seed_hot_ids)
        self.batches_since_refresh = 0

    def export_state(self) -> dict:
        """Portable counter state: global + per-partition EMAs (host
        arrays), tagged with the corpus geometry for restore validation."""
        return {
            "n": int(self.counts.shape[0]),
            "counts": _host(self.counts).astype(np.float32),
            "partitions": [(key, _host(part.counts).astype(np.float32))
                           for key, part in self.partitions.items()],
        }

    def restore_state(self, state: dict) -> None:
        """Adopt exported counters onto this (possibly reloaded) store.

        Node ids must mean the same rows they meant at export; only the
        corpus length is checkable here, so a mismatch is rejected loudly
        instead of mis-ranking silently.  The hot sets are refreshed at
        once, so the first search after it serves the carried hot set.
        """
        n = int(self.counts.shape[0])
        counts = np.asarray(state["counts"], np.float32)
        if int(state.get("n", -1)) != n or counts.shape != (n,):
            raise ValueError(
                f"adaptive state holds counters for n={state.get('n')} "
                f"records but this store has n={n} — counters are keyed "
                "to node ids and cannot be remapped across stores"
            )
        self.counts = torch.from_numpy(counts.copy()).to(self.device)
        self.partitions = OrderedDict()
        for key, pc in list(state.get("partitions", []))[-self.max_partitions:]:
            part = _Partition(counts=torch.from_numpy(
                np.asarray(pc, np.float32).copy()).to(self.device))
            self.partitions[tuple(key) if isinstance(key, list) else key] = part
        self.refresh()

    # -- reporting ---------------------------------------------------------
    def n_materialized(self) -> int:
        return 1 + sum(1 for p in self.partitions.values() if p.store is not None)

    def device_bytes(self) -> int:
        """Snapshot blocks + counters + slot maps held on the device."""
        per_store = self.global_store.device_bytes()
        n = int(self.neighbors.shape[0])
        counters = (1 + len(self.partitions)) * n * 4
        return self.n_materialized() * per_store + counters

    def cache_bytes(self) -> int:
        return self.global_store.cache_bytes()

    @property
    def n_cached(self) -> int:
        return self.global_store.n_cached

    def hot_ids(self) -> np.ndarray:
        return self.global_store.hot_ids()

    # -- passthroughs to the global snapshot and the backing store ---------
    # (a search of one filter bucket goes through store_for(bucket) instead)
    def fetch(self, ids: torch.Tensor):
        return self.global_store.fetch(ids)

    def cached_mask(self, ids: torch.Tensor) -> torch.Tensor:
        return self.global_store.cached_mask(ids)

    @property
    def submit(self):
        return self.global_store.submit

    @property
    def drain(self):
        return self.global_store.drain

    @property
    def degree(self) -> int:
        return self.global_store.degree

    def io_counters(self) -> dict:
        """Measured counters of the slow tier ({} for modeled backings)."""
        f = getattr(self.backing, "io_counters", None)
        return f() if f is not None else {}

    def abandon_pending(self) -> int:
        f = getattr(self.backing, "abandon_pending", None)
        return f() if f is not None else 0

    def record_bytes(self) -> int:
        return self.backing.record_bytes()

