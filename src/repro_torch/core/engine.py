"""GateANN engine — the port's public API.

Port of ``repro.core.engine``: build an index from a corpus (or load a
saved one, or take the arrays an index holds), then search with any
predicate and any mode.  The engine owns the storage tiers of §3:

  fast tier ("memory"):   PQ codes, neighbor store, filter store — on the
                          engine's device in every tier
  cache tier:             hot-node record cache (optional — see
                          ``EngineConfig.cache_budget_bytes``; static
                          policies pick the hot set once, ``cache_policy=
                          "adaptive"`` re-learns it online from live visit
                          counters, per filter bucket)
  slow tier:              the record store (full vectors + full adjacency),
                          by ``EngineConfig.store_tier``:
                            "memory" — on the device (``InMemoryRecordStore``)
                            "host"   — pinned host memory (``HostOffloadRecordStore``)
                            "disk"   — read off the index file with measured
                                       I/O (``DiskRecordStore``)

Everything else lives on one device.  ``device=None`` means the card: it
resolves to ``cuda`` and raises when no CUDA device is present; tests
pass ``device="cpu"`` and run the kernels' plain versions.

``build`` runs the Vamana build (``core/graph.py``) and PQ training on
the engine's device; ``save`` writes the index file either package
loads.  On the disk tier ``pipeline_depth > 1`` runs the pipelined loop,
which overlaps each round's record read with the next rounds' traversal.

Telemetry, as the reference's (``repro_torch.obs``): every ``search``
counts one ``search.dispatch{mode,tier,pipelined}`` and runs inside an
``engine.search`` span; with the registry enabled it also folds the
batch's stats into the ``search.*`` families, which copies them to the
host (one copy, so on the card the span covers the device work).  With
telemetry off a search adds no sync, no copy and no device launch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import graph as graphm
from repro_torch.core import pq as pqm
from repro_torch.core import search as searchm
from repro_torch.core.filter_store import (
    CheckFn, EqualityFilter, RangeFilter, SubsetFilter, as_int32_bits, match_all,
)
from repro_torch.core.io_model import DEFAULT_COST_MODEL, IOCostModel
from repro_torch.core.neighbor_store import NeighborStore
from repro_torch.device import resolve_device
from repro_torch.store import format as idx_format
from repro_torch.store.adaptive import ADAPTIVE_POLICY, AdaptiveRecordCache, filter_bucket
from repro_torch.store.cache import CACHE_POLICIES, CachedRecordStore, select_hot_set
from repro_torch.store.disk import DiskRecordStore, RetryPolicy
from repro_torch.store.vector_store import HostOffloadRecordStore, InMemoryRecordStore

STORE_TIERS = ("memory", "host", "disk")
CACHE_TIERS = (CachedRecordStore, AdaptiveRecordCache)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's configuration, field for field (a saved index's
    config loads in either package)."""

    degree: int = 32  # graph degree R
    build_l: int = 64  # L_build
    alpha: float = 1.2
    pq_chunks: int = 16  # PQ chunks C (reduced until it divides D)
    r_max: int = 16  # in-memory neighbors per node (runtime knob)
    store_tier: str = "memory"  # memory | host | disk (disk serves an index file)
    # disk tier: bound on preadv gap bridging, in sectors (negative =
    # unbounded, 0 = never bridge)
    max_gap_sectors: int = -1
    cache_budget_bytes: int = 0  # hot-record cache size (0 disables the tier)
    cache_policy: str = "visit_freq"  # visit_freq | bfs | adaptive
    refresh_every: int = 4  # adaptive: batches between hot-set refreshes
    ema_decay: float = 0.9  # adaptive: per-batch counter decay
    # adaptive: LRU capacity of per-filter hot sets; each materialised
    # partition holds its own cache_budget_bytes block
    cache_partitions: int = 4
    use_fused_kernel: bool = False  # default for SearchConfig.use_fused_kernel
    # disk tier resilience: transient read errors retry io_retries times
    # with exponential backoff from io_retry_backoff_s; a round's reads may
    # take at most io_round_deadline_s (0 = no deadline); on exhaustion
    # io_on_error="fail" raises, "degrade" serves the slots as tunneled
    # nodes (counted in SearchStats.n_degraded)
    io_retries: int = 0
    io_retry_backoff_s: float = 1e-3
    io_round_deadline_s: float = 0.0
    io_on_error: str = "fail"
    seed: int = 0  # seeds the build, PQ training, the cache's samples, retry jitter


def _check_config(config: EngineConfig) -> None:
    if config.store_tier not in STORE_TIERS:
        raise ValueError(f"store_tier={config.store_tier!r} not in {STORE_TIERS}")
    if config.cache_policy not in CACHE_POLICIES + (ADAPTIVE_POLICY,):
        raise ValueError(f"cache_policy={config.cache_policy!r} not in "
                         f"{CACHE_POLICIES + (ADAPTIVE_POLICY,)}")


def _open_disk_store(path: str, config: EngineConfig, device: torch.device,
                     faults=None) -> DiskRecordStore:
    """Open the slow tier with the config's I/O knobs applied."""
    return DiskRecordStore.open(
        path,
        device=device,
        max_gap_sectors=config.max_gap_sectors,
        retry=RetryPolicy(max_retries=config.io_retries, backoff_s=config.io_retry_backoff_s,
                          seed=config.seed),
        on_error=config.io_on_error,
        round_deadline_s=config.io_round_deadline_s,
        faults=faults,
    )


def _tensor(a, dtype, device: torch.device) -> torch.Tensor:
    """A host array (memmap views included) as a tensor of its own on ``device``."""
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def _on_device(a, dtype, device: torch.device) -> torch.Tensor:
    """A tensor (moved) or a host array (copied) on ``device``."""
    return a.to(device) if isinstance(a, torch.Tensor) else _tensor(a, dtype, device)


def _host_array(a, dtype) -> np.ndarray:
    """A tensor, host array or lazy host view as a host array of ``dtype``."""
    return a.cpu().numpy().astype(dtype, copy=False) if isinstance(a, torch.Tensor) \
        else np.asarray(a, dtype)


def _check_ranges(vecs, nbrs, books, codes, medoid: int) -> None:
    """Ids and codes index device memory inside the kernels: refuse any
    out of range rather than read out of bounds.  Takes tensors or host
    arrays (the disk tier's lazy vector view included)."""
    n = vecs.shape[0]
    if nbrs.shape[0] != n or codes.shape[0] != n:
        raise ValueError(f"{n} vectors but {nbrs.shape[0]} adjacency rows, {codes.shape[0]} codes")
    if codes.shape[1] != books.shape[0] or books.shape[0] * books.shape[2] != vecs.shape[1]:
        raise ValueError(f"PQ books {tuple(books.shape)} do not fit codes {tuple(codes.shape)} "
                         f"of {vecs.shape[1]}-d vectors")
    if n and (int(nbrs.min()) < -1 or int(nbrs.max()) >= n):
        raise ValueError(f"adjacency ids outside [-1, {n})")
    if n and (int(codes.min()) < 0 or int(codes.max()) >= books.shape[1]):
        raise ValueError(f"PQ codes outside [0, {books.shape[1]})")
    if not 0 <= medoid < max(n, 1):
        raise ValueError(f"medoid {medoid} outside [0, {n})")


def _filter_store(kind: str, arr, device: torch.device):
    if kind == "label":
        return EqualityFilter(labels=_on_device(arr, np.int32, device).int())
    if kind == "range":
        return RangeFilter(values=_on_device(arr, np.float32, device).float())
    if kind == "tags":  # a host array is copied: a memmap view is read-only
        return SubsetFilter(tag_bits=as_int32_bits(
            arr if isinstance(arr, torch.Tensor) else np.array(arr), device))
    raise ValueError(f"unknown filter kind {kind!r} (label, range or tags)")


def _filter_arrays(filters: dict) -> dict:
    """The per-node filter arrays the index file holds, by kind."""
    out = {}
    for kind, f in filters.items():
        if kind == "label":
            out[kind] = _host_array(f.labels, np.int32)
        elif kind == "range":
            out[kind] = _host_array(f.values, np.float32)
        elif kind == "tags":
            out[kind] = _host_array(f.tag_bits, np.int32).view(np.uint32)
    return out


def _store_neighbors(store, expected_n: int | None = None):
    """Full adjacency of a record store, whatever its tier: a device tensor
    (memory tier), a host tensor (host tier) or the sidecar's host view
    (disk tier).  The sharded tier has only its ``local_neighbors`` rows,
    which serve only when they cover the whole corpus: ``expected_n``
    refuses a store that does not (a partial shard's rows are one block of
    the corpus, not all of it)."""
    nbrs = getattr(store, "neighbors", None)
    if nbrs is None:
        nbrs = getattr(store, "local_neighbors", None)
    if nbrs is None:
        raise TypeError(f"record store {type(store).__name__} exposes no adjacency "
                        "(neighbors / local_neighbors)")
    if expected_n is not None and int(nbrs.shape[0]) != int(expected_n):
        raise ValueError(
            f"record store {type(store).__name__} holds {int(nbrs.shape[0])} adjacency "
            f"rows but the corpus has {int(expected_n)} — a partial (sharded) backing "
            "cannot be wrapped here")
    return nbrs


def _make_cache_tier(backing, *, vectors, neighbors, medoid: int, config: EngineConfig,
                     device: torch.device):
    """Wrap ``backing`` in the configured cache tier (or return it as-is)."""
    if config.cache_budget_bytes <= 0:
        return backing
    if config.cache_policy == ADAPTIVE_POLICY:
        cache = AdaptiveRecordCache.create(
            backing, vectors=vectors, neighbors=neighbors,
            budget_bytes=config.cache_budget_bytes, medoid=medoid,
            ema_decay=config.ema_decay, refresh_every=config.refresh_every,
            max_partitions=config.cache_partitions, seed=config.seed, device=device,
        )
        return cache if cache.n_slots > 0 else backing  # a sub-record budget leaves it off
    hot = select_hot_set(neighbors=neighbors, medoid=medoid,
                         budget_bytes=config.cache_budget_bytes, policy=config.cache_policy,
                         vectors=vectors, seed=config.seed, device=device)
    if hot.size:  # a budget below one record leaves the tier off
        return CachedRecordStore.wrap(backing, vectors=vectors, neighbors=neighbors, hot_ids=hot,
                                      policy=config.cache_policy, device=device)
    return backing


def _write_index_file(path, *, config, vectors, neighbors, codec, codes, medoid: int,
                      filters: dict, shards: int = 1) -> None:
    """Serialise every engine component into one page-aligned index file
    (plus one record segment per shard when ``shards > 1``)."""
    idx_format.write_index(
        path,
        vectors=_host_array(vectors, np.float32),
        neighbors=_host_array(neighbors, np.int32),
        pq_books=_host_array(codec.books, np.float32),
        pq_codes=_host_array(codes, np.int32),
        medoid=int(medoid),
        config=dataclasses.asdict(config),
        filters=_filter_arrays(filters),
        shards=shards,
    )


def _mean(x: torch.Tensor) -> float:
    """The float32 mean of integer counters, as ``jnp.mean`` gives it: the
    exact sum, one float32 division."""
    return float(np.float32(int(x.sum())) / np.float32(x.numel()))


@dataclasses.dataclass
class GateANNEngine:
    config: EngineConfig
    # (N, D) full-precision corpus, ground truth / debug only: a device
    # tensor on the memory tier (and after a build), the store's host
    # tensor on the host tier, the store's LAZY host view after a disk-tier
    # load (never copied to the device; the search path never reads it)
    vectors: Any
    record_store: Any
    neighbor_store: NeighborStore
    codec: pqm.PQCodec
    codes: torch.Tensor  # (N, C) int32
    medoid: int
    filters: dict
    device: torch.device

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, vectors, *, config: EngineConfig | None = None, labels=None,
              attributes=None, tag_bits=None, graph: graphm.VamanaGraph | None = None,
              index_path: str | None = None, device=None,
              timings: dict | None = None) -> "GateANNEngine":
        """Build an index from a corpus on ``device`` (the card unless the
        caller asks for the CPU): the Vamana graph (unless ``graph`` is
        given), PQ codebooks trained with a ``torch.Generator`` seeded from
        ``config.seed``, the codes, and the filter stores of the given
        metadata (``labels`` int, ``attributes`` float, ``tag_bits`` uint32
        words).  ``store_tier="disk"`` writes ``index_path`` first and serves
        the records off it.  ``timings``, when given, gains the seconds of
        the build's parts (``beam_search``, ``prune``, ``reverse_edges``,
        ``pq``)."""
        config = config or EngineConfig()
        _check_config(config)
        if config.store_tier == "disk" and index_path is None:
            raise ValueError(
                "store_tier='disk' needs index_path=... (the index file to "
                "write and serve from) — or build in memory and save()/load()")
        dev = resolve_device(device)
        vecs = _on_device(vectors, np.float32, dev).float().contiguous()
        n, d = vecs.shape
        if graph is None:
            graph = graphm.build_vamana(vecs, degree=config.degree, build_l=config.build_l,
                                        alpha=config.alpha, seed=config.seed, timings=timings)
        nbrs = _on_device(graph.neighbors, np.int32, dev).int()
        pq_chunks = min(config.pq_chunks, d)
        while d % pq_chunks:
            pq_chunks -= 1
        t0 = time.perf_counter()
        codec = pqm.train_pq(vecs, n_chunks=pq_chunks,
                             generator=torch.Generator(device=dev).manual_seed(config.seed))
        codes = pqm.encode_pq(codec, vecs)
        if timings is not None:
            graphm._sync(dev)
            timings["pq"] = timings.get("pq", 0.0) + time.perf_counter() - t0
        filters = {}
        if labels is not None:
            filters["label"] = np.asarray(labels, np.int32)
        if attributes is not None:
            filters["range"] = np.asarray(attributes, np.float32)
        if tag_bits is not None:
            filters["tags"] = np.asarray(tag_bits)
        filters = {k: _filter_store(k, a, dev) for k, a in filters.items()}
        medoid = int(graph.medoid)
        if config.store_tier == "disk":
            # persist first, then serve the slow tier straight off the file
            _write_index_file(index_path, config=config, vectors=vecs, neighbors=nbrs,
                              codec=codec, codes=codes, medoid=medoid, filters=filters)
            record_store = _open_disk_store(index_path, config, dev)
        elif config.store_tier == "host":
            record_store = HostOffloadRecordStore.create(vecs.cpu().numpy(), nbrs.cpu().numpy(),
                                                         dev)
        else:
            record_store = InMemoryRecordStore(vectors=vecs, neighbors=nbrs)
        return cls._assemble(config, vecs, nbrs, record_store, codec.books, codes, medoid,
                             filters, dev)

    @classmethod
    def from_arrays(cls, vectors, neighbors, pq_books, pq_codes, medoid: int,
                    filters: dict | None = None, config: EngineConfig | None = None, *,
                    device=None) -> "GateANNEngine":
        """An engine from the arrays an index holds (what the reference
        engine carries and ``store.format.write_index`` writes):
        vectors (N, D) f32, neighbors (N, R) i32, pq_books (C, K, D/C)
        f32, pq_codes (N, C) i32, the medoid, and per-node filter arrays
        by kind (``label`` i32, ``range`` f32, ``tags`` uint32 words).
        The disk tier serves an index file: use ``load``."""
        dev = resolve_device(device)
        config = config or EngineConfig()
        _check_config(config)
        if config.store_tier == "disk":
            raise ValueError("store_tier='disk' serves an index file: "
                             "use GateANNEngine.load(path, store_tier='disk')")
        if config.store_tier == "host":
            record_store = HostOffloadRecordStore.create(
                np.asarray(vectors, np.float32), np.asarray(neighbors, np.int32), dev)
            vecs, nbrs = record_store.vectors, record_store.neighbors
        else:
            vecs = _tensor(vectors, np.float32, dev)
            nbrs = _tensor(neighbors, np.int32, dev)
            record_store = InMemoryRecordStore(vectors=vecs, neighbors=nbrs)
        filters = {k: _filter_store(k, a, dev) for k, a in (filters or {}).items()}
        return cls._assemble(config, vecs, nbrs, record_store, pq_books, pq_codes, medoid,
                             filters, dev)

    @classmethod
    def _assemble(cls, config, vectors, neighbors, record_store, pq_books, pq_codes, medoid,
                  filters: dict, dev) -> "GateANNEngine":
        """The fast tier on ``dev`` beside a given record store, wrapped in
        the configured cache tier."""
        books = _on_device(pq_books, np.float32, dev)
        codes = _on_device(pq_codes, np.int32, dev)
        _check_ranges(vectors, neighbors, books, codes, int(medoid))
        record_store = _make_cache_tier(
            record_store, vectors=vectors, neighbors=_store_neighbors(record_store),
            medoid=int(medoid), config=config, device=dev)
        return cls(
            config=config,
            vectors=vectors,
            record_store=record_store,
            neighbor_store=NeighborStore.from_graph(
                _on_device(neighbors[:, : config.r_max], np.int32, dev), config.r_max),
            codec=pqm.PQCodec(books=books, n_chunks=int(books.shape[0]),
                              n_centroids=int(books.shape[1])),
            codes=codes,
            medoid=int(medoid),
            filters=filters,
            device=dev,
        )

    # -- persistence -------------------------------------------------------
    def save(self, path: str, *, shards: int = 1) -> None:
        """Write the whole index (records, graph, PQ, filters, config) to one
        page-aligned file (``store.format``) that either package loads.
        Cache tiers are runtime state: the backing store's adjacency is
        written.  ``shards=k`` splits the record sectors into k segment
        files."""
        backing = self.record_store
        while isinstance(backing, CACHE_TIERS):
            backing = backing.backing
        _write_index_file(
            path, config=self.config, vectors=self.vectors,
            neighbors=_store_neighbors(backing, int(self.vectors.shape[0])),
            codec=self.codec, codes=self.codes, medoid=self.medoid,
            filters=self.filters, shards=shards,
        )

    @classmethod
    def load(cls, path: str, config_overrides: dict | None = None, *, warm_disk: bool = False,
             faults=None, device=None, **overrides) -> "GateANNEngine":
        """Restore an engine from a saved index file (either package's
        writer) onto ``device`` — the card unless the caller asks for the
        CPU.  No graph build, no PQ training.  The saved config is the
        default; overrides change the runtime knobs (``r_max``,
        ``store_tier``, the disk tier's I/O knobs, ``cache_*``).

        ``store_tier="disk"`` serves records straight off the file with
        measured I/O; ``warm_disk=True`` then re-reads the record files on
        a background thread to re-populate the page cache.  ``faults=``
        attaches a ``store.FaultPlan`` to the disk tier's reads (testing
        only) and is refused on any other tier.  An adaptive cache tier
        starts from its cold-start seed: learned counters are carried only
        by ``export_state`` / ``restore_state``."""
        dev = resolve_device(device)
        idx = idx_format.read_index(path)
        known = {f.name for f in dataclasses.fields(EngineConfig)}
        user = {**(config_overrides or {}), **overrides}
        unknown = set(user) - known
        if unknown:
            raise ValueError(
                f"unknown EngineConfig override(s) {sorted(unknown)}; "
                f"valid fields: {sorted(known)}"
            )
        # stored configs may carry fields of other format versions: tolerate
        # those, but never drop an explicit override
        cfg = {k: v for k, v in (idx.header.config or {}).items() if k in known}
        cfg.update(user)
        config = EngineConfig(**cfg)
        _check_config(config)
        filters = {kind: idx.filter_array(kind) for kind in idx.filter_kinds()}
        if config.store_tier != "disk":
            if faults is not None:
                raise ValueError("faults= wraps the disk tier's read path; this load "
                                 f"resolves to store_tier={config.store_tier!r}")
            return cls.from_arrays(idx.vectors(), idx.neighbors(), idx.pq_books(),
                                   idx.pq_codes(), idx.header.medoid, filters, config,
                                   device=dev)
        store = _open_disk_store(path, config, dev, faults=faults)
        if warm_disk:
            store.warm(background=True)
        # the store's lazy host view: the corpus stays on disk
        return cls._assemble(config, store.vectors, idx.neighbors(), store, idx.pq_books(),
                             idx.pq_codes(), idx.header.medoid,
                             {k: _filter_store(k, a, dev) for k, a in filters.items()}, dev)

    # -- cache tier --------------------------------------------------------
    def with_cache(self, budget_bytes: int, *, policy: str | None = None,
                   refresh_every: int | None = None, ema_decay: float | None = None,
                   cache_partitions: int | None = None) -> "GateANNEngine":
        """Re-wrap the slow tier at a new cache budget — no index rebuild.

        The graph, PQ codes and filter stores are shared with ``self``.
        ``budget_bytes=0`` returns an engine without the cache tier;
        ``policy`` is ``visit_freq``, ``bfs`` or ``adaptive``, and the other
        keywords override the adaptive knobs of ``EngineConfig``.
        """
        backing = self.record_store
        if isinstance(backing, CACHE_TIERS):
            backing = backing.backing
        cfg = dataclasses.replace(
            self.config,
            cache_budget_bytes=budget_bytes,
            cache_policy=policy or self.config.cache_policy,
            refresh_every=self.config.refresh_every if refresh_every is None else refresh_every,
            ema_decay=self.config.ema_decay if ema_decay is None else ema_decay,
            cache_partitions=(self.config.cache_partitions if cache_partitions is None
                              else cache_partitions),
        )
        _check_config(cfg)
        store = _make_cache_tier(
            backing, vectors=self.vectors,
            neighbors=_store_neighbors(backing, int(self.vectors.shape[0])),
            medoid=self.medoid, config=cfg, device=self.device)
        return dataclasses.replace(self, config=cfg, record_store=store)

    # -- search ------------------------------------------------------------
    def make_filter(self, kind: str | None, params) -> CheckFn:
        if kind is None:
            return match_all(int(self.codes.shape[0]))
        f = self.filters[kind]
        return f.bind(*params) if isinstance(params, tuple) else f.bind(params)

    def search(self, queries, *, filter_kind: str | None = None, filter_params=None,
               search_config: searchm.SearchConfig | None = None) -> searchm.SearchOutput:
        cfg = search_config or searchm.SearchConfig(use_fused_kernel=self.config.use_fused_kernel)
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device).contiguous()
        store = self.record_store
        visit_counts = bucket = None
        adaptive = isinstance(store, AdaptiveRecordCache)
        if adaptive:
            # between-batch refresh if the cadence came due, then the
            # snapshot of this filter bucket, with live visit counters
            store.maybe_refresh()
            bucket = filter_bucket(filter_kind, filter_params)
            store = store.store_for(bucket)
            visit_counts = torch.zeros((int(self.codes.shape[0]),), dtype=torch.float32,
                                       device=self.device)
        cached_mask = store.cached_mask if isinstance(store, CachedRecordStore) else None
        # the pipelined loop needs the store's asynchronous pair (the disk
        # tier, cached or not); stores without it run the synchronous loop
        submit = drain = None
        if cfg.pipeline_depth > 1:
            submit, drain = getattr(store, "submit", None), getattr(store, "drain", None)
            if submit is None or drain is None:
                submit = drain = None
        reg = obs.default_registry()
        reg.counter("search.dispatch", mode=cfg.mode, tier=self.config.store_tier,
                    pipelined="1" if submit is not None else "0").inc()
        try:
            with obs.trace.span("engine.search", mode=cfg.mode):
                out = searchm.filtered_search(
                    store=store,
                    neighbor_store=self.neighbor_store,
                    filter_check=self.make_filter(filter_kind, filter_params),
                    lut=pqm.build_lut(self.codec, q),
                    codes=self.codes,
                    entry=torch.tensor(self.medoid, dtype=torch.int32, device=self.device),
                    queries=q,
                    config=cfg,
                    cached_mask=cached_mask,
                    visit_counts=visit_counts,
                    submit=submit,
                    drain=drain,
                )
                if reg.enabled:  # the only host copy telemetry adds
                    obs.stats.record_search_stats(reg, out.stats, mode=cfg.mode,
                                                  tier=self.config.store_tier)
        except BaseException:
            # a failure with pipelined rounds in flight: their tokens would
            # pin reader slots until close(), so drain or cancel them here
            if submit is not None:
                self.abandon_pending_io()
            raise
        if adaptive:  # fold this batch's counters; the refresh runs between batches
            self.record_store.observe(bucket, out.visit_counts)
        return out

    def warm(self, queries, *, filter_kind: str | None = None, filter_params=None,
             search_config: searchm.SearchConfig | None = None) -> searchm.SearchOutput:
        """Prime the adaptive cache: search, then refresh at once.  On a
        static-cache (or uncached) engine this is just ``search``."""
        out = self.search(queries, filter_kind=filter_kind, filter_params=filter_params,
                          search_config=search_config)
        if isinstance(self.record_store, AdaptiveRecordCache):
            self.record_store.refresh()
        return out

    def maybe_refresh(self) -> bool:
        """Refresh the adaptive hot sets if the cadence is due."""
        if isinstance(self.record_store, AdaptiveRecordCache):
            return self.record_store.maybe_refresh()
        return False

    # -- measured I/O ------------------------------------------------------
    def measured_store(self) -> DiskRecordStore | None:
        """The slow tier under any cache tiers if it measures real I/O (the
        disk tier), else None."""
        store = self.record_store
        while isinstance(store, CACHE_TIERS):
            store = store.backing
        return store if isinstance(store, DiskRecordStore) else None

    def io_counters(self) -> dict:
        """Measured read counters of the slow tier ({} on the other tiers)."""
        store = self.measured_store()
        return store.io_counters() if store is not None else {}

    def abandon_pending_io(self) -> int:
        """Drain or cancel submitted-but-undrained pipelined rounds
        (``DiskRecordStore.abandon_pending``); 0 on the other tiers."""
        store = self.measured_store()
        return store.abandon_pending() if store is not None else 0

    # -- reporting ---------------------------------------------------------
    def memory_report(self) -> dict:
        n, d = self.vectors.shape
        rep = {
            "n": int(n),
            "dim": int(d),
            "pq_bytes": int(self.codes.shape[0] * self.codes.shape[1]),
            "neighbor_store_bytes": self.neighbor_store.memory_bytes(),
            "filter_store_bytes": {k: f.memory_bytes() for k, f in self.filters.items()},
        }
        store = self.record_store
        if isinstance(store, CACHE_TIERS):
            rep["cache_nodes"] = store.n_cached
            rep["cache_bytes"] = store.cache_bytes()
            rep["cache_device_bytes"] = store.device_bytes()
            rep["cache_policy"] = store.policy
            if isinstance(store, AdaptiveRecordCache):
                rep["cache_slots"] = store.n_slots
                rep["cache_partitions"] = len(store.partitions)
                rep["cache_refreshes"] = store.n_refreshes
            store = store.backing
        if isinstance(store, InMemoryRecordStore):
            rep["record_tier"] = "memory"
            rep["record_tier_bytes"] = store.record_bytes()
        elif isinstance(store, DiskRecordStore):
            # on-disk footprint + measured (not modeled) read counters
            rep["record_tier"] = "disk"
            rep["record_tier_bytes"] = store.record_bytes()
            rep["disk_path"] = store.path
            rep["disk_index_bytes"] = store.index_bytes()
            rep["disk_sector_bytes"] = store.sector_bytes
            rep["disk_pages_read"] = store.pages_read
            rep["disk_bytes_read"] = store.bytes_read
            rep["disk_io_mode"] = store.io_mode
            rep["disk_shards"] = store.n_shards
            rep["disk_syscalls"] = store.syscalls
            rep["disk_unique_sectors_read"] = store.unique_sectors_read
            rep["disk_inflight_depth_max"] = store.inflight_depth_max
            rep["disk_overlapped_rounds"] = store.overlapped_rounds
            rep["disk_warmed_bytes"] = store.warmed_bytes
            rep["disk_max_gap_sectors"] = store.max_gap_sectors
        elif isinstance(store, HostOffloadRecordStore):
            rep["record_tier"] = "host"
        return rep

    def _refresh_amortized_us(self, stats: searchm.SearchStats, cost_model: IOCostModel) -> float:
        """Per-query share of adaptive hot-set refresh cost (0 if static)."""
        store = self.record_store
        if not isinstance(store, AdaptiveRecordCache):
            return 0.0
        return cost_model.refresh_amortized_us(store.n_slots * store.last_refresh_sets,
                                               store.refresh_every, int(stats.n_ios.shape[0]))

    def modeled_qps(self, stats: searchm.SearchStats, *, n_threads: int = 32,
                    cost_model: IOCostModel = DEFAULT_COST_MODEL) -> float:
        """The cost model's QPS for these measured counts (its constants
        are the paper's SSD figures, not this machine's)."""
        return cost_model.qps(
            _mean(stats.n_ios), _mean(stats.n_tunnels), n_threads=n_threads,
            n_exact=_mean(stats.n_exact), n_cache_hits=_mean(stats.n_cache_hits),
            refresh_amortized_us=self._refresh_amortized_us(stats, cost_model),
        )

    def modeled_latency_us(self, stats: searchm.SearchStats, *,
                           cost_model: IOCostModel = DEFAULT_COST_MODEL,
                           pipeline_depth: int | None = None, overlap_depth: int = 1) -> float:
        """Modeled per-query latency.  ``pipeline_depth`` is W (in-flight
        reads within a round); ``overlap_depth`` is the software-pipeline
        depth across rounds (``SearchConfig.pipeline_depth``)."""
        return cost_model.latency_us(
            _mean(stats.n_ios), _mean(stats.n_tunnels), _mean(stats.n_exact),
            pipeline_depth=pipeline_depth, n_cache_hits=_mean(stats.n_cache_hits),
            refresh_amortized_us=self._refresh_amortized_us(stats, cost_model),
            overlap_depth=overlap_depth,
        )


def recall_at_k(result_ids, gt_ids, k: int = 10) -> float:
    """Recall@k against exact filtered ground truth (rows -1-padded)."""
    res = (result_ids.cpu().numpy() if isinstance(result_ids, torch.Tensor)
           else np.asarray(result_ids))[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    gt_valid = gt >= 0
    found = (gt[:, :, None] == res[:, None, :]) & (res[:, None, :] >= 0)
    hits = int((found.any(axis=2) & gt_valid).sum())
    return hits / max(int(gt_valid.sum()), 1)
