"""GateANN engine — the port's public API.

Port of ``repro.core.engine``: load a saved index (or take the arrays an
index holds), then search with any predicate and any mode.  The engine
owns the storage tiers of §3:

  fast tier ("memory"):   PQ codes, neighbor store, filter store — on the
                          engine's device in every tier
  slow tier:              the record store (full vectors + full adjacency),
                          by ``EngineConfig.store_tier``:
                            "memory" — on the device (``InMemoryRecordStore``)
                            "host"   — pinned host memory (``HostOffloadRecordStore``)
                            "disk"   — read off the index file with measured
                                       I/O (``DiskRecordStore``)

Everything else lives on one device.  ``device=None`` means the card: it
resolves to ``cuda`` and raises when no CUDA device is present; tests
pass ``device="cpu"`` and run the kernels' plain versions.

On the disk tier ``pipeline_depth > 1`` runs the pipelined loop, which
overlaps each round's record read with the next rounds' traversal.

Not ported yet, and refused with ``NotImplementedError``: the cache
tiers (ROADMAP Queue 1 item 6) and building or saving an index (item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import pq as pqm
from repro_torch.core import search as searchm
from repro_torch.core.filter_store import (
    CheckFn, EqualityFilter, RangeFilter, SubsetFilter, as_int32_bits, match_all,
)
from repro_torch.core.neighbor_store import NeighborStore
from repro_torch.device import resolve_device
from repro_torch.store import format as idx_format
from repro_torch.store.disk import DiskRecordStore, RetryPolicy
from repro_torch.store.vector_store import HostOffloadRecordStore, InMemoryRecordStore

STORE_TIERS = ("memory", "host", "disk")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The fields of the reference's configuration that the port serves.
    A saved index's config may hold more (build and cache knobs);
    ``load`` drops those, and refuses them as overrides."""

    r_max: int = 16  # in-memory neighbors per node (runtime knob)
    store_tier: str = "memory"  # memory | host | disk (disk serves an index file)
    cache_budget_bytes: int = 0  # cache tier (0 = off; only 0 is ported)
    use_fused_kernel: bool = False  # default for SearchConfig.use_fused_kernel
    # disk tier: bound on preadv gap bridging, in sectors (negative =
    # unbounded, 0 = never bridge)
    max_gap_sectors: int = -1
    # disk tier resilience: transient read errors retry io_retries times
    # with exponential backoff from io_retry_backoff_s; a round's reads may
    # take at most io_round_deadline_s (0 = no deadline); on exhaustion
    # io_on_error="fail" raises, "degrade" serves the slots as tunneled
    # nodes (counted in SearchStats.n_degraded)
    io_retries: int = 0
    io_retry_backoff_s: float = 1e-3
    io_round_deadline_s: float = 0.0
    io_on_error: str = "fail"
    seed: int = 0  # seeds the retry jitter


def _check_ported(config: EngineConfig) -> None:
    if config.store_tier not in STORE_TIERS:
        raise ValueError(f"store_tier={config.store_tier!r} not in {STORE_TIERS}")
    if config.cache_budget_bytes > 0:
        raise NotImplementedError(
            "cache_budget_bytes > 0: the cache tiers come with ROADMAP Queue 1 item 6")


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
        return EqualityFilter(labels=_tensor(arr, np.int32, device))
    if kind == "range":
        return RangeFilter(values=_tensor(arr, np.float32, device))
    if kind == "tags":
        return SubsetFilter(tag_bits=as_int32_bits(arr, device))
    raise ValueError(f"unknown filter kind {kind!r} (label, range or tags)")


@dataclasses.dataclass
class GateANNEngine:
    config: EngineConfig
    # (N, D) full-precision corpus, ground truth / debug only: a device
    # tensor on the memory tier, the store's host tensor on the host tier,
    # the store's LAZY host view on the disk tier (never copied to the
    # device; the search path never reads it)
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
        _check_ported(config)
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
        return cls._assemble(config, vecs, nbrs, record_store, pq_books, pq_codes, medoid,
                             filters, dev)

    @classmethod
    def _assemble(cls, config, vectors, neighbors, record_store, pq_books, pq_codes, medoid,
                  filters, dev) -> "GateANNEngine":
        """The fast tier on ``dev`` beside a given record store."""
        books = _tensor(pq_books, np.float32, dev)
        codes = _tensor(pq_codes, np.int32, dev)
        _check_ranges(vectors, neighbors, books, codes, int(medoid))
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
            filters={k: _filter_store(k, a, dev) for k, a in (filters or {}).items()},
            device=dev,
        )

    @classmethod
    def load(cls, path: str, config_overrides: dict | None = None, *, warm_disk: bool = False,
             faults=None, device=None, **overrides) -> "GateANNEngine":
        """Restore an engine from a saved index file (either package's
        writer) onto ``device`` — the card unless the caller asks for the
        CPU.  The saved config's served fields are the default (the rest
        is dropped); overrides change them (``r_max``, ``store_tier``,
        the disk tier's I/O knobs).

        ``store_tier="disk"`` serves records straight off the file with
        measured I/O; ``warm_disk=True`` then re-reads the record files on
        a background thread to re-populate the page cache.  ``faults=``
        attaches a ``store.FaultPlan`` to the disk tier's reads (testing
        only) and is refused on any other tier."""
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
        cfg = {k: v for k, v in (idx.header.config or {}).items() if k in known}
        cfg.update(user)
        config = EngineConfig(**cfg)
        _check_ported(config)
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
                             idx.pq_codes(), idx.header.medoid, filters, dev)

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
        # the pipelined loop needs the store's asynchronous pair (the disk
        # tier); stores without it run the synchronous loop at any depth
        submit = drain = None
        if cfg.pipeline_depth > 1:
            submit, drain = getattr(store, "submit", None), getattr(store, "drain", None)
            if submit is None or drain is None:
                submit = drain = None
        try:
            return searchm.filtered_search(
                store=store,
                neighbor_store=self.neighbor_store,
                filter_check=self.make_filter(filter_kind, filter_params),
                lut=pqm.build_lut(self.codec, q),
                codes=self.codes,
                entry=torch.tensor(self.medoid, dtype=torch.int32, device=self.device),
                queries=q,
                config=cfg,
                submit=submit,
                drain=drain,
            )
        except BaseException:
            # a failure with pipelined rounds in flight: their tokens would
            # pin reader slots until close(), so drain or cancel them here
            if submit is not None:
                self.abandon_pending_io()
            raise

    # -- measured I/O ------------------------------------------------------
    def measured_store(self) -> DiskRecordStore | None:
        """The slow tier if it measures real I/O (the disk tier), else None."""
        store = self.record_store
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


def recall_at_k(result_ids, gt_ids, k: int = 10) -> float:
    """Recall@k against exact filtered ground truth (rows -1-padded)."""
    res = (result_ids.cpu().numpy() if isinstance(result_ids, torch.Tensor)
           else np.asarray(result_ids))[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    gt_valid = gt >= 0
    found = (gt[:, :, None] == res[:, None, :]) & (res[:, None, :] >= 0)
    hits = int((found.any(axis=2) & gt_valid).sum())
    return hits / max(int(gt_valid.sum()), 1)
