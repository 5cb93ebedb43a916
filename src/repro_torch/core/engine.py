"""GateANN engine — the port's public API.

Port of ``repro.core.engine`` for the memory tier: load a saved index (or
take the arrays an index holds), then search with any predicate and any
mode.  The engine owns the storage tiers of §3:

  fast tier ("memory"):   PQ codes, neighbor store, filter store
  slow tier:              the record store (full vectors + full adjacency),
                          here device-resident (``InMemoryRecordStore``)

Everything lives on one device.  ``device=None`` means the card: it
resolves to ``cuda`` and raises when no CUDA device is present; tests
pass ``device="cpu"`` and run the kernels' plain versions.

Not ported yet, and refused with ``NotImplementedError``: the host and
disk record tiers and fault injection (ROADMAP Queue 1 item 5), the
cache tiers (item 6), and building or saving an index (item 7).
"""
from __future__ import annotations

import dataclasses

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
from repro_torch.store.vector_store import InMemoryRecordStore


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The fields of the reference's configuration that the memory tier
    serves.  A saved index's config may hold more (build, disk-tier and
    cache knobs); ``load`` drops those, and refuses them as overrides."""

    r_max: int = 16  # in-memory neighbors per node (runtime knob)
    store_tier: str = "memory"  # only "memory" is ported
    cache_budget_bytes: int = 0  # cache tier (0 = off; only 0 is ported)
    use_fused_kernel: bool = False  # default for SearchConfig.use_fused_kernel


def _check_ported(config: EngineConfig) -> None:
    if config.store_tier != "memory":
        raise NotImplementedError(
            f"store_tier={config.store_tier!r}: only the memory tier is ported; the host "
            "and disk tiers come with ROADMAP Queue 1 item 5")
    if config.cache_budget_bytes > 0:
        raise NotImplementedError(
            "cache_budget_bytes > 0: the cache tiers come with ROADMAP Queue 1 item 6")


def _tensor(a, dtype, device: torch.device) -> torch.Tensor:
    """A host array (memmap views included) as a tensor of its own on ``device``."""
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def _check_ranges(vecs, nbrs, books, codes, medoid: int) -> None:
    """Ids and codes index device memory inside the kernels: refuse any
    out of range rather than read out of bounds."""
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
    vectors: torch.Tensor  # (N, D) full-precision corpus (ground truth / debug)
    record_store: InMemoryRecordStore
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
        by kind (``label`` i32, ``range`` f32, ``tags`` uint32 words)."""
        dev = resolve_device(device)
        config = config or EngineConfig()
        _check_ported(config)

        vecs = _tensor(vectors, np.float32, dev)
        nbrs = _tensor(neighbors, np.int32, dev)
        books = _tensor(pq_books, np.float32, dev)
        codes = _tensor(pq_codes, np.int32, dev)
        _check_ranges(vecs, nbrs, books, codes, int(medoid))
        return cls(
            config=config,
            vectors=vecs,
            record_store=InMemoryRecordStore(vectors=vecs, neighbors=nbrs),
            neighbor_store=NeighborStore.from_graph(nbrs, config.r_max),
            codec=pqm.PQCodec(books=books, n_chunks=int(books.shape[0]),
                              n_centroids=int(books.shape[1])),
            codes=codes,
            medoid=int(medoid),
            filters={k: _filter_store(k, a, dev) for k, a in (filters or {}).items()},
            device=dev,
        )

    @classmethod
    def load(cls, path: str, config_overrides: dict | None = None, *, device=None,
             faults=None, **overrides) -> "GateANNEngine":
        """Restore an engine from a saved index file (either package's
        writer) onto ``device`` — the card unless the caller asks for the
        CPU.  The saved config's served fields are the default (the rest
        is dropped); overrides change them (e.g. ``r_max``)."""
        if faults is not None:
            raise NotImplementedError(
                "faults= wraps the disk tier's reads; it comes with ROADMAP Queue 1 item 5")
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
        return cls.from_arrays(
            idx.vectors(), idx.neighbors(), idx.pq_books(), idx.pq_codes(), idx.header.medoid,
            {kind: idx.filter_array(kind) for kind in idx.filter_kinds()},
            EngineConfig(**cfg), device=dev,
        )

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
        return searchm.filtered_search(
            store=self.record_store,
            neighbor_store=self.neighbor_store,
            filter_check=self.make_filter(filter_kind, filter_params),
            lut=pqm.build_lut(self.codec, q),
            codes=self.codes,
            entry=torch.tensor(self.medoid, dtype=torch.int32, device=self.device),
            queries=q,
            config=cfg,
        )

    # -- reporting ---------------------------------------------------------
    def memory_report(self) -> dict:
        n, d = self.vectors.shape
        return {
            "n": int(n),
            "dim": int(d),
            "pq_bytes": int(self.codes.shape[0] * self.codes.shape[1]),
            "neighbor_store_bytes": self.neighbor_store.memory_bytes(),
            "filter_store_bytes": {k: f.memory_bytes() for k, f in self.filters.items()},
            "record_tier": "memory",
            "record_tier_bytes": self.record_store.record_bytes(),
        }


def recall_at_k(result_ids, gt_ids, k: int = 10) -> float:
    """Recall@k against exact filtered ground truth (rows -1-padded)."""
    res = (result_ids.cpu().numpy() if isinstance(result_ids, torch.Tensor)
           else np.asarray(result_ids))[:, :k]
    gt = np.asarray(gt_ids)[:, :k]
    gt_valid = gt >= 0
    found = (gt[:, :, None] == res[:, None, :]) & (res[:, None, :] >= 0)
    hits = int((found.any(axis=2) & gt_valid).sum())
    return hits / max(int(gt_valid.sum()), 1)
