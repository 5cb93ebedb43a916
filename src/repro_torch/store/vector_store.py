"""Record stores — the expensive tier holding full-precision records.

Port of ``repro.store.vector_store``: a *record* is the node's
full-precision vector with its full adjacency list (DiskANN's 4 KB SSD
sector).  Two tiers live here:

  * ``InMemoryRecordStore`` — records on the engine's device; a fetch is
    a device gather;
  * ``HostOffloadRecordStore`` — records in pinned host memory; a fetch
    gathers the beam's rows on the host and copies them to the card
    through a pinned staging buffer.  Where the reference falls back
    silently to an in-memory store when its backend has no pinned host
    memory, the port pins or raises.  On the CPU it is a CPU tensor store.

The disk tier is ``store/disk.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.store.format import record_nbytes
from repro_torch.store.staging import PinnedStaging


def is_lazy_host(a) -> bool:
    """True for lazy host-resident corpus views (the disk tier's
    ``vectors``) that must never be shipped to the device wholesale —
    cache wiring gathers the hot rows on the host instead.  Covers
    memmap-backed arrays and any object flagging ``__lazy_host__``
    (the multi-segment ``LazySegmentVectors``)."""
    if getattr(a, "__lazy_host__", False):
        return True
    while isinstance(a, np.ndarray):
        if isinstance(a, np.memmap):
            return True
        if a.base is None:
            return False
        a = a.base
    return False


def _gather_rows(vectors: torch.Tensor, neighbors: torch.Tensor, ids: torch.Tensor):
    """(B, W) ids -> (vecs (B, W, D), nbrs (B, W, R)) on the records'
    device; ids < 0 give zero vectors and -1 neighbour rows."""
    ok = ids[..., None] >= 0
    safe = ids.clamp(min=0).long()
    return torch.where(ok, vectors[safe], 0.0), torch.where(ok, neighbors[safe], -1)


@dataclasses.dataclass(frozen=True)
class InMemoryRecordStore:
    vectors: torch.Tensor  # (N, D) float32
    neighbors: torch.Tensor  # (N, R) int32

    @property
    def degree(self) -> int:
        """Adjacency width R of every fetched record."""
        return int(self.neighbors.shape[1])

    def fetch(self, ids: torch.Tensor):
        """(B, W) ids -> (vecs (B, W, D), nbrs (B, W, R)); ids < 0 give
        zero vectors and -1 neighbor rows."""
        return _gather_rows(self.vectors, self.neighbors, ids)

    def record_bytes(self) -> int:
        n, d = self.vectors.shape
        return n * record_nbytes(d, int(self.neighbors.shape[1]))


@dataclasses.dataclass(frozen=True)
class HostOffloadRecordStore:
    vectors: torch.Tensor  # (N, D) float32 on the host, pinned when device is a card
    neighbors: torch.Tensor  # (N, R) int32 on the host, pinned likewise
    device: torch.device
    staging: PinnedStaging

    @classmethod
    def create(cls, vectors, neighbors, device) -> "HostOffloadRecordStore":
        """Records from host arrays or tensors, held on the host: pinned
        for a CUDA ``device`` (``pin_memory`` raises where it cannot)."""
        device = torch.device(device)
        vecs = torch.from_numpy(np.array(vectors, dtype=np.float32))
        nbrs = torch.from_numpy(np.array(neighbors, dtype=np.int32))
        if device.type == "cuda":
            vecs, nbrs = vecs.pin_memory(), nbrs.pin_memory()
        return cls(vectors=vecs, neighbors=nbrs, device=device, staging=PinnedStaging(device))

    @property
    def degree(self) -> int:
        return int(self.neighbors.shape[1])

    def _to_device(self, rows: torch.Tensor) -> torch.Tensor:
        buf = self.staging.take(tuple(rows.shape), rows.dtype)
        buf.copy_(rows)
        return self.staging.upload(buf)

    def fetch(self, ids: torch.Tensor):
        """(B, W) ids on the device -> records gathered on the host, on the
        device; ids < 0 give zero vectors and -1 neighbor rows."""
        vecs, nbrs = _gather_rows(self.vectors, self.neighbors, ids.cpu())
        if self.device.type == "cpu":
            return vecs, nbrs
        return self._to_device(vecs), self._to_device(nbrs)

    def record_bytes(self) -> int:
        n, d = self.vectors.shape
        return n * record_nbytes(d, int(self.neighbors.shape[1]))
