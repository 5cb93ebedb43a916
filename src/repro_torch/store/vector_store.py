"""Record store — the expensive tier holding full-precision records.

Port of ``repro.store.vector_store``, memory tier only: a *record* is the
node's full-precision vector with its full adjacency list (DiskANN's
4 KB SSD sector), and a fetch is a device gather.  The host, sharded and
disk tiers are later slices of the port.
"""
from __future__ import annotations

import dataclasses

import torch


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
        ok = ids[..., None] >= 0
        safe = ids.clamp(min=0).long()
        vecs = torch.where(ok, self.vectors[safe], 0.0)
        nbrs = torch.where(ok, self.neighbors[safe], -1)
        return vecs, nbrs

    def record_bytes(self) -> int:
        n, d = self.vectors.shape
        r = self.neighbors.shape[1]
        # 4 KB-aligned like DiskANN sectors
        raw = d * 4 + (r + 1) * 4
        return n * ((raw + 4095) // 4096) * 4096
