"""Neighbor store — in-memory adjacency for graph tunneling (§3.2).

Port of ``repro.core.neighbor_store``: the first ``R_max`` neighbors of
each node, copied out of the full adjacency into one contiguous
fixed-stride tensor.  ``R_max`` is a runtime knob — no index rebuild is
needed to change it.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NeighborStore:
    neighbors: torch.Tensor  # (N, R_max) int32, -1 padded

    @classmethod
    def from_graph(cls, full_neighbors: torch.Tensor, r_max: int) -> "NeighborStore":
        """Extract the first r_max columns (closest neighbors first)."""
        r = full_neighbors.shape[1]
        return cls(neighbors=full_neighbors[:, : min(r_max, r)].contiguous())

    @property
    def r_max(self) -> int:
        return int(self.neighbors.shape[1])

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, K) ids -> (B, K, R_max) neighbor ids; invalid ids -> -1 rows."""
        got = self.neighbors[ids.clamp(min=0).long()]
        return torch.where(ids[..., None] >= 0, got, -1)

    def memory_bytes(self) -> int:
        """Paper Eq. (1): N * (1 + R_max) * 4 B (the +1 models the length
        word of the on-disk record header)."""
        return int(self.neighbors.shape[0]) * (1 + self.r_max) * 4
