"""Filter store — O(1) in-memory predicate evaluation by node id (§3.2).

Port of ``repro.core.filter_store``.  Predicate families: equality,
range, multi-label subset and their conjunction.  ``bind`` returns a
plain closure over device tensors that maps (B, K) int32 node ids to a
(B, K) bool match mask, evaluated on whole dispatch beams.

Subset tags are uint32 bitsets in the index file; torch has no uint32
``&``/gather on the CPU, so they are held as the same bits viewed as
int32 (``&`` and ``==`` on the bit patterns mean exactly what they mean
on uint32).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

# A CheckFn maps (B, K) int32 node ids -> (B, K) bool matches.
CheckFn = Callable[[torch.Tensor], torch.Tensor]


def as_int32_bits(bits, device: torch.device) -> torch.Tensor:
    """uint32 (or int32) bitset words -> an int32 tensor of the same bits."""
    arr = bits.cpu().numpy() if isinstance(bits, torch.Tensor) else np.asarray(bits)
    if arr.dtype not in (np.uint32, np.int32):
        arr = arr.astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(device)


@dataclasses.dataclass(frozen=True)
class EqualityFilter:
    """Single fixed-width label per node (1 B/node in the paper's Table 2)."""

    labels: torch.Tensor  # (N,) int32

    def bind(self, target_labels) -> CheckFn:
        labels = self.labels
        t = torch.as_tensor(target_labels, dtype=torch.int32, device=labels.device)

        def check(ids):
            return (labels[ids.clamp(min=0).long()] == t[:, None]) & (ids >= 0)

        return check

    def memory_bytes(self) -> int:
        return int(self.labels.shape[0])  # 1 B/node logical

    def selectivity(self, target_label: int) -> float:
        return float((self.labels == target_label).float().mean())


@dataclasses.dataclass(frozen=True)
class RangeFilter:
    """Continuous attribute; per-query closed interval [lo, hi]."""

    values: torch.Tensor  # (N,) float32

    def bind(self, lo, hi=None) -> CheckFn:
        if hi is None:
            lo, hi = lo  # allow bind((lo, hi))
        values = self.values
        lo = torch.as_tensor(lo, dtype=torch.float32, device=values.device)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=values.device)

        def check(ids):
            v = values[ids.clamp(min=0).long()]
            return (v >= lo[:, None]) & (v <= hi[:, None]) & (ids >= 0)

        return check

    def memory_bytes(self) -> int:
        return int(self.values.shape[0] * 4)


@dataclasses.dataclass(frozen=True)
class SubsetFilter:
    """Multi-label bitsets, 32 tags a word: (N, n_words) int32 bit patterns.

    Query tags (B, n_words) pass node n iff q_tags ⊆ node_tags, i.e.
    (q & node) == q word-wise.
    """

    tag_bits: torch.Tensor  # (N, W) int32 (uint32 bits)

    def bind(self, query_bits) -> CheckFn:
        tag_bits = self.tag_bits
        q = as_int32_bits(query_bits, tag_bits.device)[:, None, :]

        def check(ids):
            node = tag_bits[ids.clamp(min=0).long()]  # (B, K, W)
            return torch.all((node & q) == q, dim=-1) & (ids >= 0)

        return check

    def memory_bytes(self) -> int:
        return int(self.tag_bits.shape[0] * self.tag_bits.shape[1] * 4)


@dataclasses.dataclass(frozen=True)
class AndFilter:
    parts: tuple

    def bind(self, *args) -> CheckFn:
        fns = tuple(
            p.bind(*a) if isinstance(a, tuple) else p.bind(a)
            for p, a in zip(self.parts, args)
        )

        def check(ids):
            out = fns[0](ids)
            for f in fns[1:]:
                out = out & f(ids)
            return out

        return check

    def memory_bytes(self) -> int:
        return sum(p.memory_bytes() for p in self.parts)


def pack_tags(tag_lists: Sequence[Sequence[int]], vocab_size: int) -> np.ndarray:
    """Pack per-node tag lists into uint32 bitset rows (N, ceil(V/32))."""
    n_words = (vocab_size + 31) // 32
    out = np.zeros((len(tag_lists), n_words), dtype=np.uint32)
    for i, tags in enumerate(tag_lists):
        for t in tags:
            out[i, t // 32] |= np.uint32(1) << np.uint32(t % 32)
    return out


pack_query_tags = pack_tags


def match_all(n: int | None = None) -> CheckFn:
    """Unfiltered search (selectivity 1.0)."""

    def check(ids):
        return ids >= 0

    return check
