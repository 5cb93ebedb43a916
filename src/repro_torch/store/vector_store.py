"""Record stores — the expensive tier holding full-precision records.

Port of ``repro.store.vector_store``: a *record* is the node's
full-precision vector with its full adjacency list (DiskANN's 4 KB SSD
sector).  Three tiers live here:

  * ``InMemoryRecordStore`` — records on the engine's device; a fetch is
    a device gather;
  * ``ShardedRecordStore`` — records split by rows over the ``model``
    process group of a mesh (``launch/mesh.py``); a fetch is a masked
    local gather and one ``all_reduce`` over that group, the reference's
    ``psum`` over ``model``;
  * ``HostOffloadRecordStore`` — records in pinned host memory, GateANN's
    slow tier where the card has no SSD beside it; on the card a fetch is
    one ``kernels.host_gather`` launch that reads only the live rows (the
    ones the filter gate passed) through the records' device-mapped
    address, so only live rows cross the link, with no host sync and no
    host gather.  Where the reference falls back silently to an in-memory
    store when its backend has no pinned host memory, the port pins or
    raises.  On the CPU it is a CPU tensor store.

The disk tier is ``store/disk.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.kernels import host_gather as hgk
from repro_torch.store.format import record_nbytes


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
class ShardedRecordStore:
    """Records split row-wise over the ``model`` axis of a mesh.

    Each rank holds rows [shard * rows_per_shard, ...) of the corpus,
    where ``shard`` is its rank in ``group``.  A fetch takes the id beam
    (the same on every rank of the group), gathers the rows this rank
    owns (zeros elsewhere, the adjacency shifted by +1 so that -1 padding
    sums right), and one ``all_reduce(SUM)`` over ``group`` materialises
    the records on every rank; the shift is undone and ids < 0 give -1
    rows.  Collective bytes a fetch: B * W * (D + R) * 4.

    The vectors travel as their int32 bits beside the adjacency, so one
    collective carries both and the sum is exact: one rank owns each row
    and the others add 0.  (The reference's float ``psum`` turns a -0.0
    component into +0.0; here it keeps its sign.  Squared distances are
    the same either way.)

    ``group=None`` is one shard: ``fetch`` is the plain masked gather with
    no collective — the form ``engine.with_cache`` and the CPU tests wrap.
    """

    local_vectors: torch.Tensor  # (rows, D) float32 — this rank's rows
    local_neighbors: torch.Tensor  # (rows, R) int32, global ids, -1 padded
    rows_per_shard: int
    group: Any = None  # the mesh's ``model`` process group; None: one shard

    @property
    def degree(self) -> int:
        return int(self.local_neighbors.shape[1])

    @property
    def shard(self) -> int:
        """This rank's index along the group: the shard of rows it holds."""
        return 0 if self.group is None else dist.get_rank(self.group)

    def fetch(self, ids: torch.Tensor):
        """(B, W) ids -> (vecs (B, W, D), nbrs (B, W, R)) on every rank of
        the group; ids < 0 give zero vectors and -1 neighbour rows."""
        rows = self.rows_per_shard
        local = ids - self.shard * rows
        mine = ((ids >= 0) & (local >= 0) & (local < rows))[..., None]
        safe = local.clamp(0, self.local_vectors.shape[0] - 1).long()
        vecs = torch.where(mine, self.local_vectors[safe], 0.0)
        nbrs = torch.where(mine, self.local_neighbors[safe] + 1, 0)  # shift: -1 pad sums right
        if self.group is not None:
            d = vecs.shape[-1]
            both = torch.cat([vecs.view(torch.int32), nbrs], dim=-1)
            dist.all_reduce(both, op=dist.ReduceOp.SUM, group=self.group)
            vecs, nbrs = both[..., :d].contiguous().view(torch.float32), both[..., d:]
        nbrs = torch.where(ids[..., None] >= 0, nbrs - 1, -1)  # unshift: unowned/-1 rows -> -1
        return vecs, nbrs

    @staticmethod
    def shard_arrays(vectors: np.ndarray, neighbors: np.ndarray, n_shards: int):
        """Pad host arrays to ``n_shards`` equal row blocks (zero vectors,
        -1 adjacency): returns (vectors, neighbors, rows_per_shard), shard
        s being rows [s * rows_per_shard, (s + 1) * rows_per_shard)."""
        n = vectors.shape[0]
        rows = -(-n // n_shards)
        pad = rows * n_shards - n
        v = np.pad(vectors, ((0, pad), (0, 0)))
        g = np.pad(neighbors, ((0, pad), (0, 0)), constant_values=-1)
        return v, g, rows


class _FetchTally:
    """The host tier's fetches since the engine last published them: their
    host seconds (while the process tracer is on), and the rows already
    published."""

    __slots__ = ("seconds", "published")

    def __init__(self):
        self.seconds = 0.0
        self.published = 0


@dataclasses.dataclass(frozen=True)
class HostOffloadRecordStore:
    """Records in host memory, pinned when ``device`` is a card.

    Telemetry, published once a call by ``publish`` (the engine calls it
    after the call's stats copy): a ``store.fetch{tier=host}`` span of the
    call's fetches' host seconds while the process tracer is on, and with
    the registry enabled the counters ``store.fetch_rows{tier=host}`` and
    ``store.fetch_bytes{tier=host}``: the rows the tier moved to the device
    (counted where they are read, by the kernel on the card, in the fetches
    made while the registry is enabled) and their bytes, D x 4 + R x 4 a
    row.
    """

    vectors: torch.Tensor  # (N, D) float32 on the host, pinned when device is a card
    neighbors: torch.Tensor  # (N, R) int32 on the host, pinned likewise
    device: torch.device
    # () int64 on the device: rows fetched so far with the registry enabled
    rows_read: torch.Tensor
    tally: _FetchTally = dataclasses.field(default_factory=_FetchTally, compare=False,
                                           repr=False)

    @classmethod
    def create(cls, vectors, neighbors, device) -> "HostOffloadRecordStore":
        """Records from host arrays or tensors, held on the host: pinned
        for a CUDA ``device`` (``pin_memory`` raises where it cannot)."""
        device = torch.device(device)
        vecs = torch.from_numpy(np.array(vectors, dtype=np.float32))
        nbrs = torch.from_numpy(np.array(neighbors, dtype=np.int32))
        if device.type == "cuda":
            vecs, nbrs = vecs.pin_memory(), nbrs.pin_memory()
        return cls(vectors=vecs, neighbors=nbrs, device=device,
                   rows_read=torch.zeros((), dtype=torch.int64, device=device))

    @property
    def degree(self) -> int:
        return int(self.neighbors.shape[1])

    @property
    def row_bytes(self) -> int:
        """Bytes one fetched record moves: its vector and its adjacency."""
        return self.vectors.shape[1] * 4 + self.degree * 4

    def fetch(self, ids: torch.Tensor):
        """(B, W) ids on the device -> (vecs (B, W, D), nbrs (B, W, R)) on
        the device; ids < 0 give zero vectors and -1 neighbor rows."""
        rows = self.rows_read if obs.default_registry().enabled else None
        timed = obs.trace.default_tracer().enabled
        t0 = time.perf_counter() if timed else 0.0
        out = hgk.host_gather(self.vectors, self.neighbors, ids, rows)
        if timed:
            self.tally.seconds += time.perf_counter() - t0
        return out

    def publish(self, reg) -> None:
        """Once a call, after its stats copy: the span of its fetches, and
        with ``reg`` enabled the rows and bytes fetched since the last
        publish.  Reading the device count then waits for nothing: the
        stats copy has waited for the call's work."""
        t = self.tally
        if t.seconds:
            obs.trace.record("store.fetch", t.seconds, tier="host")
            t.seconds = 0.0
        if not reg.enabled:
            return
        rows = int(self.rows_read)
        new, t.published = rows - t.published, rows
        reg.counter("store.fetch_rows", tier="host").inc(new)
        reg.counter("store.fetch_bytes", tier="host").inc(new * self.row_bytes)

    def record_bytes(self) -> int:
        n, d = self.vectors.shape
        return n * record_nbytes(d, int(self.neighbors.shape[1]))
