"""Hot-node record cache — the middle storage tier between fast and slow.

Port of ``repro.store.cache``.  Tunnelling removes record reads for
filter-*failing* nodes; every filter-passing node still pays a full
slow-tier fetch — including the hot nodes near the medoid that nearly
every query traverses.  A static cache of frequently visited records is
the standard complementary I/O reduction in SSD-graph systems (DiskANN's
``num_nodes_to_cache``, PipeANN's BFS cache): the full records of the
hottest nodes stay on the device, so a hit costs a gather instead of a
slow-tier read.

``CachedRecordStore`` wraps any record store of the port's protocol
(``fetch``, ``degree``, and on the disk tier the asynchronous
``submit`` / ``drain`` pair).  The hot set is chosen once — by visit
frequency over sample traversals (``visit_freq``) or by BFS depth from
the medoid (``bfs``).  The search loop asks ``cached_mask`` which
dispatched ids are hits and counts them as ``n_cache_hits`` instead of
``n_ios``; the backing store only ever sees the misses (hit ids are
masked to -1 before the slow-tier fetch, so a hit costs no slow-tier
read).

Telemetry, as the reference's: every ``wrap`` adds one to the
``cache.materializations{policy}`` counter of the process registry (the
adaptive cache refreshes through ``wrap``, so this counts its hot-set
rebuilds too).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.store.format import record_nbytes
from repro_torch.store.vector_store import is_lazy_host

CACHE_POLICIES = ("visit_freq", "bfs")

__all__ = ["CACHE_POLICIES", "CachedRecordStore", "bfs_hot_set", "record_nbytes",
           "select_hot_set", "visit_freq_hot_set"]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def bfs_hot_set(neighbors, medoid: int, n_slots: int) -> np.ndarray:
    """First ``n_slots`` nodes in BFS order from the medoid.

    This is the PipeANN/DiskANN warm-up policy: the nodes every query
    crosses first are the ones closest (in hops) to the entry point.
    """
    nbrs = _host(neighbors)
    n = nbrs.shape[0]
    n_slots = min(n_slots, n)
    if n_slots <= 0:
        return np.zeros((0,), np.int32)
    seen = np.zeros(n, bool)
    order: list[int] = []
    frontier = np.asarray([int(medoid)])
    seen[frontier] = True
    while len(order) < n_slots and frontier.size:
        take = min(n_slots - len(order), frontier.size)
        order.extend(frontier[:take].tolist())
        nxt = nbrs[frontier].ravel()
        nxt = nxt[nxt >= 0]
        nxt = np.unique(nxt)
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return np.asarray(order[:n_slots], np.int32)


def visit_freq_hot_set(
    vectors,
    neighbors,
    medoid: int,
    n_slots: int,
    *,
    n_samples: int = 64,
    search_l: int = 64,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Top ``n_slots`` nodes by visit frequency over sample traversals.

    Runs unfiltered beam searches for ``n_samples`` perturbed corpus
    vectors (numpy draws, the reference's bits) and counts how often each
    node is expanded; ties and unfilled slots fall back to BFS order from
    the medoid, so small caches always hold the medoid's neighbourhood.
    The traversals run on the device of ``vectors`` when it is a tensor,
    else on ``device`` (the card unless the caller asks for the CPU).
    """
    from repro_torch.core.graph import beam_search_batch

    n = int(neighbors.shape[0])
    n_slots = min(n_slots, n)
    if n_slots <= 0:
        return np.zeros((0,), np.int32)
    if isinstance(vectors, torch.Tensor):
        vecs = vectors.float()
    else:
        vecs = torch.from_numpy(np.asarray(vectors, np.float32)).to(resolve_device(device))
    nbrs = neighbors if isinstance(neighbors, torch.Tensor) else torch.from_numpy(
        np.asarray(neighbors, np.int32))
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, n, size=min(n_samples, n))
    noise = rng.normal(0.0, 0.05, size=(picks.size, vecs.shape[1]))
    rows = vecs[torch.from_numpy(picks).to(vecs.device)].cpu().numpy()
    queries = torch.from_numpy((rows + noise).astype(np.float32)).to(vecs.device)
    res = beam_search_batch(nbrs.to(vecs.device).int(), vecs, int(medoid), queries,
                            search_l=search_l, beam_width=4, max_expand=4 * search_l)
    expanded = res.expanded_ids.cpu().numpy().ravel()
    counts = np.bincount(expanded[expanded >= 0], minlength=n)
    hot = np.argsort(-counts, kind="stable")[:n_slots]
    hot = hot[counts[hot] > 0].astype(np.int32)
    if hot.size < n_slots:  # pad from BFS order, skipping already-chosen ids
        # BFS order's first n_slots + |hot| nodes hold the n_slots - |hot|
        # it needs: the same padding as the reference's walk of all N nodes
        bfs = bfs_hot_set(neighbors, medoid, min(n, n_slots + hot.size))
        extra = bfs[~np.isin(bfs, hot)][: n_slots - hot.size]
        hot = np.concatenate([hot, extra.astype(np.int32)])
    return hot


def select_hot_set(
    *,
    neighbors,
    medoid: int,
    budget_bytes: int,
    policy: str = "visit_freq",
    vectors=None,
    n_samples: int = 64,
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Pick the hot-set ids that fit in ``budget_bytes`` of record storage."""
    if policy not in CACHE_POLICIES:
        raise ValueError(f"cache policy {policy!r} not in {CACHE_POLICIES}")
    n, r = neighbors.shape
    dim = int(vectors.shape[1]) if vectors is not None else 0
    per_record = record_nbytes(dim, int(r))
    n_slots = min(int(budget_bytes) // per_record, int(n))
    # visit_freq samples whole-corpus traversals on the device — with a
    # lazy disk-backed vectors view that would materialise the corpus, so
    # fall back to the BFS warm-up policy (vectors still size the budget)
    if policy == "visit_freq" and vectors is not None and not is_lazy_host(vectors):
        return visit_freq_hot_set(vectors, neighbors, int(medoid), n_slots,
                                  n_samples=n_samples, seed=seed, device=device)
    return bfs_hot_set(neighbors, int(medoid), n_slots)


def _rows(a, rows: np.ndarray, np_dtype, dev: torch.device) -> torch.Tensor:
    """``a[rows]`` on ``dev``: a tensor is gathered where it lies, a host
    array (memmap and lazy views included) only at ``rows``."""
    if isinstance(a, torch.Tensor):
        return a[torch.from_numpy(rows).to(a.device).long()].to(dev)
    return torch.from_numpy(np.ascontiguousarray(a[rows], dtype=np_dtype)).to(dev)


@dataclasses.dataclass(frozen=True)
class CachedRecordStore:
    """A static hot-record cache in front of any backing record store."""

    backing: Any  # a record store of the port's protocol
    slot_of: torch.Tensor  # (N,) int32 — node id -> cache slot, -1 if uncached
    cache_vectors: torch.Tensor  # (C, D) device-resident hot records
    cache_neighbors: torch.Tensor  # (C, R) full adjacency of the hot records
    policy: str = "visit_freq"

    @classmethod
    def wrap(
        cls,
        backing: Any,
        *,
        vectors,
        neighbors,
        hot_ids: np.ndarray,
        policy: str = "visit_freq",
        n_slots: int | None = None,
        device=None,
    ) -> "CachedRecordStore":
        """Cache ``hot_ids`` rows of the full (vectors, neighbors) arrays on
        ``device`` (the card unless the caller asks for the CPU).

        With ``n_slots``, the cache block is truncated or zero-padded to
        exactly that many rows (surplus rows stay unmapped — ``slot_of``
        never points at them), so repeated wraps at one budget give
        tensors of one shape; the adaptive cache refreshes through this
        path.  Only the hot rows are gathered: from a device tensor on
        its device, from a host array or a lazy disk view on the host.
        """
        dev = resolve_device(device)
        hot = np.asarray(hot_ids, np.int32)
        if n_slots is not None:
            hot = hot[:n_slots]
        n = int(neighbors.shape[0])
        slot_of = np.full((n,), -1, np.int32)
        slot_of[hot] = np.arange(hot.size, dtype=np.int32)
        # an empty hot set keeps one dummy row (never hit: slot_of is all
        # -1) so the gathers always have a non-empty operand
        rows = hot if hot.size else np.zeros((1,), np.int32)
        dim = int(vectors.shape[1])
        cache_vecs = _rows(vectors, rows, np.float32, dev)
        cache_nbrs = _rows(neighbors, rows, np.int32, dev)
        target = max(n_slots, 1) if n_slots is not None else int(cache_vecs.shape[0])
        pad = target - int(cache_vecs.shape[0])
        if pad > 0:
            cache_vecs = torch.cat(
                [cache_vecs, torch.zeros((pad, dim), dtype=torch.float32, device=dev)])
            cache_nbrs = torch.cat([cache_nbrs, torch.full(
                (pad, cache_nbrs.shape[1]), -1, dtype=torch.int32, device=dev)])
        obs.default_registry().counter("cache.materializations", policy=policy).inc()
        return cls(backing=backing, slot_of=torch.from_numpy(slot_of).to(dev),
                   cache_vectors=cache_vecs, cache_neighbors=cache_nbrs, policy=policy)

    # -- the loop's entry points -------------------------------------------
    def _split(self, ids: torch.Tensor):
        """(cache slot or -1, hit mask, the ids the backing store sees)."""
        slot = torch.where(ids >= 0, self.slot_of[ids.clamp(min=0).long()], -1)
        hit = slot >= 0
        return slot.clamp(min=0).long(), hit, torch.where(hit, -1, ids)

    def cached_mask(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, W) ids -> (B, W) bool: True where the record is cache-resident."""
        return (ids >= 0) & (self.slot_of[ids.clamp(min=0).long()] >= 0)

    def fetch(self, ids: torch.Tensor):
        """(B, W) ids -> (vecs, nbrs); the slow tier only sees the misses —
        a hit is a device gather."""
        safe, hit, miss_ids = self._split(ids)
        vecs, nbrs = self.backing.fetch(miss_ids)
        return (torch.where(hit[..., None], self.cache_vectors[safe], vecs),
                torch.where(hit[..., None], self.cache_neighbors[safe], nbrs))

    def _submit(self, ids: torch.Tensor):
        """Asynchronous stage A through the cache: only the misses are
        submitted; the hits' neighbour lists are a device gather, so the
        adjacency equals the synchronous ``fetch``'s."""
        safe, hit, miss_ids = self._split(ids)
        token, nbrs = self.backing.submit(miss_ids)
        return token, torch.where(hit[..., None], self.cache_neighbors[safe], nbrs)

    def _drain(self, token, ids: torch.Tensor, live: bool):
        """Asynchronous stage B through the cache: the slow tier drains the
        misses; the hits' vectors come off the cache block (the split is a
        function of the slot map, so it agrees with what ``submit`` masked
        out rounds earlier)."""
        safe, hit, miss_ids = self._split(ids)
        vecs = self.backing.drain(token, miss_ids, live)
        return torch.where(hit[..., None], self.cache_vectors[safe], vecs)

    @property
    def submit(self):
        """The asynchronous pair through the cache, or None when the backing
        store has none (memory and host tiers)."""
        return self._submit if getattr(self.backing, "submit", None) is not None else None

    @property
    def drain(self):
        return self._drain if getattr(self.backing, "drain", None) is not None else None

    @property
    def degree(self) -> int:
        return int(self.backing.degree)

    # -- reporting ---------------------------------------------------------
    @property
    def n_cached(self) -> int:
        return int((self.slot_of >= 0).sum())

    def cache_bytes(self) -> int:
        """Slow-tier bytes the cache displaces (4 KB-aligned records)."""
        d = int(self.cache_vectors.shape[1])
        return self.n_cached * record_nbytes(d, int(self.cache_neighbors.shape[1]))

    def device_bytes(self) -> int:
        """Device bytes held: packed records + the slot map."""
        c, d = self.cache_vectors.shape
        r = int(self.cache_neighbors.shape[1])
        return int(c) * (int(d) + r) * 4 + int(self.slot_of.shape[0]) * 4

    def hot_ids(self) -> np.ndarray:
        """Cached node ids in slot order."""
        slot_of = self.slot_of.cpu().numpy()
        ids = np.flatnonzero(slot_of >= 0)
        return ids[np.argsort(slot_of[ids])].astype(np.int32)

    def io_counters(self) -> dict:
        """Measured counters of the backing tier ({} when it only models
        its I/O), however many cache tiers sit above it."""
        f = getattr(self.backing, "io_counters", None)
        return f() if f is not None else {}

    def abandon_pending(self) -> int:
        """Retire the backing tier's submitted-but-undrained rounds (0 when
        the backing has no asynchronous pair)."""
        f = getattr(self.backing, "abandon_pending", None)
        return f() if f is not None else 0

    # -- passthroughs to the backing arrays --------------------------------
    @property
    def vectors(self):
        return self.backing.vectors

    @property
    def neighbors(self):
        return self.backing.neighbors

    def record_bytes(self) -> int:
        return self.backing.record_bytes()
