"""GateANN search loop (Algorithm 1) and the paper's baselines.

Port of ``repro.core.search``: one batched loop serves all five modes —
``gate`` (pre-I/O filter check: filter-passing nodes are fetched and
scored exactly, filter-failing nodes are *tunneled* through the in-memory
neighbor store), ``post`` (fetch everything, filter afterwards),
``early`` (fetch everything, exact distance only on matches),
``pre_naive`` (drop non-matching nodes outright) and ``unfiltered``.

The loop is lockstep over the batch: ``n_hops`` advances for every row
on every round, and the loop runs while any row has work and every row
is under ``max_hops`` — one host sync per round in eager PyTorch.
``use_fused_kernel`` runs stage A as one fused round per iteration
(``kernels.fused_traversal``) and gives the same ids, distances and
stats as the unfused loop.

On a CUDA device three kernels serve the loop (ADC, the re-rank, fused
round); on the CPU their plain versions do.  The re-rank
(``kernels.l2_dist.rerank``) is all of a round's stage B — exact
distances, the degraded-record check and the result-list merge — in one
launch.  ``use_kernel`` keeps the reference's meaning for the exact
distances: False = the fixed pairwise tree of the reference's
``_exact_dist``, True = the TPU kernel's expanded form.

**Pipelined search** (``pipeline_depth > 1`` with the store's
asynchronous ``submit``/``drain`` pair, i.e. the disk tier): traversal
needs only neighbour lists and PQ distances, never the full-precision
record.  Stage A expands the frontier from the neighbour lists ``submit``
returns at once (the adjacency sidecar) and dispatches round r+1's beam
while round r's read is in flight; stage B retires reads up to
``pipeline_depth`` rounds behind, FIFO, into the result heap.  The heap
is write-only state and retirement keeps insertion order, so the output
is bit-identical to the synchronous loop at every depth (ids, distances
and all six stats).  The rings are Python lists and the host calls come
in the reference's order: unfused — stage A, submit, expand, ring write,
drain, retire; fused — account, submit, new candidates, kernel call,
ring write, drain, retire; then ``depth - 1`` flush rounds.  Without the
pair (memory and host tiers), any depth runs the synchronous loop.

**Cache tier**: when the record store carries a hot-node cache
(``store/cache.py``), ``cached_mask`` splits each round's fetches into
cache hits (counted as ``n_cache_hits``) and slow-tier reads (``n_ios``);
the store itself masks the hits to -1 before its slow tier sees them.
``visit_counts`` (an (N,) float32 tensor) gains each round's fetch-path
dispatches — the adaptive cache's online counters — and comes back on
``SearchOutput``.  Both happen in ``account``, the one place every path
(unfused, fused, synchronous, pipelined) counts a round.  Results are
bit-identical with or without a cache.

**Telemetry**: the reference counts ``search.traces`` here, once per jit
trace of the loop (which loop variant compiled).  Eager PyTorch traces
and compiles nothing, so the port has no trace to count and leaves the
family out; a per-call count is ``search.dispatch`` in the engine.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import frontier as fr
from repro_torch.core.filter_store import CheckFn
from repro_torch.core.neighbor_store import NeighborStore
from repro_torch.kernels import fused_traversal as ftk
from repro_torch.kernels import l2_dist as l2k
from repro_torch.kernels import pq_lookup as pqk

MODES = ("gate", "post", "early", "pre_naive", "unfiltered")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    mode: str = "gate"
    search_l: int = 64  # frontier size L
    result_k: int = 10  # top-K
    beam_width: int = 8  # W — dispatch width
    max_hops: int = 512  # safety bound on rounds
    use_kernel: bool = False  # exact distances: pairwise tree (False) or expanded form (True)
    pipeline_depth: int = 1  # >1 needs a submit/drain store; else the synchronous loop
    use_fused_kernel: bool = False  # stage A as one fused round per iteration

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {MODES}")
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {self.pipeline_depth}")


class SearchStats(NamedTuple):
    n_ios: torch.Tensor  # (B,) records fetched from the slow (expensive) tier
    n_tunnels: torch.Tensor  # (B,) nodes traversed purely in memory
    n_exact: torch.Tensor  # (B,) exact distance computations
    n_hops: torch.Tensor  # (B,) dispatch rounds
    n_cache_hits: torch.Tensor  # (B,) record fetches served by the cache tier
    n_degraded: torch.Tensor  # (B,) result slots whose record came back degraded (+inf)


class SearchOutput(NamedTuple):
    ids: torch.Tensor  # (B, K) result ids (filter-passing, exact-ranked)
    dists: torch.Tensor  # (B, K)
    stats: SearchStats
    # (N,) per-node fetch-path visit counts on top of the caller's
    # ``visit_counts``; None when counting is off
    visit_counts: torch.Tensor | None = None


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dim=1, dtype=torch.int32)


def filtered_search(
    *,
    store,  # record store: fetch((B, W) ids) -> (vecs, nbrs) and its adjacency width `degree`
    neighbor_store: NeighborStore,
    filter_check: CheckFn,
    lut: torch.Tensor,  # (B, C, K) per-query ADC tables
    codes: torch.Tensor,  # (N, C) int32 PQ codes (the in-memory compressed tier)
    entry: torch.Tensor,  # () or (B,) int32 medoid
    queries: torch.Tensor,  # (B, D) full-precision queries
    config: SearchConfig,
    cached_mask=None,  # (B, W) ids -> (B, W) bool cache-hit mask
    visit_counts: torch.Tensor | None = None,  # (N,) f32 running fetch counters
    submit=None,  # asynchronous pair: (B, W) ids -> (token, nbrs (B, W, R))
    drain=None,  # (token, ids, live) -> vecs (B, W, D)
) -> SearchOutput:
    b = queries.shape[0]
    n = codes.shape[0]
    dev = queries.device
    L, W, K = config.search_l, config.beam_width, config.result_k
    mode = config.mode
    r_max = neighbor_store.r_max

    entry = torch.as_tensor(entry, dtype=torch.int32, device=dev)
    if entry.dim() == 0:
        entry = entry.expand(b).contiguous()

    frontier = fr.make_frontier(b, L, dev)
    frontier.ids[:, 0] = entry
    frontier.dists[:, 0] = pqk.adc_ids(lut, codes, entry[:, None].contiguous())[:, 0]
    results = fr.make_results(b, K, dev)

    # visited set as a bool map: same meaning as the reference's uint32
    # bitset, without the uint32 shifts torch lacks on the CPU.  Column N
    # is a sink for ids < 0, so every scatter into it writes True and
    # duplicate indices cannot race.
    visited = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    visited[torch.arange(b, device=dev), entry.long()] = True

    def slot(ids):
        return torch.where(ids >= 0, ids, n).long()

    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    stats = SearchStats(zeros, zeros, zeros, zeros, zeros, zeros)

    # the caller's counters, accumulated on a copy
    vc = None if visit_counts is None else visit_counts.to(dev, torch.float32, copy=True)

    def account(stats, sel_ids, fetch_mask, tunnel_mask, exact_mask):
        """A round's stats: its fetches split into cache hits and slow-tier
        reads, and the fetch-path dispatches added to the visit counters."""
        if vc is not None:
            vc.index_add_(0, sel_ids.clamp(min=0).reshape(-1).long(),
                          fetch_mask.reshape(-1).to(torch.float32))
        stats = stats._replace(
            n_tunnels=stats.n_tunnels + _count(tunnel_mask),
            n_exact=stats.n_exact + _count(exact_mask),
            n_hops=stats.n_hops + 1,
        )
        if cached_mask is None:  # no cache tier: every fetch is a slow-tier read
            return stats._replace(n_ios=stats.n_ios + _count(fetch_mask))
        hit_mask = cached_mask(sel_ids) & fetch_mask
        return stats._replace(n_ios=stats.n_ios + _count(fetch_mask & ~hit_mask),
                              n_cache_hits=stats.n_cache_hits + _count(hit_mask))

    def retire(results, stats, sel_ids, result_mask, vecs):
        """Score one round's fetched records into the result heap.  A +inf
        record (a degraded read) keeps its traversal role but is dropped
        from the results and counted; memory-tier records never are."""
        ids, dists, n_degraded = l2k.rerank(queries, vecs, sel_ids, result_mask, results.ids,
                                            results.dists, stats.n_degraded,
                                            tree=not config.use_kernel)
        return fr.ResultList(ids, dists), stats._replace(n_degraded=n_degraded)

    def fresh_candidates(sel_ids, tunnel_mask, disk_nbrs):
        """This round's new frontier candidates: the fetched records'
        full adjacency plus (gate) the tunneled nodes' r_max prefix,
        visited ids masked to -1, then marked visited."""
        if mode == "gate":
            tun_nbrs = neighbor_store.lookup(torch.where(tunnel_mask, sel_ids, fr.INVALID))
        else:
            tun_nbrs = torch.full((b, W, r_max), fr.INVALID, dtype=torch.int32, device=dev)
        new = torch.cat([disk_nbrs.reshape(b, -1), tun_nbrs.reshape(b, -1)], dim=-1)
        new = torch.where((new >= 0) & ~visited.gather(1, slot(new)), new, fr.INVALID)
        visited.scatter_(1, slot(new), True)
        return new

    def stage_a(frontier, stats):
        """Beam selection, masks and accounting: everything of a round but
        the record itself (shared by the synchronous and pipelined loops)."""
        sel_ids, slots, valid = fr.best_unexpanded(frontier, W)
        frontier = fr.mark_expanded(frontier, slots, valid)
        passes = filter_check(sel_ids) & valid
        fetch_mask, tunnel_mask, result_mask, exact_mask = ftk.mode_masks(
            mode, sel_ids, valid, passes, entry[:, None]
        )
        stats = account(stats, sel_ids, fetch_mask, tunnel_mask, exact_mask)
        fetch_ids = torch.where(fetch_mask, sel_ids, fr.INVALID)
        return frontier, stats, sel_ids, fetch_ids, tunnel_mask, result_mask

    def expand(frontier, sel_ids, tunnel_mask, disk_nbrs):
        new = fresh_candidates(sel_ids, tunnel_mask, disk_nbrs)
        return fr.insert(frontier, new, pqk.adc_ids(lut, codes, new))

    pipelined = config.pipeline_depth > 1 and submit is not None and drain is not None
    depth = config.pipeline_depth
    # the pipeline's rings, one entry per in-flight round: sel_ids,
    # fetch_ids, result_mask and the store's token
    p_ids = [None] * depth
    p_fids = [torch.full((b, W), fr.INVALID, dtype=torch.int32, device=dev)] * depth
    p_rm = [None] * depth
    p_tok = [-1] * depth

    def retire_round(rr, results, stats):
        """Stage B: drain round ``rr`` (FIFO) and score it into the heap.
        The drain is issued every round so the store sees a fixed call
        order; ``rr < 0`` (warm-up) drains nothing and retires nothing."""
        live = rr >= 0
        dp = rr % depth
        vecs = drain(p_tok[dp], p_fids[dp], live)
        if live:
            results, stats = retire(results, stats, p_ids[dp], p_rm[dp], vecs)
        return results, stats

    def finish(results, stats, r):
        if pipelined:  # flush: retire the rounds still in flight, oldest first
            for j in range(depth - 1):
                results, stats = retire_round(r - (depth - 1) + j, results, stats)
        return SearchOutput(ids=results.ids, dists=results.dists, stats=stats, visit_counts=vc)

    use_fused = config.use_fused_kernel and ftk.fused_supported(
        l=L, width=W, m=W * (store.degree + r_max), c=codes.shape[1], k=lut.shape[2], device=dev
    )

    r = 0  # round index: every row hops together, so this is n_hops[0]
    if not use_fused:
        while bool(fr.has_unexpanded(frontier).any() & (stats.n_hops < config.max_hops).all()):
            frontier, stats, sel_ids, fetch_ids, tunnel_mask, result_mask = stage_a(frontier, stats)
            if not pipelined:
                vecs, disk_nbrs = store.fetch(fetch_ids)
                results, stats = retire(results, stats, sel_ids, result_mask, vecs)
                frontier = expand(frontier, sel_ids, tunnel_mask, disk_nbrs)
                continue
            # stage A: dispatch this round's read; its neighbours come back now
            token, disk_nbrs = submit(fetch_ids)
            frontier = expand(frontier, sel_ids, tunnel_mask, disk_nbrs)
            wp = r % depth
            p_ids[wp], p_fids[wp], p_rm[wp], p_tok[wp] = sel_ids, fetch_ids, result_mask, token
            results, stats = retire_round(r - (depth - 1), results, stats)
            r += 1
        return finish(results, stats, r)

    def fused_call(fids, fds, fexp, fpass, new_ids, new_passes):
        return ftk.fused_traversal_round(
            fids, fds, fexp, fpass, new_ids, codes, new_passes, lut, entry,
            mode=mode, width=W, gathered=False,
        )

    # round-0 call (M = 0): select the first beam from the entry-seeded frontier
    empty = torch.zeros((b, 0), dtype=torch.int32, device=dev)
    rnd = fused_call(frontier.ids, frontier.dists, frontier.expanded,
                     filter_check(frontier.ids), empty, empty.bool())
    while bool(rnd.valid.any() & (stats.n_hops < config.max_hops).all()):
        stats = account(stats, rnd.sel_ids, rnd.fetch_mask, rnd.tunnel_mask, rnd.exact_mask)
        if not pipelined:
            vecs, disk_nbrs = store.fetch(rnd.fetch_ids)
            results, stats = retire(results, stats, rnd.sel_ids, rnd.result_mask, vecs)
            new = fresh_candidates(rnd.sel_ids, rnd.tunnel_mask, disk_nbrs)
            rnd = fused_call(rnd.frontier_ids, rnd.frontier_dists, rnd.frontier_expanded,
                             rnd.frontier_passes, new, filter_check(new))
            continue
        # the kernel call sits between this round's submit and the oldest
        # round's drain, as in the unfused pipeline
        token, disk_nbrs = submit(rnd.fetch_ids)
        new = fresh_candidates(rnd.sel_ids, rnd.tunnel_mask, disk_nbrs)
        nrnd = fused_call(rnd.frontier_ids, rnd.frontier_dists, rnd.frontier_expanded,
                          rnd.frontier_passes, new, filter_check(new))
        wp = r % depth
        p_ids[wp], p_fids[wp], p_rm[wp], p_tok[wp] = (rnd.sel_ids, rnd.fetch_ids,
                                                      rnd.result_mask, token)
        results, stats = retire_round(r - (depth - 1), results, stats)
        rnd = nrnd
        r += 1
    return finish(results, stats, r)
