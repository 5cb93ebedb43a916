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

**Two paths, one output.**  The unfused loop is the reference's order:
stage A (``best_unexpanded``, ``mark_expanded``, the filter check,
``mode_masks``), the fetch and re-rank, then ``expand`` (the new
candidates, their ADC, ``frontier.insert``).  The fused path runs the
frontier's upkeep as one call a round of ``kernels.fused_traversal``
(ADC, the kill mask, the stable merge, the beam and its masks: one
kernel launch on a CUDA device) and gives the same ids, distances and
stats.  ``SearchConfig.use_fused_kernel`` chooses (``use_fused_round``):
True forces the fused round and False the unfused loop; the default,
None, lets the device decide: the fused round on a CUDA device wherever
``fused_supported`` holds for the call's shapes (a sort width up to
4,096, an ADC tile up to 8 MiB), the unfused loop on the CPU and for
shapes the kernel refuses.  The fused path writes its rounds into two
sets of outputs allocated once a call (``depth + 1`` when pipelined, the
rounds the ring still reads), and the kernel's wrapper checks its
arguments on the call's first two rounds only.

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
family out; a per-call count is ``search.dispatch`` in the engine.  The
port's own, which the reference has not (``PORT_FAMILIES``):

  * ``search.rounds{mode}`` counts the call's rounds (loop iterations;
    every row hops together, so it is any row's ``n_hops``), with the
    default registry enabled;
  * ``search.round_seconds{phase}``: while the process tracer is on, the
    host seconds of each phase of a round (``PHASES``), summed over the
    call's rounds in locals and observed once a call.  ``stage_a``: beam
    selection, the filter check, masks and accounting (on the fused path
    the accounting; the kernel selects the beam inside ``expand``);
    ``fetch``: ``store.fetch``, or ``submit`` and ``drain``; ``rerank``:
    the retire into the result heap; ``expand``: the new candidates, their
    ADC and the insert, or the fused call; ``sync``: the loop condition's
    host sync.  A round costs five ``perf_counter`` reads and no registry
    call;
  * ``search.fused_rounds{mode}``: the call's rounds taken by the fused
    round (0 on the unfused loop), beside ``search.rounds``: their ratio
    is how often the fused path is taken;
  * ``search.scored`` (counted by ``obs.stats.record_search_stats``): new
    candidates given a PQ distance, summed on the device only when the
    caller passes ``count_scored`` (the engine does when its registry is
    enabled), as ``SearchOutput.n_scored``.

With the tracer and the registry off the loop reads no clock and launches
nothing for telemetry; the tracer's ``enabled`` is read once a call.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core import frontier as fr
from repro_torch.core.filter_store import CheckFn
from repro_torch.core.neighbor_store import NeighborStore
from repro_torch.kernels import fused_traversal as ftk
from repro_torch.kernels import l2_dist as l2k
from repro_torch.kernels import pq_lookup as pqk

MODES = ("gate", "post", "early", "pre_naive", "unfiltered")
# the phases of a round, in ``search.round_seconds{phase}``
PHASES = ("stage_a", "fetch", "rerank", "expand", "sync")
STAGE_A, FETCH, RERANK, EXPAND, SYNC = range(len(PHASES))
# the port's search.* families that the reference has not
PORT_FAMILIES = ("search.rounds", "search.fused_rounds", "search.scored")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    mode: str = "gate"
    search_l: int = 64  # frontier size L
    result_k: int = 10  # top-K
    beam_width: int = 8  # W — dispatch width
    max_hops: int = 512  # safety bound on rounds
    use_kernel: bool = False  # exact distances: pairwise tree (False) or expanded form (True)
    pipeline_depth: int = 1  # >1 needs a submit/drain store; else the synchronous loop
    # the fused round (True), the unfused loop (False), or the device decides
    # (None): see ``use_fused_round``
    use_fused_kernel: bool | None = None

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
    # (B,) int32 new candidates given a PQ distance; None unless
    # ``count_scored``
    n_scored: torch.Tensor | None = None


class _RoundClock:
    """Host seconds of a call's rounds by phase: ``lap(phase)`` adds the
    time since the last lap to ``phase``."""

    __slots__ = ("sums", "t")

    def __init__(self):
        self.sums = [0.0] * len(PHASES)
        self.t = time.perf_counter()

    def lap(self, phase: int) -> None:
        t = time.perf_counter()
        self.sums[phase] += t - self.t
        self.t = t

    def publish(self, reg) -> None:
        for name, s in zip(PHASES, self.sums):
            reg.histogram("search.round_seconds", phase=name).observe(s)


class _NoClock:
    """The round clock while the tracer is off: reads nothing."""

    __slots__ = ()

    def lap(self, phase: int) -> None:
        pass

    def publish(self, reg) -> None:
        pass


_NO_CLOCK = _NoClock()


def use_fused_round(flag: bool | None, *, device: torch.device | str, l: int, width: int,
                    m: int, c: int, k: int) -> bool:
    """Does the loop run its rounds through the fused round?  ``flag`` is
    ``use_fused_kernel``: False keeps the unfused loop; True takes the fused
    round wherever ``fused_supported`` holds for the shapes (frontier ``l``,
    beam ``width``, ``m`` new candidates a round, ``c`` x ``k`` PQ tables);
    None does so on a CUDA device only, and keeps the reference's unfused
    loop elsewhere."""
    if flag is None:
        if torch.device(device).type != "cuda":
            return False
    elif not flag:
        return False
    return ftk.fused_supported(l=l, width=width, m=m, c=c, k=k, device=device)


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
    count_scored: bool = False,  # sum new candidates given a PQ distance (n_scored)
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
    scored = zeros.clone() if count_scored else None

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
        if scored is not None:
            scored.add_(_count(new >= 0))
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
        clock.lap(FETCH)
        if live:
            results, stats = retire(results, stats, p_ids[dp], p_rm[dp], vecs)
        clock.lap(RERANK)
        return results, stats

    use_fused = use_fused_round(config.use_fused_kernel, device=dev, l=L, width=W,
                                m=W * (store.degree + r_max), c=codes.shape[1], k=lut.shape[2])

    def finish(results, stats, r, rounds):
        if pipelined:  # flush: retire the rounds still in flight, oldest first
            for j in range(depth - 1):
                results, stats = retire_round(r - (depth - 1) + j, results, stats)
        reg = obs.default_registry()
        if reg.enabled:
            reg.counter("search.rounds", mode=mode).inc(rounds)
            reg.counter("search.fused_rounds", mode=mode).inc(rounds if use_fused else 0)
        clock.publish(reg)
        return SearchOutput(ids=results.ids, dists=results.dists, stats=stats, visit_counts=vc,
                            n_scored=scored)

    def more(work):
        """The loop's condition, on the host: its one sync a round."""
        go = bool(work.any() & (stats.n_hops < config.max_hops).all())
        clock.lap(SYNC)
        return go

    r = 0  # pipelined rounds' index (every row hops together: n_hops[0])
    rounds = 0  # loop iterations, on every path
    clock = _RoundClock() if obs.trace.default_tracer().enabled else _NO_CLOCK
    if not use_fused:
        while more(fr.has_unexpanded(frontier)):
            rounds += 1
            frontier, stats, sel_ids, fetch_ids, tunnel_mask, result_mask = stage_a(frontier, stats)
            clock.lap(STAGE_A)
            if not pipelined:
                vecs, disk_nbrs = store.fetch(fetch_ids)
                clock.lap(FETCH)
                results, stats = retire(results, stats, sel_ids, result_mask, vecs)
                clock.lap(RERANK)
                frontier = expand(frontier, sel_ids, tunnel_mask, disk_nbrs)
                clock.lap(EXPAND)
                continue
            # stage A: dispatch this round's read; its neighbours come back now
            token, disk_nbrs = submit(fetch_ids)
            clock.lap(FETCH)
            frontier = expand(frontier, sel_ids, tunnel_mask, disk_nbrs)
            clock.lap(EXPAND)
            wp = r % depth
            p_ids[wp], p_fids[wp], p_rm[wp], p_tok[wp] = sel_ids, fetch_ids, result_mask, token
            results, stats = retire_round(r - (depth - 1), results, stats)
            r += 1
        return finish(results, stats, r, rounds)

    # the rounds' outputs, allocated once: call j writes set j % len(outs),
    # which no round still read holds (the current round, and when
    # pipelined the ring's depth - 1 more)
    outs = [ftk.empty_round(b, L, W, dev) for _ in range(depth + 1 if pipelined else 2)]
    calls = 0

    def fused_call(fids, fds, fexp, fpass, new_ids, new_passes):
        nonlocal calls
        rnd = ftk.fused_traversal_round(
            fids, fds, fexp, fpass, new_ids, codes, new_passes, lut, entry,
            mode=mode, width=W, gathered=False, out=outs[calls % len(outs)],
            check=calls < 2,  # round 0 (M = 0) and the first round of this call's M
        )
        calls += 1
        return rnd

    # round-0 call (M = 0): select the first beam from the entry-seeded frontier
    empty = torch.zeros((b, 0), dtype=torch.int32, device=dev)
    rnd = fused_call(frontier.ids, frontier.dists, frontier.expanded,
                     filter_check(frontier.ids), empty, empty.bool())
    clock.lap(EXPAND)
    while more(rnd.valid):
        rounds += 1
        stats = account(stats, rnd.sel_ids, rnd.fetch_mask, rnd.tunnel_mask, rnd.exact_mask)
        clock.lap(STAGE_A)
        if not pipelined:
            vecs, disk_nbrs = store.fetch(rnd.fetch_ids)
            clock.lap(FETCH)
            results, stats = retire(results, stats, rnd.sel_ids, rnd.result_mask, vecs)
            clock.lap(RERANK)
            new = fresh_candidates(rnd.sel_ids, rnd.tunnel_mask, disk_nbrs)
            rnd = fused_call(rnd.frontier_ids, rnd.frontier_dists, rnd.frontier_expanded,
                             rnd.frontier_passes, new, filter_check(new))
            clock.lap(EXPAND)
            continue
        # the kernel call sits between this round's submit and the oldest
        # round's drain, as in the unfused pipeline
        token, disk_nbrs = submit(rnd.fetch_ids)
        clock.lap(FETCH)
        new = fresh_candidates(rnd.sel_ids, rnd.tunnel_mask, disk_nbrs)
        nrnd = fused_call(rnd.frontier_ids, rnd.frontier_dists, rnd.frontier_expanded,
                          rnd.frontier_passes, new, filter_check(new))
        clock.lap(EXPAND)
        wp = r % depth
        p_ids[wp], p_fids[wp], p_rm[wp], p_tok[wp] = (rnd.sel_ids, rnd.fetch_ids,
                                                      rnd.result_mask, token)
        results, stats = retire_round(r - (depth - 1), results, stats)
        rnd = nrnd
        r += 1
    return finish(results, stats, r, rounds)
