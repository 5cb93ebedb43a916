"""Vamana graph construction and in-memory beam search.

Port of ``repro.core.graph``: the index substrate under DiskANN / PipeANN
/ GateANN, which all search the *same* standard Vamana graph (paper
§5.1).

  * ``build_vamana``          — batched two-pass Vamana build (greedy
                                search for candidates + RobustPrune,
                                reverse-edge insertion with overflow
                                pruning);
  * ``build_filtered_vamana`` — the F-DiskANN baseline: label-aware
                                pruning and per-label medoid entry points;
  * ``beam_search_batch``     — batched best-first search over
                                full-precision vectors (the Vamana
                                baseline, and the build's workhorse).

Graphs are dense int32 tensors ``(N, R)`` padded with -1, on the device
of the vectors they index.  The reference's jitted ``while_loop`` is a
Python loop here with one host sync a round (its ``cond``).  Ties go the
reference's way: every sort is ``torch.sort(stable=True)`` (``jnp.argsort``
is stable) and ``argmin`` takes the first index in both packages, so on
data whose distances are exact in float32 (integer-valued vectors) the
port builds the reference's adjacency bit for bit.

Where the reference ORs bits into a packed visited bitmap one column at a
time, the port keeps a ``(B, N + 1)`` bool map with a sink column for
ids < 0, as the search loop does: 512 MB at the build's batch of 512 and
N = 1,000,000.  ``_add_reverse_edges`` is the reference's numpy loop,
kept as the oracle; the build calls ``add_reverse_edges``, its vectorised
twin on the device (the same adjacency, held equal by the tests).
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import frontier as fr
from repro_torch.device import resolve_device

INVALID = fr.INVALID
INF = fr.INF
OVERFLOW_W = 32  # extra candidate columns kept for an overflowing node
PRUNE_ROWS = 8192  # overflowing nodes re-pruned at a time (bounds the (rows, C, C) block)


class VamanaGraph(NamedTuple):
    neighbors: torch.Tensor  # (N, R) int32, -1 padded
    medoid: int  # the global entry point


# ---------------------------------------------------------------------------
# distance helpers
# ---------------------------------------------------------------------------

def l2_sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared L2 between rows of x (..., D) and y (..., D)."""
    diff = x - y
    return (diff * diff).sum(-1)


def l2_sq_pairwise(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., Nx, D) x (..., Ny, D) -> (..., Nx, Ny), as the expansion
    ``(|x|^2 - (2x).y) + |y|^2`` (``torch.matmul`` for the product)."""
    xx = (x * x).sum(-1)[..., :, None]
    yy = (y * y).sum(-1)[..., None, :]
    return (xx - torch.matmul(2.0 * x, y.transpose(-1, -2))) + yy


def find_medoid(vectors: torch.Tensor) -> int:
    """Node closest to the dataset centroid (the DiskANN entry point)."""
    centroid = vectors.mean(0, keepdim=True)
    return int(torch.argmin(l2_sq(vectors, centroid)))


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True).indices


# ---------------------------------------------------------------------------
# batched best-first beam search (in-memory, full precision)
# ---------------------------------------------------------------------------

class SearchResult(NamedTuple):
    ids: torch.Tensor  # (B, L) int32 candidate ids, sorted by distance
    dists: torch.Tensor  # (B, L) float32
    expanded_ids: torch.Tensor  # (B, max_expand) int32, -1 padded (the visited set V)
    n_expanded: torch.Tensor  # (B,) int32
    n_hops: torch.Tensor  # (B,) int32


def _frontier_insert(ids, dists, flags, new_ids, new_dists, new_flags):
    """Merge new candidates into the sorted frontier, dedup by id, keep L:
    a later duplicate of a valid id is killed, and every dead slot becomes
    (-1, INF)."""
    l = ids.shape[-1]
    all_ids = torch.cat([ids, new_ids], dim=-1)
    all_d = torch.cat([dists, new_dists], dim=-1)
    all_f = torch.cat([flags, new_flags], dim=-1)
    all_d = torch.where(fr._dedup_mask(all_ids), INF, all_d)
    all_ids = torch.where(all_d >= INF, INVALID, all_ids)
    take = _argsort(all_d)[..., :l]
    return all_ids.gather(-1, take), all_d.gather(-1, take), all_f.gather(-1, take)


def beam_search_batch(
    neighbors: torch.Tensor,  # (N, R) int32
    vectors: torch.Tensor,  # (N, D) float32
    entry,  # int, () or (B,) int32
    queries: torch.Tensor,  # (B, D) float32
    *,
    search_l: int = 64,
    beam_width: int = 4,
    max_expand: int = 256,
) -> SearchResult:
    """Batched best-first graph search with exact in-memory distances.

    DiskANN's GreedySearch: keep a sorted size-L frontier; expand the best
    ``beam_width`` unexpanded candidates a round; stop when the top L hold
    no unexpanded candidate, or after ``max_expand`` rounds.  Rows move in
    lockstep, as in the reference's ``while_loop``.
    """
    dev = queries.device
    b = queries.shape[0]
    n, r = neighbors.shape
    w = beam_width
    entry = torch.as_tensor(entry, dtype=torch.int32, device=dev)
    if entry.dim() == 0:
        entry = entry.expand(b)
    rows = torch.arange(b, device=dev)

    ids = torch.full((b, search_l), INVALID, dtype=torch.int32, device=dev)
    dists = torch.full((b, search_l), INF, dtype=torch.float32, device=dev)
    flags = torch.zeros((b, search_l), dtype=torch.bool, device=dev)  # True = expanded
    ids[:, 0] = entry
    dists[:, 0] = l2_sq(vectors[entry.long()], queries)
    exp_ids = torch.full((b, max_expand), INVALID, dtype=torch.int32, device=dev)
    exp_d = torch.full((b, max_expand), INF, dtype=torch.float32, device=dev)
    n_exp = torch.zeros((b,), dtype=torch.int32, device=dev)
    # the visited set: column N is a sink for ids < 0
    visited = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    visited[rows, entry.long()] = True
    cols = torch.arange(w, device=dev)

    def slot(x):
        return torch.where(x >= 0, x, n).long()

    hops = 0
    while hops < max_expand and bool(((~flags) & (ids >= 0)).any()):
        # pick up to beam_width best unexpanded candidates a query
        sel_d = torch.where((~flags) & (ids >= 0), dists, INF)
        order = _argsort(sel_d)[:, :w]
        sel_valid = sel_d.gather(1, order) < INF
        sel_ids = torch.where(sel_valid, ids.gather(1, order), INVALID)
        flags = flags | torch.zeros_like(flags).scatter(1, order, sel_valid)

        # record the visited set V (for RobustPrune); slots past the end
        # clip to the last one, where the reference's scatter lets the
        # last column win: write column by column, values taken first
        sel_dists = l2_sq(vectors[sel_ids.clamp(min=0).long()], queries[:, None, :])
        sel_dists = torch.where(sel_valid, sel_dists, INF)
        slots = (n_exp[:, None] + cols[None]).clamp(0, max_expand - 1).long()
        new_e = torch.where(sel_valid, sel_ids, exp_ids.gather(1, slots))
        new_d = torch.where(sel_valid, sel_dists, exp_d.gather(1, slots))
        for j in range(w):
            exp_ids.scatter_(1, slots[:, j:j + 1], new_e[:, j:j + 1])
            exp_d.scatter_(1, slots[:, j:j + 1], new_d[:, j:j + 1])
        n_exp = n_exp + sel_valid.sum(1, dtype=torch.int32)

        # expand: gather the neighbour lists, keep the unvisited ids
        nbrs = neighbors[sel_ids.clamp(min=0).long()]
        nbrs = torch.where(sel_valid[..., None], nbrs, INVALID).reshape(b, w * r)
        fresh = (nbrs >= 0) & ~visited.gather(1, slot(nbrs))
        nbrs = torch.where(fresh, nbrs, INVALID)
        visited.scatter_(1, slot(nbrs), True)
        nd = l2_sq(vectors[nbrs.clamp(min=0).long()], queries[:, None, :])
        nd = torch.where(nbrs >= 0, nd, INF)
        ids, dists, flags = _frontier_insert(ids, dists, flags, nbrs, nd, torch.zeros_like(fresh))
        hops += 1
    return SearchResult(ids=ids, dists=dists, expanded_ids=exp_ids, n_expanded=n_exp,
                        n_hops=torch.full((b,), hops, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# RobustPrune (vectorised over a batch of points)
# ---------------------------------------------------------------------------

def robust_prune_batch(
    point_ids: torch.Tensor,  # (B,) int32
    cand_ids: torch.Tensor,  # (B, C) int32, -1 padded (V ∪ current neighbours)
    vectors: torch.Tensor,  # (N, D)
    *,
    alpha: float,
    degree: int,
) -> torch.Tensor:
    """DiskANN RobustPrune: greedily keep the closest candidate, drop any
    candidate c' with alpha * d(c, c') <= d(p, c'). Returns (B, degree).
    Rows are independent: any split of a batch gives the same rows."""
    b = cand_ids.shape[0]
    rows = torch.arange(b, device=cand_ids.device)
    p_vec = vectors[point_ids.long()]
    c_vec = vectors[cand_ids.clamp(min=0).long()]  # (B, C, D)
    valid = (cand_ids >= 0) & (cand_ids != point_ids[:, None])  # no self edge
    d_p = torch.where(valid, l2_sq(c_vec, p_vec[:, None, :]), INF)
    d_cc = l2_sq_pairwise(c_vec, c_vec)  # (B, C, C)
    # the reference's alpha is a float32 scalar inside its jit
    a = torch.tensor(alpha, dtype=torch.float32, device=cand_ids.device)
    alive = valid
    out = torch.full((b, degree), INVALID, dtype=torch.int32, device=cand_ids.device)
    for k in range(degree):
        masked = torch.where(alive, d_p, INF)
        best = torch.argmin(masked, dim=1)  # the first minimum, as jnp.argmin
        best_ok = masked.gather(1, best[:, None])[:, 0] < INF
        out[:, k] = torch.where(best_ok, cand_ids.gather(1, best[:, None])[:, 0], INVALID)
        occluded = a * d_cc[rows, best] <= d_p  # the occlusion rule
        alive = alive & ~occluded & best_ok[:, None]
        alive[rows, best] = False
    return out


# ---------------------------------------------------------------------------
# Vamana build
# ---------------------------------------------------------------------------

def _init_random_graph(n: int, r: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, n, size=(n, r), dtype=np.int32)
    # avoid self loops
    self_hit = nbrs == np.arange(n, dtype=np.int32)[:, None]
    nbrs[self_hit] = (nbrs[self_hit] + 1) % n
    return nbrs


def _add_reverse_edges(nbrs: np.ndarray, dst: np.ndarray, src: np.ndarray, degree: int):
    """Append src into dst's adjacency (numpy, in place); collect nodes that
    overflow.  Returns (overflow node set, {node: its first OVERFLOW_W
    unplaced sources}) — the reference's module-global buffer, local."""
    buf: dict[int, np.ndarray] = {}
    overflow = set()
    # group by destination
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    starts = np.searchsorted(dst, np.unique(dst))
    uniq = np.unique(dst)
    bounds = np.append(starts, len(dst))
    for i, node in enumerate(uniq):
        incoming = src[bounds[i] : bounds[i + 1]]
        row = nbrs[node]
        existing = set(row[row >= 0].tolist())
        new = [s for s in incoming.tolist() if s not in existing and s != node]
        if not new:
            continue
        free = np.where(row < 0)[0]
        n_fit = min(len(free), len(new))
        if n_fit:
            nbrs[node, free[:n_fit]] = new[:n_fit]
        rest = new[n_fit:]
        if rest:
            buf[int(node)] = np.asarray(rest[:OVERFLOW_W], dtype=np.int32)
            overflow.add(int(node))
    return overflow, buf


def _overflow_extra(ob: np.ndarray, buf: dict) -> np.ndarray:
    """Extra candidate columns gathered for overflowing nodes this batch."""
    out = np.full((len(ob), OVERFLOW_W), -1, dtype=np.int32)
    for i, node in enumerate(ob):
        extra = buf.get(int(node))
        if extra is not None:
            k = min(len(extra), OVERFLOW_W)
            out[i, :k] = extra[:k]
    return out


def add_reverse_edges(nbrs: torch.Tensor, dst: torch.Tensor, src: torch.Tensor):
    """``_add_reverse_edges`` vectorised on ``nbrs``' device, in place.

    Every (dst, src) pair is grouped by dst in the stable order of the
    numpy loop; a pair survives if src is neither dst nor already in dst's
    row (as the row was before this call; repeated sources stay repeated).
    A node's k-th survivor takes its k-th free slot; the survivors past its
    free slots make it overflow, and the first OVERFLOW_W of them are its
    extra candidates.  Returns (overflow nodes, ascending (K,) int32;
    their extra candidates (K, OVERFLOW_W) int32, -1 padded).
    """
    dev = nbrs.device
    r = nbrs.shape[1]
    order = torch.sort(dst, stable=True).indices
    dst, src = dst[order], src[order]
    row = nbrs[dst.long()]
    keep = (src != dst) & ~(row == src[:, None]).any(1)
    dst, src, row = dst[keep], src[keep], row[keep]
    e = dst.shape[0]
    idx = torch.arange(e, device=dev)
    start = torch.ones(e, dtype=torch.bool, device=dev)
    start[1:] = dst[1:] != dst[:-1]
    rank = idx - torch.cummax(torch.where(start, idx, 0), 0).values  # within its node
    free = row < 0
    n_free = free.sum(1)
    # the free slots of a row in ascending position, first
    free_pos = torch.sort((~free).to(torch.int8), dim=1, stable=True).indices
    fit = rank < n_free
    pos = free_pos.gather(1, rank.clamp(max=r - 1)[:, None])[:, 0]
    nbrs[dst[fit].long(), pos[fit]] = src[fit]
    over = ~fit
    nodes = torch.unique(dst[over])
    extra = torch.full((nodes.shape[0], OVERFLOW_W), INVALID, dtype=torch.int32, device=dev)
    orank = rank - n_free
    take = over & (orank < OVERFLOW_W)
    at = torch.searchsorted(nodes, dst[take])
    extra[at, orank[take]] = src[take]
    return nodes.int(), extra


def _pad(batch: np.ndarray, size: int) -> np.ndarray:
    """Pad to a fixed batch with copies of the first id (the reference
    pads so its jit never retraces; duplicate writes are idempotent)."""
    if len(batch) < size:
        batch = np.concatenate([batch, batch[np.zeros(size - len(batch), dtype=np.int64)]])
    return batch


def _as_vectors(vectors, device) -> torch.Tensor:
    if isinstance(vectors, torch.Tensor):
        dev = vectors.device if device is None else resolve_device(device)
        return vectors.to(dev, torch.float32).contiguous()
    return torch.from_numpy(np.asarray(vectors, np.float32)).to(resolve_device(device))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_vamana(
    vectors,
    *,
    degree: int = 32,
    build_l: int = 64,
    alpha: float = 1.2,
    batch_size: int = 512,
    seed: int = 0,
    two_pass: bool = True,
    device=None,
    timings: dict | None = None,
) -> VamanaGraph:
    """Batched Vamana build (ParlayANN-style batch insertion, two passes).

    Pass 1 uses alpha=1.0, pass 2 the final alpha — as in DiskANN. Each
    batch: greedy-search every point from the medoid, RobustPrune its
    visited set, install edges, then add reverse edges and re-prune nodes
    whose degree overflows.

    Runs on the device of ``vectors`` when it is a tensor, else on
    ``device`` (the card unless the caller asks for the CPU).  Overflowing
    nodes are re-pruned ``PRUNE_ROWS`` at a time, not in the reference's
    padded batches (rows are independent, so the split changes nothing).
    ``timings``, when given, gains the seconds of each part:
    ``beam_search``, ``prune``, ``reverse_edges`` (with a device sync at
    each part's end).
    """
    vectors = _as_vectors(vectors, device)
    dev = vectors.device
    n = vectors.shape[0]
    degree = min(degree, n - 1)
    nbrs = torch.from_numpy(_init_random_graph(n, degree, seed)).to(dev)
    medoid = find_medoid(vectors)
    rng = np.random.default_rng(seed + 1)
    alphas = [1.0, alpha] if two_pass else [alpha]
    max_expand = max(2 * build_l, 128)
    clock = {"beam_search": 0.0, "prune": 0.0, "reverse_edges": 0.0}

    def tick(part: str, t0: float) -> float:
        if timings is None:
            return t0
        _sync(dev)
        t1 = time.perf_counter()
        clock[part] += t1 - t0
        return t1

    t = time.perf_counter()
    for pass_alpha in alphas:
        order = rng.permutation(n)
        for start in range(0, n, batch_size):
            batch = torch.from_numpy(
                _pad(order[start : start + batch_size].astype(np.int32), batch_size)).to(dev)
            res = beam_search_batch(nbrs, vectors, medoid, vectors[batch.long()],
                                    search_l=build_l, beam_width=4, max_expand=max_expand)
            t = tick("beam_search", t)
            # candidate pool: visited set ∪ frontier ∪ current neighbours
            cands = torch.cat([res.expanded_ids, res.ids, nbrs[batch.long()]], dim=1)
            pruned = robust_prune_batch(batch, cands, vectors, alpha=pass_alpha, degree=degree)
            nbrs[batch.long()] = pruned
            t = tick("prune", t)
            dst = pruned.reshape(-1)
            ok = dst >= 0
            onodes, extra = add_reverse_edges(nbrs, dst[ok],
                                              batch.repeat_interleave(degree)[ok])
            t = tick("reverse_edges", t)
            for os_ in range(0, onodes.shape[0], PRUNE_ROWS):
                ob = onodes[os_ : os_ + PRUNE_ROWS]
                ocands = torch.cat([nbrs[ob.long()], extra[os_ : os_ + PRUNE_ROWS]], dim=1)
                nbrs[ob.long()] = robust_prune_batch(ob, ocands, vectors, alpha=pass_alpha,
                                                     degree=degree)
            t = tick("prune", t)
    if timings is not None:
        for part, s in clock.items():
            timings[part] = timings.get(part, 0.0) + s
    return VamanaGraph(neighbors=nbrs, medoid=medoid)


# ---------------------------------------------------------------------------
# FilteredVamana (F-DiskANN baseline)
# ---------------------------------------------------------------------------

class FilteredVamanaGraph(NamedTuple):
    neighbors: torch.Tensor  # (N, R)
    medoid: int  # global medoid
    label_medoids: torch.Tensor  # (n_labels,) int32 per-label entry points


def build_filtered_vamana(
    vectors,
    labels: np.ndarray,  # (N,) int single-label
    *,
    degree: int = 32,
    build_l: int = 64,
    alpha: float = 1.2,
    batch_size: int = 512,
    seed: int = 0,
    device=None,
) -> FilteredVamanaGraph:
    """F-DiskANN's FilteredVamana (single-label form).

    Candidate generation searches from the point's *label medoid* and
    keeps the same-label candidates; RobustPrune over those fills the
    last ``max(degree // 4, 4)`` slots of the base Vamana graph's rows.
    """
    vectors = _as_vectors(vectors, device)
    dev = vectors.device
    labels = np.asarray(labels)
    n = vectors.shape[0]
    n_labels = int(labels.max()) + 1
    base = build_vamana(vectors, degree=degree, build_l=build_l, alpha=alpha,
                        batch_size=batch_size, seed=seed)
    nbrs = base.neighbors.clone()

    # per-label medoids (numpy, as the reference)
    label_medoids = np.zeros(n_labels, dtype=np.int32)
    vec_np = vectors.cpu().numpy()
    for lab in range(n_labels):
        idx = np.where(labels == lab)[0]
        if len(idx) == 0:
            label_medoids[lab] = base.medoid
            continue
        cen = vec_np[idx].mean(axis=0, keepdims=True)
        label_medoids[lab] = idx[np.argmin(((vec_np[idx] - cen) ** 2).sum(axis=1))]

    # label-aware edge augmentation: reserve a fraction of each node's
    # degree for same-label neighbours found by a filtered search
    reserve = max(degree // 4, 4)
    rng = np.random.default_rng(seed + 7)
    order = rng.permutation(n)
    for start in range(0, n, batch_size):
        batch = order[start : start + batch_size].astype(np.int32)
        bl = labels[batch]
        bt = torch.from_numpy(batch).to(dev)
        res = beam_search_batch(nbrs, vectors, torch.from_numpy(label_medoids[bl]).to(dev),
                                vectors[bt.long()], search_l=build_l, beam_width=4,
                                max_expand=2 * build_l)
        cand = res.ids.cpu().numpy()
        cand_lab = np.where(cand >= 0, labels[np.maximum(cand, 0)], -2)
        same = np.where(cand_lab == bl[:, None], cand, -1).astype(np.int32)
        pruned = robust_prune_batch(bt, torch.from_numpy(same).to(dev), vectors, alpha=alpha,
                                    degree=reserve)
        nbrs[bt.long(), degree - reserve :] = pruned  # keeps the base connectivity
    return FilteredVamanaGraph(neighbors=nbrs, medoid=base.medoid,
                               label_medoids=torch.from_numpy(label_medoids).to(dev))
