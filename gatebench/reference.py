"""The plain reference of filtered search, in PyTorch, on any device.

Two things, both from the benchmark's own inputs (corpus, labels, graph, PQ
books and codes) and nothing the program derived:

* ``exact_topk``: the exact filtered top-k by brute force, in float64: the
  ground truth recall is measured against.
* ``search``: GateANN's filtered beam search (Algorithm 1, ``gate`` mode)
  written out plainly, one row a query, in a stated dtype.  It rebuilds the
  per-query PQ tables and the whole search state itself.  Its rules are the
  algorithm's: a frontier of the ``L`` best candidates by PQ distance, ties
  kept in insertion order; each round the ``W`` best unexpanded are taken;
  a node that passes the predicate has its record fetched (counted), its
  exact distance scored into the top-``K`` and its full adjacency added; a
  node that fails it is tunnelled through its first ``r_max`` neighbours
  and never fetched; candidates seen before are dropped.  The loop ends
  when no row has unexpanded work or after ``max_hops`` rounds.

In float64 it is the yardstick; in bfloat16 it is the control that the
comparison in ``check.py`` has to refuse.  Nothing here imports the program.
"""
from __future__ import annotations

import torch

INF = float("inf")


def exact_topk(base: torch.Tensor, queries: torch.Tensor, k: int, labels=None,
               query_labels=None, block: int = 256) -> torch.Tensor:
    """(Q, k) int64 ids of the exact nearest rows under the predicate
    (``labels[n] == query_labels[q]``, or none), in float64; -1 where fewer
    match."""
    xd = base.double()
    xx = (xd * xd).sum(1)
    out = torch.empty((queries.shape[0], k), dtype=torch.int64, device=base.device)
    for s in range(0, queries.shape[0], block):
        qd = queries[s:s + block].double()
        d = (qd * qd).sum(1)[:, None] - 2.0 * (qd @ xd.T) + xx[None]
        if labels is not None:
            d = torch.where(labels[None, :] == query_labels[s:s + block, None], d, INF)
        dist, ids = torch.topk(d, k, dim=1, largest=False, sorted=True)
        out[s:s + block] = torch.where(torch.isfinite(dist), ids, -1)
    return out


def _stable_order(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True).indices


def _dedup_dead(ids: torch.Tensor, dists: torch.Tensor):
    """Invalid ids and every repeat of an id after its first slot become
    (-1, inf)."""
    order = _stable_order(ids)
    s = ids.gather(-1, order)
    rep = torch.zeros_like(ids, dtype=torch.bool)
    rep[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    rep = torch.zeros_like(rep).scatter(-1, order, rep)
    dead = rep | (ids < 0)
    return torch.where(dead, -1, ids), torch.where(dead, INF, dists)


def _keep_best(ids, dists, extra, size):
    """Stable sort by distance, keep ``size`` slots (``extra`` rides along)."""
    order = _stable_order(dists)[:, :size]
    return ids.gather(1, order), dists.gather(1, order), \
        None if extra is None else extra.gather(1, order)


def search(queries: torch.Tensor, *, base: torch.Tensor, neighbors: torch.Tensor,
           codes: torch.Tensor, books: torch.Tensor, medoid: int, labels=None,
           targets=None, search_l: int, beam_width: int, result_k: int, r_max: int,
           max_hops: int = 512, dtype=torch.float64) -> dict:
    """Gate-mode filtered search of each query row; ``labels``/``targets``
    give the equality predicate (None: every node passes).

    Returns ``ids`` (S, K) int64 and ``dists`` (S, K), and per row ``ios``
    (records fetched), ``tunnels``, ``exact`` (exact distances) and
    ``scored`` (new candidates given a PQ distance)."""
    dev = queries.device
    s, n = queries.shape[0], base.shape[0]
    L, W, K = search_l, beam_width, result_k
    c, kc, dc = books.shape
    q = queries.to(dtype)
    bk = books.to(dtype)
    # per-query PQ tables: lut[s, c, k] = ||q_c - book_ck||^2
    lut = ((q.reshape(s, c, 1, dc) - bk[None]) ** 2).sum(-1)  # (S, C, K)
    codes = codes.long()
    nbrs = neighbors.long()
    tun = nbrs[:, :r_max]
    rows = torch.arange(s, device=dev)

    def pq_dist(ids):  # (S, M) -> (S, M), inf for ids < 0
        cd = codes[ids.clamp(min=0)]  # (S, M, C)
        d = lut[rows[:, None, None], torch.arange(c, device=dev)[None, None], cd].sum(-1)
        return torch.where(ids >= 0, d, INF)

    def passes(ids):
        if labels is None:
            return ids >= 0
        return (labels[ids.clamp(min=0)] == targets[:, None]) & (ids >= 0)

    f_ids = torch.full((s, L), -1, dtype=torch.int64, device=dev)
    f_d = torch.full((s, L), INF, dtype=dtype, device=dev)
    f_exp = torch.zeros((s, L), dtype=torch.bool, device=dev)
    f_ids[:, 0] = medoid
    f_d[:, :1] = pq_dist(f_ids[:, :1])
    r_ids = torch.full((s, K), -1, dtype=torch.int64, device=dev)
    r_d = torch.full((s, K), INF, dtype=dtype, device=dev)
    visited = torch.zeros((s, n + 1), dtype=torch.bool, device=dev)
    visited[:, medoid] = True
    counts = {k: torch.zeros(s, dtype=torch.int64, device=dev)
              for k in ("ios", "tunnels", "exact", "scored")}

    hops = 0
    while hops < max_hops and bool(((~f_exp) & (f_ids >= 0)).any()):
        hops += 1
        sel_d = torch.where((~f_exp) & (f_ids >= 0), f_d, INF)
        slots = _stable_order(sel_d)[:, :W]
        valid = torch.isfinite(sel_d.gather(1, slots))
        sel = torch.where(valid, f_ids.gather(1, slots), -1)
        f_exp = f_exp | torch.zeros_like(f_exp).scatter(1, slots, valid)
        ok = passes(sel) & valid
        tunnel = valid & ~ok
        counts["ios"] += ok.sum(1)
        counts["tunnels"] += tunnel.sum(1)
        counts["exact"] += ok.sum(1)
        # stage B: the fetched records' exact distances into the top K
        fetched = torch.where(ok, sel, -1)
        x = base[fetched.clamp(min=0)].to(dtype)
        ex = ((x - q[:, None, :]) ** 2).sum(-1)
        r_ids, r_d = _dedup_dead(torch.cat([r_ids, fetched], 1),
                                 torch.cat([r_d, torch.where(ok, ex, INF)], 1))
        r_ids, r_d, _ = _keep_best(r_ids, r_d, None, K)
        # new candidates: full adjacency of the fetched, r_max of the tunnelled
        full = torch.where(ok[..., None], nbrs[fetched.clamp(min=0)], -1)
        part = torch.where(tunnel[..., None], tun[sel.clamp(min=0)], -1)
        new = torch.cat([full.reshape(s, -1), part.reshape(s, -1)], 1)
        slot = torch.where(new >= 0, new, n)
        new = torch.where((new >= 0) & ~visited.gather(1, slot), new, -1)
        visited.scatter_(1, torch.where(new >= 0, new, n), True)
        counts["scored"] += (new >= 0).sum(1)
        ids, d = _dedup_dead(torch.cat([f_ids, new], 1), torch.cat([f_d, pq_dist(new)], 1))
        exp = torch.cat([f_exp, torch.zeros_like(new, dtype=torch.bool)], 1)
        f_ids, f_d, f_exp = _keep_best(ids, d, exp, L)
    return {"ids": r_ids, "dists": r_d, **counts, "hops": hops}
