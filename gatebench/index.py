"""The index a deployment serves, built by plain PyTorch from the corpus.

A Vamana build of 1M vectors takes minutes a run, so the graph is the one
``chip_smoke.py`` builds (``knn_graph``, copied here and frozen): each node's
``exact`` nearest neighbours in ascending distance, then ``degree - exact``
links drawn at random from the seed.  The PQ codebooks come from Lloyd's
k-means on a seeded sample, one codebook a chunk, all chunks at once; sums
are one-hot products, not atomics, so the same seed gives the same books.
The medoid is the row nearest the mean.  Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class IndexSpec:
    degree: int  # R: the full adjacency a record carries
    exact: int  # exact nearest neighbours among the R
    pq_chunks: int  # C
    pq_centroids: int  # K
    pq_sample: int  # rows k-means trains on
    pq_iters: int
    r_max: int  # neighbours held on the device for tunnelling


def knn_graph(x: torch.Tensor, degree: int, exact: int, gen: torch.Generator,
              block: int = 1024) -> torch.Tensor:
    """(N, degree) int32: ``exact`` exact neighbours in ascending distance
    (self excluded), then ``degree - exact`` seeded random ids."""
    n = x.shape[0]
    xx = (x * x).sum(1)
    out = torch.empty((n, degree), dtype=torch.int32, device=x.device)
    for s in range(0, n, block):
        blk = x[s:s + block]
        d = (blk @ x.T).mul_(-2.0).add_(xx[None]).add_(xx[s:s + block, None])
        ids = torch.topk(d, exact + 1, dim=1, largest=False, sorted=True).indices
        own = torch.arange(s, s + blk.shape[0], device=x.device)[:, None]
        keep = torch.sort((ids == own).int(), dim=1, stable=True).indices[:, :exact]
        out[s:s + block, :exact] = ids.gather(1, keep).int()
    out[:, exact:] = torch.randint(0, n, (n, degree - exact), generator=gen,
                                   device=x.device, dtype=torch.int32)
    return out


def _sq_dists(sub: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """(C, S, Dc) rows, (C, K, Dc) centroids -> (C, S, K) squared distances."""
    return ((sub * sub).sum(-1, keepdim=True) - 2.0 * torch.bmm(sub, cents.transpose(1, 2))
            + (cents * cents).sum(-1)[:, None, :])


def train_pq(x: torch.Tensor, spec: IndexSpec, gen: torch.Generator) -> torch.Tensor:
    """(C, K, D / C) float32 codebooks by Lloyd's k-means on a sample."""
    n, d = x.shape
    c, k = spec.pq_chunks, spec.pq_centroids
    rows = torch.randperm(n, generator=gen, device=x.device)[:min(spec.pq_sample, n)]
    sub = x[rows].reshape(-1, c, d // c).transpose(0, 1).contiguous()  # (C, S, Dc)
    init = torch.randperm(sub.shape[1], generator=gen, device=x.device)[:k]
    cents = sub[:, init].clone()
    for _ in range(spec.pq_iters):
        assign = torch.argmin(_sq_dists(sub, cents), dim=-1)  # (C, S)
        onehot = torch.zeros((c, k, sub.shape[1]), dtype=x.dtype, device=x.device)
        onehot.scatter_(1, assign[:, None, :], 1.0)
        counts = onehot.sum(-1, keepdim=True)
        sums = torch.bmm(onehot, sub)
        cents = torch.where(counts > 0, sums / counts.clamp(min=1.0), cents)
    return cents.contiguous()


def encode(x: torch.Tensor, books: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """(N, C) int32: each chunk's nearest centroid."""
    c, _, dc = books.shape
    out = torch.empty((x.shape[0], c), dtype=torch.int32, device=x.device)
    for s in range(0, x.shape[0], block):
        sub = x[s:s + block].reshape(-1, c, dc).transpose(0, 1)
        out[s:s + block] = torch.argmin(_sq_dists(sub, books), dim=-1).T.int()
    return out


def medoid(x: torch.Tensor) -> int:
    return int(torch.argmin(((x - x.mean(0, keepdim=True)) ** 2).sum(1)))


def build(x: torch.Tensor, spec: IndexSpec, gen: torch.Generator) -> dict:
    """``neighbors`` (N, R) int32, ``books`` (C, K, D/C) float32, ``codes``
    (N, C) int32 and ``medoid``, on ``x``'s device."""
    nbrs = knn_graph(x, spec.degree, spec.exact, gen)
    books = train_pq(x, spec, gen)
    return {"neighbors": nbrs, "books": books, "codes": encode(x, books), "medoid": medoid(x)}
