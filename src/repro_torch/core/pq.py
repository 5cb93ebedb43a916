"""Product Quantization (PQ) — the in-memory approximate-distance substrate.

Port of ``repro.core.pq``.  Shapes / conventions:

  vectors : (N, D) float32
  codes   : (N, C) int32     C = n_chunks, D % C == 0
  books   : (C, K, D/C) float32
  lut     : (B, C, K) float32 per-query chunk-centroid distances

Two summation orders are fixed here, so the CPU and the card give the
same bits:

  * chunk distances ``||x||^2 - 2 x.b + ||b||^2`` accumulate each dot
    product as a chain of fused multiply-adds over the chunk's
    dimensions, starting from 0 — the order XLA's CPU backend uses for
    the reference's ``build_lut``.  The FMA is computed in float64 and
    rounded once to float32, which is exact for float32 products on any
    device.
  * ADC sums ``lut[b, c, code_c]`` left to right over c = 0..C-1 — the
    order of the ADC kernel and of the fused round's ADC.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import pq_lookup as pqk


class PQCodec(NamedTuple):
    """Trained PQ codebooks."""

    books: torch.Tensor  # (C, K, Dc)
    n_chunks: int
    n_centroids: int

    @property
    def dim(self) -> int:
        return self.books.shape[0] * self.books.shape[2]


def _fma_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of x * y as an FMA chain from 0 (float32)."""
    acc = torch.zeros(torch.broadcast_shapes(x.shape, y.shape)[:-1], dtype=torch.float64,
                      device=x.device)
    for d in range(x.shape[-1]):
        acc = (x[..., d].double() * y[..., d].double() + acc).float().double()
    return acc.float()


def chunk_sq_dists(x: torch.Tensor, books: torch.Tensor) -> torch.Tensor:
    """Per-chunk squared distances to every centroid.

    x: (..., C, Dc), books (C, K, Dc) -> (..., C, K) as
    ``(||x_c||^2 - (2 x_c).b_ck) + ||b_ck||^2``.
    """
    xx = _fma_dot(x, x)[..., None]  # (..., C, 1)
    xb = _fma_dot((2.0 * x)[..., None, :], books)  # (..., C, K)
    bb = _fma_dot(books, books)  # (C, K)
    return (xx - xb) + bb


def build_lut(codec: PQCodec, queries: torch.Tensor) -> torch.Tensor:
    """Per-query ADC lookup table: lut[b, c, k] = ||q_bc - book_ck||^2.

    queries: (B, D) -> (B, C, K) float32
    """
    c, _, dc = codec.books.shape
    return chunk_sq_dists(queries.reshape(queries.shape[0], c, dc), codec.books)


def encode_pq(codec: PQCodec, vectors: torch.Tensor, *, block: int = 8192) -> torch.Tensor:
    """Assign each vector chunk to its nearest centroid. -> (N, C) int32.

    Rows go through in blocks of ``block`` so the (block, C, K) distance
    table stays bounded at any N.
    """
    c, _, dc = codec.books.shape
    out = torch.empty((vectors.shape[0], c), dtype=torch.int32, device=vectors.device)
    for s in range(0, vectors.shape[0], block):
        blk = vectors[s : s + block].reshape(-1, c, dc)
        out[s : s + block] = torch.argmin(chunk_sq_dists(blk, codec.books), dim=-1).int()
    return out


def decode_pq(codec: PQCodec, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct approximate vectors from codes. -> (N, D)."""
    c, _, dc = codec.books.shape
    chunk = torch.arange(c, device=codes.device)
    return codec.books[chunk, codes.long()].reshape(codes.shape[0], c * dc)


def adc_lookup_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """dist[b, n] = sum_c lut[b, c, codes[n, c]], summed left to right over c.

    lut: (B, C, K), codes: (N, C) -> (B, N) float32.
    """
    return pqk.pq_scan_ref(lut, codes)


def adc_lookup(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Approximate distances over a shared (N, C) code table: the scan
    kernel (``kernels.pq_lookup.pq_scan``) for CUDA tensors,
    ``adc_lookup_ref`` for CPU tensors."""
    return pqk.pq_scan(lut, codes)


def _kmeans_one_chunk(sub: torch.Tensor, k: int, iters: int,
                      generator: torch.Generator) -> torch.Tensor:
    """Lloyd's k-means for one PQ chunk. sub: (N, Dc) -> (k, Dc)."""
    n = sub.shape[0]
    if n >= k:
        init = torch.randperm(n, generator=generator, device=generator.device)[:k]
    else:
        init = torch.randint(n, (k,), generator=generator, device=generator.device)
    cents = sub[init.to(sub.device)]
    for _ in range(iters):
        assign = torch.argmin(chunk_sq_dists(sub[:, None, :], cents[None]), dim=-1)[:, 0]
        counts = torch.zeros(k, dtype=sub.dtype, device=sub.device).index_add_(
            0, assign, torch.ones_like(assign, dtype=sub.dtype))
        sums = torch.zeros_like(cents).index_add_(0, assign, sub)
        cents = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1.0)[:, None], cents)
    return cents


def train_pq(vectors: torch.Tensor, *, n_chunks: int = 32, n_centroids: int = 256,
             iters: int = 8, generator: torch.Generator | None = None) -> PQCodec:
    """Train per-chunk k-means codebooks on (a sample of) the corpus.

    Same algorithm as the reference (random initial centroids, ``iters``
    Lloyd steps); the random draws come from ``generator`` and so differ
    from ``jax.random``'s bits for the same seed.
    """
    if generator is None:
        generator = torch.Generator(device=vectors.device).manual_seed(0)
    n, d = vectors.shape
    if d % n_chunks:
        raise ValueError(f"dim {d} not divisible by n_chunks {n_chunks}")
    subs = vectors.reshape(n, n_chunks, d // n_chunks)
    books = torch.stack([
        _kmeans_one_chunk(subs[:, c], n_centroids, iters, generator) for c in range(n_chunks)
    ])
    return PQCodec(books=books, n_chunks=n_chunks, n_centroids=n_centroids)


def pq_memory_bytes(n: int, n_chunks: int = 32) -> int:
    """Paper Table 2: PQ vectors = N * 32 B at the default 32 chunks."""
    return n * n_chunks


def train_pq_numpy(vectors: np.ndarray, n_chunks: int = 32, n_centroids: int = 256,
                   iters: int = 8, seed: int = 0, device=None) -> PQCodec:
    """Convenience host-side wrapper (samples big corpora before training):
    past 65,536 rows the reference's sample (``default_rng(seed).choice``),
    then ``train_pq`` on ``device`` (the card unless the caller asks for
    the CPU) with a ``torch.Generator`` seeded from ``seed``."""
    dev = resolve_device(device)
    sample = vectors
    if vectors.shape[0] > 65536:
        idx = np.random.default_rng(seed).choice(vectors.shape[0], 65536, replace=False)
        sample = vectors[idx]
    return train_pq(torch.from_numpy(np.asarray(sample, dtype=np.float32)).to(dev),
                    n_chunks=n_chunks, n_centroids=n_centroids, iters=iters,
                    generator=torch.Generator(device=dev).manual_seed(seed))
