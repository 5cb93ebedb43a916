"""Synthetic corpora shaped like the paper's datasets (Table 3).

BigANN-style: uint8-quantized SIFT-like vectors (clustered GMM so graphs
have non-trivial structure).  DEEP-style: float32 unit-norm descriptors.
Scaled to CPU-budget N; the statistical shape (clustered, anisotropic)
is what matters for graph behaviour.
"""
from __future__ import annotations

import numpy as np


def _gmm(n: int, dim: int, n_clusters: int, rng: np.random.Generator, spread: float = 0.35):
    centers = rng.normal(0.0, 1.0, size=(n_clusters, dim))
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + rng.normal(0.0, spread, size=(n, dim))
    return x.astype(np.float32), assign


def make_bigann_like(n: int, dim: int = 128, seed: int = 0, n_clusters: int = 64):
    """uint8-range clustered vectors (stored float32 for compute)."""
    rng = np.random.default_rng(seed)
    x, _ = _gmm(n, dim, n_clusters, rng)
    x = x - x.min()
    x = x / x.max() * 255.0
    return np.round(x).astype(np.float32)


def make_deep_like(n: int, dim: int = 96, seed: int = 0, n_clusters: int = 64):
    """Unit-norm float descriptors (DEEP-style)."""
    rng = np.random.default_rng(seed)
    x, _ = _gmm(n, dim, n_clusters, rng)
    x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
    return x.astype(np.float32)


def make_queries(corpus: np.ndarray, n_queries: int, seed: int = 1, noise: float = 0.05):
    """Queries drawn near corpus points (realistic ANN workload)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(corpus.shape[0], size=n_queries, replace=False)
    scale = np.abs(corpus).mean() * noise
    q = corpus[idx] + rng.normal(0.0, scale, size=(n_queries, corpus.shape[1]))
    return q.astype(np.float32)


def make_zipfian_queries(
    corpus: np.ndarray,
    n_queries: int,
    *,
    n_centers: int = 32,
    alpha: float = 1.1,
    seed: int = 1,
    noise: float = 0.05,
    mask: np.ndarray | None = None,
):
    """Skewed production-style workload: queries cluster around a few hot
    corpus points with Zipf(alpha) popularity.

    Center k (of ``n_centers`` points drawn from ``mask``-selected rows,
    or the whole corpus) is chosen with probability ∝ 1/(k+1)^alpha, so
    a handful of regions receive most of the traffic — the regime where
    an adaptive cache beats a static, filter-blind hot set.
    """
    rng = np.random.default_rng(seed)
    pool = np.flatnonzero(mask) if mask is not None else np.arange(corpus.shape[0])
    if pool.size == 0:
        raise ValueError("make_zipfian_queries: mask selects no corpus rows")
    if n_centers <= 0:
        raise ValueError(f"make_zipfian_queries: n_centers must be > 0, got {n_centers}")
    centers = rng.choice(pool, size=min(n_centers, pool.size), replace=False)
    w = 1.0 / np.arange(1, centers.size + 1) ** alpha
    p = w / w.sum()
    picks = centers[rng.choice(centers.size, size=n_queries, p=p)]
    scale = np.abs(corpus).mean() * noise
    q = corpus[picks] + rng.normal(0.0, scale, size=(n_queries, corpus.shape[1]))
    return q.astype(np.float32)
