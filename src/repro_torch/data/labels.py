"""Label/metadata generators matching the paper's evaluation settings.

  * uniform 10-class        (BigANN-100M / DEEP-100M, §5.1)
  * Zipf(alpha)             (§5.4.5 skewed labels)
  * k-means correlated(a)   (§5.4.6 spatial label correlation)
  * L2-norm equal-freq bins (§5.4.7 range predicates)
  * power-law multi-tags    (§5.2.5 YFCC-style subset predicates)
"""
from __future__ import annotations

import numpy as np


def uniform_labels(n: int, n_classes: int = 10, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_classes, size=n).astype(np.int32)


def zipf_labels(n: int, n_classes: int = 10, alpha: float = 1.0, seed: int = 0) -> np.ndarray:
    """Class c gets mass ∝ 1/(c+1)^alpha. Paper: top class 34%, rarest 3.4%."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_classes + 1) ** alpha
    p = w / w.sum()
    return rng.choice(n_classes, size=n, p=p).astype(np.int32)


def kmeans_correlated_labels(
    vectors: np.ndarray, n_classes: int = 10, alpha: float = 1.0, seed: int = 0,
    iters: int = 10,
) -> np.ndarray:
    """alpha=0: random labels; alpha=1: label of the nearest k-means center.

    In-between: each node keeps its cluster label with prob alpha, else a
    uniform random label — selectivity stays ~1/n_classes at every alpha.
    """
    rng = np.random.default_rng(seed)
    n = vectors.shape[0]
    # lightweight k-means
    centers = vectors[rng.choice(n, n_classes, replace=False)].copy()
    for _ in range(iters):
        d = ((vectors[:, None, :] - centers[None, :, :]) ** 2).sum(-1) if n <= 20000 else None
        if d is None:  # chunked for big corpora
            assign = np.empty(n, dtype=np.int64)
            for s in range(0, n, 16384):
                blk = vectors[s : s + 16384]
                dd = ((blk[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
                assign[s : s + 16384] = dd.argmin(1)
        else:
            assign = d.argmin(1)
        for c in range(n_classes):
            m = assign == c
            if m.any():
                centers[c] = vectors[m].mean(0)
    keep = rng.random(n) < alpha
    rand = rng.integers(0, n_classes, size=n)
    return np.where(keep, assign, rand).astype(np.int32)


def norm_bin_attribute(vectors: np.ndarray, n_bins: int = 10):
    """Returns (continuous attribute, equal-frequency bin edges).

    The attribute is the vector's L2 norm; bins are equal-frequency so one
    bin ≈ 1/n_bins selectivity (§5.4.7).
    """
    norms = np.linalg.norm(vectors, axis=1)
    edges = np.quantile(norms, np.linspace(0.0, 1.0, n_bins + 1))
    edges[0] -= 1e-6
    edges[-1] += 1e-6
    return norms.astype(np.float32), edges.astype(np.float32)


def multilabel_tags(
    n: int, vocab: int = 2048, mean_tags: float = 6.0, zipf_alpha: float = 1.2, seed: int = 0
):
    """YFCC-like power-law tag assignment. Returns list-of-lists.

    Tag t has popularity ∝ 1/(t+1)^alpha; nodes draw Poisson(mean_tags)
    tags. The top tag covers tens of percent of nodes; most are rare —
    matching §5.2.5's description.
    """
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, vocab + 1) ** zipf_alpha
    p = w / w.sum()
    counts = np.maximum(rng.poisson(mean_tags, size=n), 1)
    out = []
    for c in counts:
        out.append(np.unique(rng.choice(vocab, size=c, p=p)).tolist())
    return out


def multilabel_queries(
    tag_lists, n_queries: int, n_tags: tuple[int, int] = (1, 2), seed: int = 1
):
    """Query tag sets sampled from real node tag sets (so selectivity > 0)."""
    rng = np.random.default_rng(seed)
    out = []
    n = len(tag_lists)
    for _ in range(n_queries):
        node = rng.integers(0, n)
        tags = tag_lists[node]
        k = min(len(tags), rng.integers(n_tags[0], n_tags[1] + 1))
        out.append(sorted(rng.choice(tags, size=k, replace=False).tolist()))
    return out
