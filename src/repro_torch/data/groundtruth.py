"""Exact filtered k-NN ground truth (for Recall@k)."""
from __future__ import annotations

import numpy as np


def filtered_ground_truth(
    corpus: np.ndarray,
    queries: np.ndarray,
    match_mask: np.ndarray,  # (B, N) bool or (N,) bool
    k: int = 10,
    block: int = 8192,
) -> np.ndarray:
    """Brute-force top-k among matching nodes. Returns (B, k) int32, -1 pad."""
    b = queries.shape[0]
    n = corpus.shape[0]
    if match_mask.ndim == 1:
        match_mask = np.broadcast_to(match_mask[None, :], (b, n))
    best_d = np.full((b, k), np.inf, dtype=np.float64)
    best_i = np.full((b, k), -1, dtype=np.int64)
    q_sq = (queries.astype(np.float64) ** 2).sum(1)[:, None]
    for s in range(0, n, block):
        blk = corpus[s : s + block].astype(np.float64)
        d = q_sq - 2.0 * queries.astype(np.float64) @ blk.T + (blk**2).sum(1)[None, :]
        d = np.where(match_mask[:, s : s + block], d, np.inf)
        cat_d = np.concatenate([best_d, d], axis=1)
        cat_i = np.concatenate(
            [best_i, np.broadcast_to(np.arange(s, s + blk.shape[0])[None, :], d.shape)], axis=1
        )
        sel = np.argpartition(cat_d, kth=k - 1, axis=1)[:, :k]
        best_d = np.take_along_axis(cat_d, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
        order = np.argsort(best_d, axis=1)
        best_d = np.take_along_axis(best_d, order, axis=1)
        best_i = np.take_along_axis(best_i, order, axis=1)
    best_i[~np.isfinite(best_d)] = -1
    return best_i.astype(np.int32)
