"""Sorted candidate frontier — batched list operations on tensors.

Port of ``repro.core.frontier``.  The frontier is a fixed-size
structure-of-arrays ``(ids, dists, expanded)`` sorted by distance, padded
with (-1, INF).  Every sort is ``torch.sort(..., stable=True)``: the
reference relies on ``jnp.argsort`` being stable, and an unstable sort
would change which id survives a distance tie.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INVALID = -1
INF = 3.4e38  # rounds to float32 3.4e38, the reference's sentinel (not inf)


class Frontier(NamedTuple):
    ids: torch.Tensor  # (B, L) int32
    dists: torch.Tensor  # (B, L) float32 (PQ distances — priority signal only)
    expanded: torch.Tensor  # (B, L) bool — dispatched or tunneled already


def make_frontier(batch: int, size: int, device: torch.device | str) -> Frontier:
    return Frontier(
        ids=torch.full((batch, size), INVALID, dtype=torch.int32, device=device),
        dists=torch.full((batch, size), INF, dtype=torch.float32, device=device),
        expanded=torch.zeros((batch, size), dtype=torch.bool, device=device),
    )


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True).indices


def _dedup_mask(ids: torch.Tensor) -> torch.Tensor:
    """True where this slot duplicates an earlier slot with the same id.

    A stable sort by id puts equal ids in slot order, so every run member
    after the first is a duplicate of an earlier slot — the reference's
    O(M^2) pairwise mask in O(M log M).
    """
    order = _argsort(ids)
    s = ids.gather(-1, order)
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[..., 1:] = (s[..., 1:] == s[..., :-1]) & (s[..., 1:] >= 0)
    return torch.zeros_like(dup).scatter(-1, order, dup)


def _kill(ids: torch.Tensor, dists: torch.Tensor):
    """Duplicates and invalid ids become dead (-1, +INF) slots."""
    dists = torch.where(_dedup_mask(ids) | (ids < 0), INF, dists)
    ids = torch.where(dists >= INF, INVALID, ids)
    return ids, dists


def insert(frontier: Frontier, new_ids: torch.Tensor, new_dists: torch.Tensor) -> Frontier:
    """Merge (B, M) new candidates, dedup by id, keep the best L."""
    l = frontier.ids.shape[-1]
    ids = torch.cat([frontier.ids, new_ids], dim=-1)
    dists = torch.cat([frontier.dists, new_dists], dim=-1)
    expanded = torch.cat([frontier.expanded, torch.zeros_like(new_ids, dtype=torch.bool)], dim=-1)
    ids, dists = _kill(ids, dists)
    order = _argsort(dists)[..., :l]
    return Frontier(
        ids=ids.gather(-1, order),
        dists=dists.gather(-1, order),
        expanded=expanded.gather(-1, order),
    )


def best_unexpanded(frontier: Frontier, width: int):
    """Select up to `width` best unexpanded candidates.

    Returns (sel_ids (B, W), sel_slots (B, W), valid (B, W)).
    """
    sel_d = torch.where((~frontier.expanded) & (frontier.ids >= 0), frontier.dists, INF)
    slots = _argsort(sel_d)[..., :width]
    ids = frontier.ids.gather(-1, slots)
    valid = sel_d.gather(-1, slots) < INF
    return torch.where(valid, ids, INVALID), slots, valid


def mark_expanded(frontier: Frontier, slots: torch.Tensor, valid: torch.Tensor) -> Frontier:
    upd = torch.zeros_like(frontier.expanded).scatter(-1, slots, valid)
    return frontier._replace(expanded=frontier.expanded | upd)


def has_unexpanded(frontier: Frontier) -> torch.Tensor:
    """(B,) — does the frontier hold unexpanded work?"""
    return torch.any((~frontier.expanded) & (frontier.ids >= 0), dim=-1)


class ResultList(NamedTuple):
    """Top-K filter-passing candidates scored with *exact* distances."""

    ids: torch.Tensor  # (B, K)
    dists: torch.Tensor  # (B, K)


def make_results(batch: int, k: int, device: torch.device | str) -> ResultList:
    return ResultList(
        ids=torch.full((batch, k), INVALID, dtype=torch.int32, device=device),
        dists=torch.full((batch, k), INF, dtype=torch.float32, device=device),
    )


def results_insert(res: ResultList, new_ids: torch.Tensor, new_dists: torch.Tensor) -> ResultList:
    k = res.ids.shape[-1]
    ids, dists = _kill(
        torch.cat([res.ids, new_ids], dim=-1), torch.cat([res.dists, new_dists], dim=-1)
    )
    order = _argsort(dists)[..., :k]
    return ResultList(ids=ids.gather(-1, order), dists=dists.gather(-1, order))
