"""Exact squared-L2 re-ranking distances and the search loop's re-rank:
CUDA kernels + plain versions.

Replaces the TPU kernel ``repro/kernels/l2_dist.py::l2_dist``.  Source
``repro_torch/csrc/l2_dist.cu``; its header note says what bounds it on
the card and how the design answers that.

``l2_dist(queries, rows, tree=...)`` — queries (B, D), rows (B, W, D) ->
(B, W):

  * ``tree=True``: (x - q)^2 summed by the reference search loop's fixed
    pairwise tree (``repro/core/search.py::_exact_dist``), with no FMA
    contraction — kernel and plain version agree bit for bit.
  * ``tree=False``: the expanded form ||x||^2 - 2 q.x + ||q||^2 of the
    TPU kernel; kernel and plain version sum in different orders and
    agree within ``expanded_tolerance``.

``rerank(queries, vecs, sel_ids, result_mask, res_ids, res_dists,
n_degraded, tree=...)`` is one round of the search loop's stage B
(``core/search.py::retire``): the distances, the degraded-record check
and ``frontier.results_insert``, in one launch that shares ``l2_dist``'s
distance.  ``rerank_route`` asks the library's shape rule, before any
launch, whether the kernel takes the shapes (a cap on K + W candidates and
the shared memory the merge and the tree need); other shapes take the
standalone ``l2_dist`` kernel and the plain merge.  ``rerank_ref`` is its
plain version.

The device decides kernel or plain version; ``tree`` decides the
function.  CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import frontier as fr
from repro_torch.kernels import _build

NAME = "l2_dist"
RERANK = "rerank"  # the re-rank kernel's launches count under this name
ROUTES = ("fused", "split")  # the library's rerank_route: 0, 1


def l2_tree_ref(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Pairwise-tree sum of (rows - q)^2 over D; odd tails carry over."""
    diff = rows - queries[:, None, :]
    sq = diff * diff
    while sq.shape[-1] > 1:
        half = sq.shape[-1] // 2 * 2
        head = sq[..., 0:half:2] + sq[..., 1:half:2]
        if half != sq.shape[-1]:
            head = torch.cat([head, sq[..., half:]], dim=-1)
        sq = head
    return sq[..., 0]


def l2_expanded_ref(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """||x||^2 - 2 q.x + ||q||^2, the TPU kernel's expanded form."""
    xx = (rows * rows).sum(-1)
    qx = (rows * queries[:, None, :]).sum(-1)
    qq = (queries * queries).sum(-1)[:, None]
    return (xx - 2.0 * qx) + qq


def expanded_tolerance(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Per-distance bound on |kernel - plain| for the expanded form.

    Both sum D products of magnitude up to ||x||^2 + ||q||^2 in float32 in
    different orders; each order's error is below D * eps times that
    scale, so 2 * D * eps * (||x||^2 + ||q||^2) bounds their difference.
    """
    scale = (rows * rows).sum(-1) + (queries * queries).sum(-1)[:, None]
    return 2.0 * rows.shape[-1] * torch.finfo(torch.float32).eps * scale


def _check_rows(queries: torch.Tensor, rows: torch.Tensor) -> None:
    if queries.dtype != torch.float32 or rows.dtype != torch.float32:
        raise TypeError(f"want float32, got {queries.dtype}, {rows.dtype}")
    if queries.device != rows.device:
        raise ValueError("queries and rows must lie on one device")
    if queries.dim() != 2 or rows.dim() != 3 or rows.shape[0] != queries.shape[0] \
            or rows.shape[2] != queries.shape[1] or queries.shape[1] < 1:
        raise ValueError(f"shapes {tuple(queries.shape)} / {tuple(rows.shape)} are not (B, D) / (B, W, D)")


def l2_dist(queries: torch.Tensor, rows: torch.Tensor, *, tree: bool = True) -> torch.Tensor:
    _check_rows(queries, rows)
    if queries.device.type == "cpu":
        return l2_tree_ref(queries, rows) if tree else l2_expanded_ref(queries, rows)
    b, w, d = rows.shape
    out = torch.empty((b, w), dtype=torch.float32, device=rows.device)
    if _build.is_meta(rows):
        _build.charge(NAME, queries, rows, out)
        return out
    if not (queries.is_contiguous() and rows.is_contiguous()):
        raise ValueError("l2_dist wants contiguous tensors")
    if b == 0 or w == 0:  # nothing to compute: no launch, and none counted
        return out
    fn = _build.entry(NAME, "l2_dist_launch", 3, 4)
    err = fn(_build.ptr(queries), _build.ptr(rows), _build.ptr(out), b, w, d, int(tree),
             _build.stream_ptr(rows))
    _build.check(err, "l2_dist_launch")
    _build.LAUNCHES[NAME] += 1
    return out


def rerank_route(k: int, w: int, d: int, *, tree: bool = True) -> str:
    """``"fused"`` where the re-rank kernel takes K result slots, W rows
    and D, ``"split"`` (the standalone ``l2_dist`` kernel and the plain
    merge) where it does not: the library's ``rerank_route``, which
    ``csrc/l2_dist.cu`` states (builds it)."""
    return ROUTES[_build.entry(NAME, "rerank_route", 0, 4, stream=False)(k, w, d, int(tree))]


def rerank_composed(dist, queries, vecs, sel_ids, result_mask, res_ids, res_dists, n_degraded):
    """Stage B composed of plain ops around ``dist(queries, vecs)`` (the
    parent design of the re-rank, and its route above the kernel's
    limits): a row holding +-inf (a degraded read) in the result mask is
    dropped and counted; the others enter the result list."""
    exact_d = dist(queries, vecs)
    deg = torch.isinf(vecs).any(dim=-1) & result_mask
    ok = result_mask & ~deg
    res = fr.results_insert(fr.ResultList(res_ids, res_dists),
                            torch.where(ok, sel_ids, fr.INVALID), torch.where(ok, exact_d, fr.INF))
    return res.ids, res.dists, n_degraded + deg.sum(dim=1, dtype=torch.int32)


def rerank_ref(queries, vecs, sel_ids, result_mask, res_ids, res_dists, n_degraded, *,
               tree: bool = True):
    """Plain version of ``rerank``: the plain distance, ``isinf``, and
    ``frontier.results_insert``."""
    return rerank_composed(l2_tree_ref if tree else l2_expanded_ref, queries, vecs, sel_ids,
                           result_mask, res_ids, res_dists, n_degraded)


def rerank(queries: torch.Tensor, vecs: torch.Tensor, sel_ids: torch.Tensor,
           result_mask: torch.Tensor, res_ids: torch.Tensor, res_dists: torch.Tensor,
           n_degraded: torch.Tensor, *, tree: bool = True):
    """One round's re-rank: queries (B, D) f32, vecs (B, W, D) f32, sel_ids
    (B, W) i32, result_mask (B, W) bool, the result list res_ids (B, K)
    i32 / res_dists (B, K) f32 and n_degraded (B,) i32 -> the new
    (res_ids, res_dists, n_degraded)."""
    _check_rows(queries, vecs)
    b, w, d = vecs.shape
    k = res_ids.shape[-1]
    if sel_ids.dtype != torch.int32 or res_ids.dtype != torch.int32 \
            or n_degraded.dtype != torch.int32 or result_mask.dtype != torch.bool \
            or res_dists.dtype != torch.float32:
        raise TypeError("want int32 sel_ids, res_ids and n_degraded, bool result_mask and "
                        "float32 res_dists")
    if sel_ids.shape != (b, w) or result_mask.shape != (b, w) or res_ids.shape != (b, k) \
            or res_dists.shape != (b, k) or n_degraded.shape != (b,):
        raise ValueError(f"sel_ids/result_mask {tuple(sel_ids.shape)}/{tuple(result_mask.shape)}, "
                         f"results {tuple(res_ids.shape)}/{tuple(res_dists.shape)}, n_degraded "
                         f"{tuple(n_degraded.shape)} do not fit B = {b}, W = {w}")
    args = (queries, vecs, sel_ids, result_mask, res_ids, res_dists, n_degraded)
    if any(t.device != vecs.device for t in args):
        raise ValueError("rerank's tensors must lie on one device")
    if vecs.device.type == "cpu":
        return rerank_ref(*args, tree=tree)
    if _build.is_meta(vecs):
        outs = (res_ids.new_empty((b, k)), res_dists.new_empty((b, k)), n_degraded.new_empty((b,)))
        _build.charge(RERANK, *args, *outs)
        return outs
    if rerank_route(k, w, d, tree=tree) == "split":
        return rerank_composed(functools.partial(l2_dist, tree=tree), *args)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("rerank wants contiguous tensors")
    dev = vecs.device
    out_ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    out_dists = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_nd = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:  # nothing to compute: no launch, and none counted
        return out_ids, out_dists, out_nd
    fn = _build.entry(NAME, "rerank_launch", 10, 5)
    err = fn(*(_build.ptr(t) for t in args), _build.ptr(out_ids), _build.ptr(out_dists),
             _build.ptr(out_nd), b, w, d, k, int(tree), _build.stream_ptr(vecs))
    _build.check(err, "rerank_launch")
    _build.LAUNCHES[RERANK] += 1
    return out_ids, out_dists, out_nd
