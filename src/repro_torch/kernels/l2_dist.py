"""Exact squared-L2 re-ranking distances: CUDA kernel + plain versions.

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

The device decides kernel or plain version; ``tree`` decides the
function.  CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "l2_dist"


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


def l2_dist(queries: torch.Tensor, rows: torch.Tensor, *, tree: bool = True) -> torch.Tensor:
    if queries.dtype != torch.float32 or rows.dtype != torch.float32:
        raise TypeError(f"want float32, got {queries.dtype}, {rows.dtype}")
    if queries.device != rows.device:
        raise ValueError("queries and rows must lie on one device")
    if queries.dim() != 2 or rows.dim() != 3 or rows.shape[0] != queries.shape[0] \
            or rows.shape[2] != queries.shape[1] or queries.shape[1] < 1:
        raise ValueError(f"shapes {tuple(queries.shape)} / {tuple(rows.shape)} are not (B, D) / (B, W, D)")
    if queries.device.type == "cpu":
        return l2_tree_ref(queries, rows) if tree else l2_expanded_ref(queries, rows)
    if not (queries.is_contiguous() and rows.is_contiguous()):
        raise ValueError("l2_dist wants contiguous tensors")
    b, w, d = rows.shape
    out = torch.empty((b, w), dtype=torch.float32, device=rows.device)
    if b == 0 or w == 0:  # nothing to compute: no launch, and none counted
        return out
    fn =_build.entry(NAME, "l2_dist_launch", 3, 4)
    err = fn(_build.ptr(queries), _build.ptr(rows), _build.ptr(out), b, w, d, int(tree),
             _build.stream_ptr(rows))
    _build.check(err, "l2_dist_launch")
    _build.LAUNCHES[NAME] += 1
    return out
