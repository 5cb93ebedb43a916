"""Sorted top-k on the lexicographic (dist, id) key: CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/topk_merge.py::topk_merge``.
Source ``repro_torch/csrc/topk_merge.cu``; its header note says what
bounds the kernel on the card and how the design answers that.

The contract is the TPU kernel's: each row of (dists, ids) is padded to
P = the next power of two >= M with (3.4e38, 2**31 - 1), sorted
ascending by distance with ties broken by ascending id, and the first
``min(k, P)`` entries come back, pad ids mapped to -1.  So ``k > M``
returns pad entries: the output width is ``min(k, P)``, not
``min(k, M)``.  Keys must be free of NaN.

The plain version sorts with two stable sorts (by id, then by distance),
so keys equal as (distance, id) keep their input order; the kernel breaks
those ties by position, which gives the same rows.  The kernel has three
routes, chosen by shape in the library (``route`` asks it): for k up to
32 on many rows a warp selects a row's first k keys, up to 64 otherwise a
block's radix select does, and above that the TPU kernel's bitonic
network sorts the row.  A wrapper
runs the plain version only for CPU tensors; for CUDA tensors it launches
the kernel or raises — also for a P whose keys do not fit in a block's
shared memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "topk_merge"
PAD_DIST = 3.4e38
PAD_ID = 2**31 - 1
# the network route's 12 * P bytes of keys must fit a block's 227 KB of shared memory
MAX_WIDTH = 16384
ROUTES = ("warp_select", "block_select", "network")


def route(b: int, m: int, k: int) -> str:
    """The route the kernel's launcher takes for ``b`` rows of width ``m``
    and a given ``k`` on the current CUDA device (the library's
    ``topk_merge_route``; builds it)."""
    fn = _build.entry(NAME, "topk_merge_route", 0, 3, stream=False)
    r = fn(b, m, min(k, padded_width(m)))
    if r < 0:
        raise RuntimeError("topk_merge_route: the CUDA device could not be queried")
    return ROUTES[r]


def padded_width(m: int) -> int:
    """The network width P: the next power of two >= m (2 for m = 0, as
    in the reference)."""
    return 1 << (m - 1).bit_length()


def topk_merge_ref(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """dists (B, M) f32, ids (B, M) i32 -> (dists, ids) (B, min(k, P))."""
    b, m = dists.shape
    p = padded_width(m)
    d = torch.cat([dists, torch.full((b, p - m), PAD_DIST, dtype=torch.float32,
                                     device=dists.device)], dim=1)
    i = torch.cat([ids, torch.full((b, p - m), PAD_ID, dtype=torch.int32, device=ids.device)],
                  dim=1)
    by_id = torch.sort(i, dim=1, stable=True).indices
    d, i = d.gather(1, by_id), i.gather(1, by_id)
    by_dist = torch.sort(d, dim=1, stable=True).indices[:, : min(k, p)]
    d, i = d.gather(1, by_dist), i.gather(1, by_dist)
    return d, torch.where(i == PAD_ID, -1, i)


def topk_merge(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """Sorted top-k by ascending (distance, id): (dists, ids) (B, min(k, P))."""
    if dists.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"want dists float32 and ids int32, got {dists.dtype}, {ids.dtype}")
    if dists.dim() != 2 or ids.shape != dists.shape:
        raise ValueError(f"dists {tuple(dists.shape)} / ids {tuple(ids.shape)} are not one (B, M)")
    if dists.device != ids.device:
        raise ValueError("dists and ids must lie on one device")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if dists.device.type == "cpu":
        return topk_merge_ref(dists, ids, k)
    b, m = dists.shape
    p = padded_width(m)
    if _build.is_meta(dists):
        outs = (dists.new_empty((b, min(k, p))), ids.new_empty((b, min(k, p))))
        _build.charge(NAME, dists, ids, *outs)
        return outs
    if p > MAX_WIDTH:
        raise ValueError(f"M = {m} pads to {p} keys, which do not fit in a block's shared "
                         f"memory (at most {MAX_WIDTH})")
    if not (dists.is_contiguous() and ids.is_contiguous()):
        raise ValueError("topk_merge wants contiguous tensors")
    kk = min(k, p)
    out_d = torch.empty((b, kk), dtype=torch.float32, device=dists.device)
    out_i = torch.empty((b, kk), dtype=torch.int32, device=dists.device)
    if b == 0:  # nothing to compute: no launch, and none counted
        return out_d, out_i
    fn = _build.entry(NAME, "topk_merge_launch", 4, 4)
    err = fn(_build.ptr(dists), _build.ptr(ids), _build.ptr(out_d), _build.ptr(out_i),
             b, m, p, kk, _build.stream_ptr(dists))
    _build.check(err, "topk_merge_launch")
    _build.LAUNCHES[NAME] += 1
    return out_d, out_i
