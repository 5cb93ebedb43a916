"""One fused stage-A traversal round: CUDA kernel + plain twin.

Replaces the TPU kernel
``repro/kernels/fused_traversal.py::fused_traversal_round``.  Source
``repro_torch/csrc/fused_traversal.cu``; its header note gives the steps
(ADC, kill mask, stable merge into the L-frontier, W-beam selection,
per-mode masks), what bounds the kernel on the card and how the design
answers that.

The round is *rotated* relative to the unfused loop: one call merges the
previous round's candidates and selects the next beam, which is
``expand`` ∘ ``stage_a`` of ``core/search.py``.  ``mode_masks`` is the
single source of the per-mode dispatch masks for the unfused loop and
the plain twin; the kernel's switch mirrors it.

``fused_traversal_round_ref`` (the plain twin) composes the frontier
building blocks — stable-sort merge, stable-sort beam selection — and
equals the kernel bit for bit on all 11 fields.  CPU tensors take the
twin; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import frontier as fr
from repro_torch.kernels import _build
from repro_torch.kernels import pq_lookup as pqk

NAME = "fused_traversal"
MODES = ("gate", "post", "early", "pre_naive", "unfiltered")  # kernel's mode codes, in order

# the reference's ceilings (repro/kernels/fused_traversal.py), kept so the
# fused and unfused loops are chosen for the same shapes as in the
# reference: the padded sort width and its ADC workspace tile.  On the card
# they also keep a block's shared memory well inside 227 KB.
_ADC_TILE = 128
_MAX_SORT = 4096
_MAX_ADC_BYTES = 8 * 1024 * 1024


def mode_masks(mode: str, sel_ids, valid, passes, entry_ids):
    """Per-mode dispatch masks for a selected beam.

    All arguments broadcast against ``sel_ids`` (bool ``valid``/``passes``;
    ``entry_ids`` is the per-query entry id).  Returns
    ``(fetch_mask, tunnel_mask, result_mask, exact_mask)``.
    """
    no = torch.zeros_like(valid)
    if mode == "unfiltered":
        return valid, no, valid, valid
    if mode == "post":
        return valid, no, passes, valid
    if mode == "early":
        return valid, no, passes, passes
    if mode == "pre_naive":
        fetch = passes | ((sel_ids == entry_ids) & valid)
        return fetch, no, passes, fetch
    # gate
    return passes, valid & (~passes), passes, passes


class FusedRound(NamedTuple):
    """One round's outputs: the merged+marked frontier (B, L) and the next
    beam with its per-mode masks (B, W)."""

    frontier_ids: torch.Tensor
    frontier_dists: torch.Tensor
    frontier_expanded: torch.Tensor  # bool
    frontier_passes: torch.Tensor  # bool — filter verdict payload per slot
    sel_ids: torch.Tensor
    valid: torch.Tensor  # bool
    fetch_ids: torch.Tensor  # sel_ids where fetch_mask, else -1
    fetch_mask: torch.Tensor  # bool
    tunnel_mask: torch.Tensor  # bool
    result_mask: torch.Tensor  # bool
    exact_mask: torch.Tensor  # bool


def fused_supported(*, l: int, width: int, m: int, c: int, k: int,
                    device: torch.device | str = "cuda") -> bool:
    """Can the fused round serve these shapes on this device?  The
    reference's predicate, with the device type in place of the backend."""
    if torch.device(device).type not in ("cpu", "cuda"):
        return False
    if width < 1 or l < 1 or m < 0:
        return False
    pad = 1 << (l + m - 1).bit_length()
    if pad > _MAX_SORT:
        return False
    if c * _ADC_TILE * k * 4 > _MAX_ADC_BYTES:
        return False
    return True


def _pad_lanes(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    if x.shape[1] >= width:
        return x
    return torch.cat([x, torch.full((x.shape[0], width - x.shape[1]), fill, dtype=x.dtype,
                                    device=x.device)], dim=1)


def fused_traversal_round_ref(frontier_ids, frontier_dists, frontier_expanded, frontier_passes,
                              new_ids, new_codes, new_passes, lut, entry, *, mode: str,
                              width: int, gathered: bool = True) -> FusedRound:
    """Plain twin of the kernel: ``frontier.insert`` then
    ``best_unexpanded`` + ``mark_expanded`` then ``mode_masks``, with the
    filter verdicts riding the merge as payload."""
    b, l = frontier_ids.shape
    if new_ids.shape[1]:
        if gathered:
            nd = torch.where(new_ids >= 0, pqk.pq_lookup_gathered_ref(lut, new_codes), fr.INF)
        else:
            nd = pqk.adc_ids_ref(lut, new_codes, new_ids)
        ids = torch.cat([frontier_ids, new_ids], dim=-1)
        dists = torch.cat([frontier_dists, nd], dim=-1)
        exp = torch.cat([frontier_expanded, torch.zeros_like(new_passes)], dim=-1)
        pas = torch.cat([frontier_passes, new_passes], dim=-1)
    else:
        ids, dists, exp, pas = frontier_ids, frontier_dists, frontier_expanded, frontier_passes

    ids, dists = fr._kill(ids, dists)
    order = fr._argsort(dists)[:, :l]
    mf_ids, mf_d = ids.gather(1, order), dists.gather(1, order)
    mf_exp, mf_pas = exp.gather(1, order), pas.gather(1, order)

    selkey = torch.where((~mf_exp) & (mf_ids >= 0), mf_d, fr.INF)
    slots = fr._argsort(selkey)[:, :width]
    valid = selkey.gather(1, slots) < fr.INF
    sel_ids = torch.where(valid, mf_ids.gather(1, slots), fr.INVALID)
    passes = mf_pas.gather(1, slots) & valid
    mf_exp = mf_exp | torch.zeros_like(mf_exp).scatter(1, slots, valid)
    # a beam wider than the frontier: the extra lanes are empty
    sel_ids = _pad_lanes(sel_ids, width, fr.INVALID)
    valid, passes = _pad_lanes(valid, width, False), _pad_lanes(passes, width, False)

    fetch, tun, res, exact = mode_masks(mode, sel_ids, valid, passes, entry[:, None])
    return FusedRound(
        frontier_ids=mf_ids, frontier_dists=mf_d, frontier_expanded=mf_exp,
        frontier_passes=mf_pas, sel_ids=sel_ids, valid=valid,
        fetch_ids=torch.where(fetch, sel_ids, fr.INVALID), fetch_mask=fetch,
        tunnel_mask=tun, result_mask=res, exact_mask=exact,
    )


def _meta_round(args, b: int, l: int, m: int, c: int, width: int, gathered: bool) -> FusedRound:
    """The round's outputs on the meta device, its bytes charged: the
    inputs read once (of an ungathered code table, the M rows a query
    reads), the outputs written once."""
    def empty(n, dt):
        return torch.empty((b, n), dtype=dt, device="meta")
    outs = FusedRound(*(empty(l, dt) for dt in (torch.int32, torch.float32, torch.bool, torch.bool)),
                      *(empty(width, dt) for dt in (torch.int32, torch.bool, torch.int32,
                                                    torch.bool, torch.bool, torch.bool, torch.bool)))
    reads = list(args)
    if not gathered:
        reads[5] = args[5].new_empty((b, m, c))
    _build.charge(NAME, *reads, *outs)
    return outs


_DTYPES = (torch.int32, torch.float32, torch.bool, torch.bool, torch.int32, torch.int32,
           torch.bool, torch.float32, torch.int32)
_ARGS = ("frontier_ids", "frontier_dists", "frontier_expanded", "frontier_passes", "new_ids",
         "new_codes", "new_passes", "lut", "entry")


def fused_traversal_round(frontier_ids, frontier_dists, frontier_expanded, frontier_passes,
                          new_ids, new_codes, new_passes, lut, entry, *, mode: str,
                          width: int, gathered: bool = True) -> FusedRound:
    """Batched fused round.

    frontier_* (B, L); new_ids / new_passes (B, M); lut (B, C, K); entry
    (B,).  ``gathered=True`` takes the TPU contract's gathered code rows
    ``new_codes`` (B, M, C); ``gathered=False`` takes the (N, C) code
    table and gathers ``new_codes[new_ids]`` inside the kernel.
    """
    args = (frontier_ids, frontier_dists, frontier_expanded, frontier_passes, new_ids,
            new_codes, new_passes, lut, entry)
    for name, t, dt in zip(_ARGS, args, _DTYPES):
        if t.dtype != dt:
            raise TypeError(f"{name}: want {dt}, got {t.dtype}")
        if t.device != lut.device:
            raise ValueError(f"{name} lies on {t.device}, lut on {lut.device}")
    b, l = frontier_ids.shape
    m = new_ids.shape[1]
    c, k = lut.shape[1], lut.shape[2]
    want_codes = (b, m, c) if gathered else (new_codes.shape[0], c)
    if any(t.shape != (b, l) for t in args[:4]) or new_passes.shape != (b, m) \
            or tuple(new_codes.shape) != want_codes or lut.shape[0] != b \
            or entry.shape != (b,) or new_ids.dim() != 2 or new_ids.shape[0] != b:
        raise ValueError("fused_traversal_round: inconsistent shapes "
                         + ", ".join(f"{n}={tuple(t.shape)}" for n, t in zip(_ARGS, args)))
    if mode not in MODES or width < 1:
        raise ValueError(f"mode {mode!r} / width {width} not supported")
    if lut.device.type == "cpu":
        return fused_traversal_round_ref(*args, mode=mode, width=width, gathered=gathered)
    if _build.is_meta(lut):
        return _meta_round(args, b, l, m, c, width, gathered)
    if not fused_supported(l=l, width=width, m=m, c=c, k=k, device=lut.device):
        raise ValueError(f"fused round does not support L={l} M={m} C={c} K={k} W={width}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("fused_traversal_round wants contiguous tensors")
    dev = lut.device
    outs = FusedRound(
        frontier_ids=torch.empty((b, l), dtype=torch.int32, device=dev),
        frontier_dists=torch.empty((b, l), dtype=torch.float32, device=dev),
        frontier_expanded=torch.empty((b, l), dtype=torch.bool, device=dev),
        frontier_passes=torch.empty((b, l), dtype=torch.bool, device=dev),
        sel_ids=torch.empty((b, width), dtype=torch.int32, device=dev),
        valid=torch.empty((b, width), dtype=torch.bool, device=dev),
        fetch_ids=torch.empty((b, width), dtype=torch.int32, device=dev),
        fetch_mask=torch.empty((b, width), dtype=torch.bool, device=dev),
        tunnel_mask=torch.empty((b, width), dtype=torch.bool, device=dev),
        result_mask=torch.empty((b, width), dtype=torch.bool, device=dev),
        exact_mask=torch.empty((b, width), dtype=torch.bool, device=dev),
    )
    if b == 0:  # nothing to compute: no launch, and none counted
        return outs
    fn =_build.entry(NAME, "fused_round_launch", 20, 8)
    err = fn(*(_build.ptr(t) for t in args), *(_build.ptr(t) for t in outs),
             b, l, m, c, k, width, MODES.index(mode), 0 if gathered else 1,
             _build.stream_ptr(lut))
    _build.check(err, "fused_round_launch")
    _build.LAUNCHES[NAME] += 1
    return outs
