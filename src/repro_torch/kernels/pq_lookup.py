"""PQ asymmetric-distance computation (ADC): CUDA kernel + plain version.

Replaces the TPU kernel ``repro/kernels/pq_lookup.py::pq_lookup_gathered``.
Source ``repro_torch/csrc/pq_lookup.cu``; its header note says what bounds
it on the card and how the design answers that.

Two entry points share the kernel:

  * ``pq_lookup_gathered(lut, codes)`` — the TPU contract: per-query code
    rows (B, M, C) -> (B, M).
  * ``adc_ids(lut, codes, ids)`` — the search loop's entry: the gather
    ``codes[max(ids, 0)]`` happens inside the kernel and ids < 0 give
    +INF, so no (B, M, C) copy of the code rows is made.

Both sum c = 0..C-1 left to right; the plain versions below use the same
order, so kernel and plain version agree bit for bit.  A wrapper runs the
plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "pq_lookup"
INF = 3.4e38


def pq_lookup_gathered_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (B, C, K) f32, codes (B, M, C) i32 -> (B, M) f32, c summed in order."""
    acc = torch.zeros(codes.shape[:2], dtype=torch.float32, device=lut.device)
    for c in range(lut.shape[1]):
        acc = acc + torch.gather(lut[:, c, :], 1, codes[:, :, c].long())
    return acc


def adc_ids_ref(lut: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """lut (B, C, K), codes (N, C), ids (B, M) -> (B, M); ids < 0 -> +INF."""
    d = pq_lookup_gathered_ref(lut, codes[ids.clamp(min=0).long()])
    return torch.where(ids >= 0, d, INF)


def _check(lut, codes, ids=None):
    if lut.dtype != torch.float32 or codes.dtype != torch.int32:
        raise TypeError(f"want lut float32 and codes int32, got {lut.dtype}, {codes.dtype}")
    tensors = (lut, codes) if ids is None else (lut, codes, ids)
    if any(t.device != lut.device for t in tensors):
        raise ValueError("lut, codes and ids must lie on one device")
    if ids is not None and ids.dtype != torch.int32:
        raise TypeError(f"want ids int32, got {ids.dtype}")
    if lut.dim() != 3 or codes.shape[-1] != lut.shape[1]:
        raise ValueError(f"shapes lut {tuple(lut.shape)} codes {tuple(codes.shape)} disagree")


def _launch(lut, codes, ids, out, b, m, by_id):
    if not all(t.is_contiguous() for t in (lut, codes, ids, out) if t is not None):
        raise ValueError("pq_lookup wants contiguous tensors")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit of 65535 queries")
    if b == 0 or m == 0:  # nothing to compute: no launch, and none counted
        return out
    fn = _build.entry(NAME, "pq_lookup_launch", 4, 5)
    err = fn(_build.ptr(lut), _build.ptr(codes), None if ids is None else _build.ptr(ids),
             _build.ptr(out), b, m, lut.shape[1], lut.shape[2], by_id, _build.stream_ptr(lut))
    _build.check(err, "pq_lookup_launch")
    _build.LAUNCHES[NAME] += 1
    return out


def pq_lookup_gathered(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Per-query gathered ADC: out[b, m] = sum_c lut[b, c, codes[b, m, c]]."""
    _check(lut, codes)
    if codes.dim() != 3 or codes.shape[0] != lut.shape[0]:
        raise ValueError(f"codes {tuple(codes.shape)} is not (B, M, C) for lut {tuple(lut.shape)}")
    if lut.device.type == "cpu":
        return pq_lookup_gathered_ref(lut, codes)
    b, m = codes.shape[:2]
    out = torch.empty((b, m), dtype=torch.float32, device=lut.device)
    return _launch(lut, codes, None, out, b, m, 0)


def adc_ids(lut: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """PQ distances of node ids: lut (B, C, K), codes (N, C), ids (B, M)."""
    _check(lut, codes, ids)
    if codes.dim() != 2 or ids.dim() != 2 or ids.shape[0] != lut.shape[0]:
        raise ValueError(f"codes {tuple(codes.shape)} / ids {tuple(ids.shape)} are not (N, C) / (B, M)")
    if lut.device.type == "cpu":
        return adc_ids_ref(lut, codes, ids)
    b, m = ids.shape
    out = torch.empty((b, m), dtype=torch.float32, device=lut.device)
    return _launch(lut, codes, ids, out, b, m, 1)
