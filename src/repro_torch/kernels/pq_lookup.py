"""PQ asymmetric-distance computation (ADC): CUDA kernels + plain versions.

Replaces the TPU kernels ``repro/kernels/pq_lookup.py::pq_lookup_gathered``
and ``::pq_scan``.  Source ``repro_torch/csrc/pq_lookup.cu``; its header
note says what bounds the kernels on the card and how the design answers
that.

Three entry points:

  * ``pq_lookup_gathered(lut, codes)`` — the TPU contract: per-query code
    rows (B, M, C) -> (B, M).
  * ``adc_ids(lut, codes, ids)`` — the search loop's entry: the gather
    ``codes[max(ids, 0)]`` happens inside the kernel and ids < 0 give
    +INF, so no (B, M, C) copy of the code rows is made.
  * ``pq_scan(lut, codes)`` — the brute-force sweep over one (N, C) code
    table shared by every query -> (B, N) (``core.pq.adc_lookup``).

All sum c = 0..C-1 left to right; the plain versions below use the same
order, so kernel and plain version agree bit for bit.  A wrapper runs the
plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.  Codes must lie in [0, K): the kernels do not check.

Each kernel has two routes, chosen by shape in the library (``adc_route``
and ``scan_route`` ask it; neither is a fallback on failure): the ADC
stages a query's LUT in shared memory unless the query has fewer rows
than the LUT has entries a chunk (M < K), when it reads the LUT from
global memory; the scan packs each row's codes into bytes in registers
when K <= 256 and C <= 32, and reads them unpacked otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "pq_lookup"
SCAN_NAME = "pq_scan"
INF = 3.4e38
ADC_ROUTES = ("direct", "staged")
SCAN_ROUTES = ("packed", "wide")
_INT_MAX = 2**31 - 1  # sizes travel as C ints; a grid's x holds at most this many blocks
# either ADC route launches at most B * ceil(M / 32) blocks (pq_lookup.cu:
# kDirectThreads rows a block, or tiles of at least kAdcThreads rows)
_ADC_ROWS_PER_BLOCK = 32


def adc_route(m: int, k: int) -> str:
    """The route the ADC launcher takes for M rows a query and K codes a
    chunk (the library's ``pq_lookup_route``; builds it)."""
    return ADC_ROUTES[_build.entry(NAME, "pq_lookup_route", 0, 2, stream=False)(m, k)]


def scan_route(c: int, k: int) -> str:
    """The route the scan's launcher takes for C chunks of K codes (the
    library's ``pq_scan_route``; builds it)."""
    return SCAN_ROUTES[_build.entry(NAME, "pq_scan_route", 0, 2, stream=False)(c, k)]


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


def pq_scan_ref(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (B, C, K) f32, codes (N, C) i32 -> (B, N) f32, c summed in order."""
    acc = torch.zeros((lut.shape[0], codes.shape[0]), dtype=torch.float32, device=lut.device)
    for c in range(lut.shape[1]):
        acc = acc + lut[:, c, :][:, codes[:, c].long()]
    return acc


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
    if max(b, m) > _INT_MAX or b * -(-m // _ADC_ROWS_PER_BLOCK) > _INT_MAX:
        raise ValueError(f"B = {b} queries of M = {m} rows exceed the kernel's grid limit")
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


def pq_scan(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Brute-force ADC sweep: out[b, n] = sum_c lut[b, c, codes[n, c]]."""
    _check(lut, codes)
    if codes.dim() != 2:
        raise ValueError(f"codes {tuple(codes.shape)} is not (N, C)")
    if lut.device.type == "cpu":
        return pq_scan_ref(lut, codes)
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError("pq_scan wants contiguous tensors")
    b, n = lut.shape[0], codes.shape[0]
    if max(b, n) > _INT_MAX:
        raise ValueError(f"B = {b} or N = {n} does not fit the kernel's int sizes")
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    if b == 0 or n == 0:  # nothing to compute: no launch, and none counted
        return out
    fn = _build.entry(NAME, "pq_scan_launch", 3, 4)
    err = fn(_build.ptr(lut), _build.ptr(codes), _build.ptr(out), b, n, lut.shape[1],
             lut.shape[2], _build.stream_ptr(lut))
    _build.check(err, "pq_scan_launch")
    _build.LAUNCHES[SCAN_NAME] += 1
    return out
