"""The host tier's record fetch: CUDA kernel + plain version.

Replaces no TPU kernel.  Source ``repro_torch/csrc/host_gather.cu``; its
header note says what bounds the kernel on the card (the PCIe link) and how
the design answers that.

``host_gather(vectors, neighbors, ids, rows_read)`` takes (B, W) int32 ids
and the records (vectors (N, D) float32, neighbors (N, R) int32) and gives
(B, W, D) vectors and (B, W, R) neighbour rows on the ids' device; a slot
with id < 0 gets a zero vector and a row of -1.  ``rows_read`` (an int64
scalar on the ids' device, or None) is added the number of rows read.

For CPU ids the plain version runs: the memory tier's gather
(``store.vector_store._gather_rows``) on CPU records.  For CUDA ids the
kernel reads only the live rows, from records in pinned host memory through
their device-mapped address, and writes the whole output on the card: no
host sync and no host gather, in 16-byte words.  Records that are not
pinned and mapped, not 16-byte aligned, or whose widths are not multiples
of 4 are refused with the reason, never copied another way.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "host_gather"


def host_gather_ref(vectors: torch.Tensor, neighbors: torch.Tensor, ids: torch.Tensor,
                    rows_read: torch.Tensor | None = None):
    """The plain version, on the CPU: the memory tier's gather, and the
    live ids counted."""
    from repro_torch.store.vector_store import _gather_rows

    if rows_read is not None:
        rows_read += (ids >= 0).sum()
    return _gather_rows(vectors, neighbors, ids)


def _base(t: torch.Tensor) -> int:
    """The start of the tensor's storage: the pinned allocation it lies in."""
    return t.untyped_storage().data_ptr()


def host_gather(vectors: torch.Tensor, neighbors: torch.Tensor, ids: torch.Tensor,
                rows_read: torch.Tensor | None = None):
    """(B, W) ids -> (vecs (B, W, D), nbrs (B, W, R)) on the ids' device."""
    if rows_read is not None and rows_read.device != ids.device:
        raise ValueError(f"ids on {ids.device} but rows_read on {rows_read.device}")
    if ids.device.type == "cpu":
        return host_gather_ref(vectors, neighbors, ids, rows_read)
    if vectors.dtype != torch.float32 or neighbors.dtype != torch.int32 \
            or ids.dtype != torch.int32 \
            or (rows_read is not None and rows_read.dtype != torch.int64):
        raise TypeError(f"want vectors float32, neighbors and ids int32, rows_read int64, got "
                        f"{vectors.dtype}, {neighbors.dtype}, {ids.dtype}, "
                        f"{None if rows_read is None else rows_read.dtype}")
    if vectors.dim() != 2 or neighbors.dim() != 2 or vectors.shape[0] != neighbors.shape[0]:
        raise ValueError(f"vectors {tuple(vectors.shape)} / neighbors {tuple(neighbors.shape)} "
                         "are not (N, D) / (N, R)")
    if vectors.device.type != "cpu" or neighbors.device.type != "cpu":
        raise ValueError("host_gather reads records in host memory; they lie on "
                         f"{vectors.device} / {neighbors.device}")
    if not (vectors.is_contiguous() and neighbors.is_contiguous()):
        raise ValueError("host_gather wants contiguous records")
    (n, d), r = vectors.shape, int(neighbors.shape[1])
    if d % 4 or r % 4 or vectors.data_ptr() % 16 or neighbors.data_ptr() % 16:
        raise ValueError(f"host_gather reads 16-byte words: it wants D ({d}) and R ({r}) "
                         "multiples of 4 and records that start 16-byte aligned")
    ids = ids.contiguous()
    vecs = torch.empty((*ids.shape, d), dtype=torch.float32, device=ids.device)
    nbrs = torch.empty((*ids.shape, r), dtype=torch.int32, device=ids.device)
    fn = _build.entry(NAME, "host_gather_launch", 8, 4)
    err = fn(_build.ptr(ids), _base(vectors), vectors.data_ptr(), _base(neighbors),
             neighbors.data_ptr(), _build.ptr(vecs), _build.ptr(nbrs),
             None if rows_read is None else rows_read.data_ptr(),
             ids.numel(), n, d, r, _build.stream_ptr(ids))
    if err < 0:
        which = "vectors" if err == -1 else "neighbors"
        raise ValueError(f"host_gather: the records' {which} are not in pinned, mapped host "
                         "memory (cudaHostGetDevicePointer refused them): pin them with "
                         "tensor.pin_memory()")
    _build.check(err, "host_gather_launch")
    if ids.numel():
        _build.LAUNCHES[NAME] += 1
    return vecs, nbrs
