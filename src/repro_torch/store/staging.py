"""Host-to-device staging through pinned buffers.

The host and disk record tiers build each round's records on the host
and copy them to the engine's device.  A copy from pageable memory is
synchronous whatever ``non_blocking`` says, so the records are written
into a *pinned* buffer and copied with ``non_blocking=True``.  A pinned
buffer is handed out again only after the copy that read it has landed:
each copy records a CUDA event, and ``take`` waits on it before reuse —
a buffer rewritten under an in-flight copy would corrupt a later round
silently (a wrong distance, not a crash).

On the CPU there is nothing to copy: ``take`` returns a plain tensor and
``upload`` hands it back as it is.
"""
from __future__ import annotations

import threading

import torch


class PinnedStaging:
    """Free lists of pinned host buffers, keyed by shape and dtype."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        # (shape, dtype) -> [(buffer, event of its last copy)]
        self._free: dict = {}  # guarded by _lock

    @property
    def pinned(self) -> bool:
        return self.device.type == "cuda"

    def take(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """A host buffer of ``shape`` this caller owns until ``upload``."""
        if not self.pinned:
            return torch.empty(shape, dtype=dtype)
        with self._lock:
            free = self._free.get((tuple(shape), dtype))
            item = free.pop() if free else None
        if item is None:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        buf, event = item
        event.synchronize()  # the copy that last read this buffer has landed
        return buf

    def upload(self, buf: torch.Tensor) -> torch.Tensor:
        """Copy a buffer from ``take`` to the device and give it back to
        the free list behind the copy's event."""
        if not self.pinned:
            return buf
        out = buf.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        with self._lock:
            self._free.setdefault((tuple(buf.shape), buf.dtype), []).append((buf, event))
        return out
