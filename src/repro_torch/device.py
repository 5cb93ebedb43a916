"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device=None`` resolves to ``cuda`` and raises when no CUDA device is
present — there is no silent carry-on on the CPU.  Tests pass
``device="cpu"`` and get the plain PyTorch versions of every kernel.
"""
from __future__ import annotations

import torch

SUPPORTED = ("cpu", "cuda")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; validate the type; raise when CUDA is asked
    for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in SUPPORTED:
        raise ValueError(f"device {dev} is not supported (use one of {SUPPORTED})")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    return dev
