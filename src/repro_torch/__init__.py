"""GateANN on PyTorch and CUDA: the port of ``repro`` (JAX) to one NVIDIA H100.

Subpackages mirror the reference: ``core`` (engine, search loop,
frontier, PQ, neighbor and filter stores), ``kernels`` (hand-written CUDA
kernels for Hopper with their plain PyTorch versions), ``store`` (index
format, record and cache tiers), ``obs`` (metrics registry, span tracer,
exporters), ``serve`` (retrieval serving and the multi-tenant front end)
and ``data`` (synthetic corpora).  Entry points run
on the card unless the caller passes ``device="cpu"``.  The package never
imports JAX or the ``repro`` package.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
