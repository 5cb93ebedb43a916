"""The port's kernel entry points under the reference's names.

Counterpart of ``repro.kernels.ops``: the five public names, re-exported
from the port's kernel modules, so a caller of the JAX entry point finds
the port's.  Each launches its CUDA kernel for CUDA tensors and runs its
plain PyTorch version for CPU tensors; there is no interpret mode.
"""
from __future__ import annotations

from repro_torch.kernels import l2_dist as _l2
from repro_torch.kernels.fused_traversal import fused_traversal_round
from repro_torch.kernels.pq_lookup import pq_lookup_gathered, pq_scan
from repro_torch.kernels.topk_merge import topk_merge

# alias the reference's core.search uses
pq_lookup = pq_lookup_gathered


def l2_dist(queries, rows):
    """The TPU kernel's contract: squared L2 in the expanded form."""
    return _l2.l2_dist(queries, rows, tree=False)


__all__ = ["fused_traversal_round", "l2_dist", "pq_lookup", "pq_lookup_gathered", "pq_scan",
           "topk_merge"]
