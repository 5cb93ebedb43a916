"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``pq_lookup`` (ADC, gathered and by id, and the brute-force
``pq_scan``), ``l2_dist`` (exact re-ranking distances),
``fused_traversal`` (one fused stage-A round) and ``topk_merge``
(sorted top-k on (dist, id)).  ``ops`` re-exports them under the
reference's names.  ``_build`` compiles ``repro_torch/csrc/*.cu`` on
first use and counts launches."""
from repro_torch.kernels._build import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
