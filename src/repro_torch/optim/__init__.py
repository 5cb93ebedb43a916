"""Optimizers and LR schedules (``repro.optim``) over dicts of tensors."""
from repro_torch.optim.adamw import (
    OptConfig,
    clip_by_global_norm,
    global_norm,
    opt_init,
    opt_update,
)
from repro_torch.optim.schedules import warmup_cosine

__all__ = [
    "OptConfig",
    "opt_init",
    "opt_update",
    "clip_by_global_norm",
    "global_norm",
    "warmup_cosine",
]
