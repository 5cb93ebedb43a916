"""Sharding plans, gradient compression and fault tolerance
(``repro.distributed``)."""
from repro_torch.distributed.sharding import (
    Layout,
    lshard,
    make_layout,
    param_pspec,
    store_pspec,
    tree_pspecs,
)

__all__ = [
    "Layout",
    "make_layout",
    "lshard",
    "param_pspec",
    "store_pspec",
    "tree_pspecs",
]
