"""Launch helpers: process-group meshes over ``torch.distributed``."""
from repro_torch.launch.mesh import (
    Mesh,
    make_local_mesh,
    make_mesh,
    make_production_mesh,
    spawn_local,
)

__all__ = ["Mesh", "make_local_mesh", "make_mesh", "make_production_mesh", "spawn_local"]
