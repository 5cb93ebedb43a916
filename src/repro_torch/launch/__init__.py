"""Launch helpers: process-group meshes over ``torch.distributed``."""
from repro_torch.launch.mesh import (
    AbstractMesh,
    abstract_production_mesh,
    Mesh,
    make_local_mesh,
    make_mesh,
    make_production_mesh,
    spawn_local,
)

__all__ = ["AbstractMesh", "abstract_production_mesh", "Mesh", "make_local_mesh", "make_mesh",
           "make_production_mesh", "spawn_local"]
