from automodel_tpu_torch.parallel.mesh import (
    LOGICAL_AXIS_RULES,
    MeshAxisName,
    MeshConfig,
    MeshContext,
    build_mesh,
    initialize_distributed,
)

__all__ = [
    "LOGICAL_AXIS_RULES",
    "MeshAxisName",
    "MeshConfig",
    "MeshContext",
    "build_mesh",
    "initialize_distributed",
]
