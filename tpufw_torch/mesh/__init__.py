"""The named device mesh (port of ``tpufw.mesh``)."""

from tpufw_torch.mesh.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_PIPE,
    AXIS_SEQUENCE,
    AXIS_TENSOR,
    MESH_AXES,
    MeshConfig,
    build_mesh,
    logical_axis_rules,
    mesh_shape,
    rank_grid,
)
