"""Re-export index for kubeflow_tpu_torch.parallel (the JAX package's,
less the shard_map wrappers, which have nothing to port)."""

from kubeflow_tpu_torch.parallel.mesh import (
    MESH_AXIS_ORDER,
    MeshSpec,
    build_mesh,
    mesh_from_config,
)
from kubeflow_tpu_torch.parallel.sharding import (
    LOGICAL_RULES,
    logical_to_spec,
    shard_constraint,
)
from kubeflow_tpu_torch.parallel.distributed import (
    GangEnv,
    initialize_from_env,
    render_gang_env,
)

__all__ = [
    "MESH_AXIS_ORDER",
    "MeshSpec",
    "build_mesh",
    "mesh_from_config",
    "LOGICAL_RULES",
    "logical_to_spec",
    "shard_constraint",
    "GangEnv",
    "initialize_from_env",
    "render_gang_env",
]
