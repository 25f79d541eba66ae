"""Multi-device execution (counterpart of klara_tpu/parallel): chain meshes,
the 2-D chains × param mesh and the param-sharded logreg target."""

from klara_tpu_torch.parallel.mesh import (
    chain_mesh,
    initialize_distributed,
    shard_chains,
)
from klara_tpu_torch.parallel.param_shard import mesh2d, param_sharded_logreg_target

__all__ = [
    "chain_mesh",
    "initialize_distributed",
    "shard_chains",
    "mesh2d",
    "param_sharded_logreg_target",
]
