from icde2019_gpu_join_tpu_torch.parallel.mesh import make_mesh
from icde2019_gpu_join_tpu_torch.parallel.dist_join import (
    distributed_join_aggregate,
    distributed_join_aggregate_2level,
    distributed_join_materialize,
    distributed_join_segmented,
)

__all__ = [
    "make_mesh",
    "distributed_join_aggregate",
    "distributed_join_aggregate_2level",
    "distributed_join_materialize",
    "distributed_join_segmented",
]
