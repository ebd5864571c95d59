"""tpu-join on PyTorch and CUDA: the port of `icde2019_gpu_join_tpu` to one
NVIDIA H100.

Same module names as the JAX package; plain functions on int32 tensors, an
explicit device on `Relation` and `ClusteredJoin`, seeds passed to the
generators. Imports torch and numpy, never JAX. The kernels (the banded
probe's compare/select kernels and the stream-range probe) are CUDA C++
(`csrc/`), built with nvcc at first use.
"""

from icde2019_gpu_join_tpu_torch.config import RadixConfig, EngineConfig
from icde2019_gpu_join_tpu_torch.relation import Relation, PartitionedRelation

__version__ = "0.1.0"

__all__ = [
    "RadixConfig",
    "EngineConfig",
    "Relation",
    "PartitionedRelation",
]
