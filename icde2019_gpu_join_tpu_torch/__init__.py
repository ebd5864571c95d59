"""tpu-join on PyTorch and CUDA: the port of `icde2019_gpu_join_tpu` to one
NVIDIA H100.

Same module names as the JAX package; plain functions on int32 tensors, an
explicit device on `Relation` and `ClusteredJoin`, seeds passed to the
generators. Imports torch and numpy, never JAX. Three regimes, picked by the
size dispatcher `models.clustered_probe_join` (`dispatch_regime`): the
in-memory `ClusteredJoin`; the streamed probe (`models/streaming.py`: R
resident, S streamed from pinned host memory in segments on a copy stream);
and host co-processing (`models/coprocess.py`: both sides partitioned on the
host, joined pair by pair on the card). The distributed layer (`parallel/`)
runs each rank's exchange and join against a communicator: ranks as threads
on one device, or one process of a `torch.distributed` world. The ten
kernels (the banded
probe's four compare/select kernels, the stream-range probe, the merge
sort's in-block and merge-path levels with their planner, and the sort
tools' tile sort, stage meter and construct probes) are CUDA C++ (`csrc/`),
built with nvcc at first use.
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
