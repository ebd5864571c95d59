from icde2019_gpu_join_tpu_torch.models.joins import (
    ClusteredJoin,
    JoinResult,
    clustered_probe_join,
    dispatch_regime,
)

__all__ = ["ClusteredJoin", "JoinResult", "clustered_probe_join",
           "dispatch_regime"]
