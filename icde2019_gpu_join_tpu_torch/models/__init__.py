from icde2019_gpu_join_tpu_torch.models.joins import ClusteredJoin, JoinResult

__all__ = ["ClusteredJoin", "JoinResult"]
