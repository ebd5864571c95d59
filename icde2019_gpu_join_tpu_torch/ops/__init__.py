"""The engine's operators, re-exported under the JAX package's names
(`icde2019_gpu_join_tpu/ops/__init__.py`). Importing them builds nothing:
each kernel library is built at its first launch."""

from icde2019_gpu_join_tpu_torch.ops.bits import partition_ids
from icde2019_gpu_join_tpu_torch.ops.partition import radix_partition, histogram
from icde2019_gpu_join_tpu_torch.ops.join_sorted import (
    sort_merge_aggregate,
    sort_merge_count,
)
from icde2019_gpu_join_tpu_torch.ops.perfect_hash import (
    perfect_hash_build,
    perfect_hash_probe_aggregate,
)
from icde2019_gpu_join_tpu_torch.ops.filter import filter_compact
from icde2019_gpu_join_tpu_torch.ops.groupby import groupby_count_sum
from icde2019_gpu_join_tpu_torch.ops.sort import radix_sort
from icde2019_gpu_join_tpu_torch.ops.band_join import (
    banded_join_aggregate,
    banded_join_count,
    banded_join_late_aggregate,
    banded_materialize,
    banded_probe,
    sort_by_key,
)

__all__ = [
    "partition_ids",
    "radix_partition",
    "histogram",
    "sort_merge_aggregate",
    "sort_merge_count",
    "perfect_hash_build",
    "perfect_hash_probe_aggregate",
    "filter_compact",
    "groupby_count_sum",
    "radix_sort",
    "banded_join_aggregate",
    "banded_join_count",
    "banded_join_late_aggregate",
    "banded_materialize",
    "banded_probe",
    "sort_by_key",
]
