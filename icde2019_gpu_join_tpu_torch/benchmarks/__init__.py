"""The sort-question tooling: the programs that measure whether a
hand-written sort beats the library sort on the card. Counterpart of the
repository's `benchmarks/` for the PyTorch + CUDA package; each module runs
on the card unless `--device cpu` (or `device="cpu"`) is given.

  experimental_sort   the full bitonic sort of tiles (`sort_tiles`);
  merge_sort_bench    `stage_reps` and the benches `stages`, `packed`, `full`;
  merge_fix_validate  `merge_sort_pairs` against `torch.sort`, then their times;
  construct_probes    the ladder of minimal kernels, one construct each.
"""
