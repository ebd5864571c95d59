"""The measurement tools: the sort-question tooling (whether a
hand-written sort beats the library sort on the card), the overlap tool of
the out-of-memory regimes and the distributed layer's timing tool.
Counterpart of the repository's `benchmarks/` for the PyTorch + CUDA
package; each module runs on the card unless `--device cpu` (or
`device="cpu"`) is given.

  experimental_sort   the full bitonic sort of tiles (`sort_tiles`);
  merge_sort_bench    `stage_reps` and the benches `stages`, `packed`, `full`;
  merge_fix_validate  `merge_sort_pairs` against `torch.sort`, then their times;
  construct_probes    the ladder of minimal kernels, one construct each;
  overlap_bench       transfer, compute and pipeline times of the streamed
                      and the co-processed join (`streaming_leg`,
                      `coprocess_leg`);
  dist_bench          where the distributed join's time goes: rank scaling
                      of a thread world, the materialize leg's two paths,
                      the spans of a process world.
"""
