// bitonic.cuh: the compare-exchange network on (key, payload) pairs held in
// shared memory, shared by the kernels that merge or sort inside a block.
//
// A stage at distance d (a power of two) over m elements is m / 2
// independent exchanges: exchange i compares element lo = tj_stage_lo(i, d)
// with element lo + d. The exchange is
//
//     swap = (key[hi] < key[lo]) ^ descending
//
// with a strict <, as the TPU kernels' `_cx` has it
// (icde2019_gpu_join_tpu/ops/merge_pallas.py:91): equal keys stay put in an
// ascending group and trade places in a descending one. That fixes where the
// payloads of equal keys land, so a level equals the reference's element for
// element.

#pragma once

#include <cstdint>

// The lower element of exchange i in a stage at distance d: the exchanges of
// one 2d-aligned group are its first d elements.
__device__ __forceinline__ int tj_stage_lo(int i, int d) {
  return ((i & ~(d - 1)) << 1) | (i & (d - 1));
}

__device__ __forceinline__ void tj_compare_exchange(int32_t* key, int32_t* pay,
                                                    int lo, int hi,
                                                    bool descending) {
  const int32_t a = key[lo];
  const int32_t b = key[hi];
  if ((b < a) != descending) {
    key[lo] = b;
    key[hi] = a;
    const int32_t p = pay[lo];
    pay[lo] = pay[hi];
    pay[hi] = p;
  }
}

// One stage at distance d over the block's m elements, all ascending, by all
// the block's threads; the caller synchronises between stages.
__device__ __forceinline__ void tj_stage_ascending(int32_t* key, int32_t* pay,
                                                   int m, int d) {
  for (int i = threadIdx.x; i < m / 2; i += blockDim.x) {
    const int lo = tj_stage_lo(i, d);
    tj_compare_exchange(key, pay, lo, lo + d, false);
  }
}
