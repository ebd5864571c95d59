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

// One stage at distance d = 1 << j of a full bitonic sort, over the block's m
// elements: the direction of a group comes from bit k of an element's flat
// index (ascending iff the bit is 0), flat = base + the element's place in
// the block; k > j, so both elements of an exchange read the same bit.
//
// The exchange is element-wise, as the TPU tile sort has it
// (benchmarks/experimental_sort_pallas.py:70-75): each element on its own
// takes its partner's key and payload iff (partner < own) == keep_small,
// where the lower element keeps the small key in an ascending group. On
// distinct keys that is a swap. On equal keys the element that keeps the
// large key takes its partner's payload while the partner keeps its own, so
// one payload is written twice and the other is lost: the reference's
// behaviour, kept so that kernel and reference agree on every input.
__device__ __forceinline__ void tj_exchange_elementwise(int32_t* key,
                                                        int32_t* pay, int lo,
                                                        int hi,
                                                        bool lo_keeps_small) {
  const int32_t a = key[lo];
  const int32_t b = key[hi];
  const int32_t pa = pay[lo];
  const int32_t pb = pay[hi];
  if ((b < a) == lo_keeps_small) {
    key[lo] = b;
    pay[lo] = pb;
  }
  if ((a < b) != lo_keeps_small) {
    key[hi] = a;
    pay[hi] = pa;
  }
}

__device__ __forceinline__ void tj_stage_index_bit(int32_t* key, int32_t* pay,
                                                   int m, int j, int k,
                                                   int64_t base) {
  const int d = 1 << j;
  for (int i = threadIdx.x; i < m / 2; i += blockDim.x) {
    const int lo = tj_stage_lo(i, d);
    const bool ascending = (((base + lo) >> k) & 1) == 0;
    tj_exchange_elementwise(key, pay, lo, lo + d, ascending);
  }
}

// One stage at distance d over the block's m elements, read as rows of 128:
// with row_mask the direction flips (descending) where the lower element's
// row is odd, the per-row direction mask `dm` of the TPU kernels' `_cx`
// (merge_pallas.py:106-107, 118-119); without it every group ascends. `at`
// maps an element's flat place to its place in shared memory, so that the
// same stage runs out of a padded or a transposed layout.
template <typename At>
__device__ __forceinline__ void tj_stage_row_mask(int32_t* key, int32_t* pay,
                                                  int m, int d, bool row_mask,
                                                  At at) {
  for (int i = threadIdx.x; i < m / 2; i += blockDim.x) {
    const int lo = tj_stage_lo(i, d);
    const bool descending = row_mask && ((lo >> 7) & 1);
    tj_compare_exchange(key, pay, at(lo), at(lo + d), descending);
  }
}

// The identity layout: element i at place i.
struct TjFlat {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};
