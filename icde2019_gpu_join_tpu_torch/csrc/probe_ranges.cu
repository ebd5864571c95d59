// probe_ranges.cu: the stream-range probe kernel, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes.
//
// Replaces the TPU kernel of icde2019_gpu_join_tpu/ops/probe_pallas.py,
// probe_aggregate_ranges (:139, kernel _probe_agg_kernel :76):
//
//   *out += SUM over work items w of
//           SUM_{r < TR, s < TS} [rk[R0+r] == sk[S0+s]] * rp[R0+r] * sp[S0+s]
//   where R0 = item_tile[w] * TR and S0 = item_s0[w]      (mod 2^32)
//
// R and S are radix-partitioned (CSR) int32 columns, padded with payload-0
// rows to multiples of TR and TS; the host (ops/probe_ranges.py) flattens
// each R tile's S range into one work item per TS-row chunk and clamps the
// chunks to S, as the TPU kernel clamps its chunk count. No masks: keys of
// different partitions never match and pad rows add 0.
//
// What bounds it on the card: TR*TS compares per item against (TR+TS)*8
// bytes read, 64 compares per byte at TR = TS = 1024. Each compare is a
// compare and a predicated add, so the kernel is bound by integer issue, like
// band_compare.cu's kernels.
//
// Design, deliberately simple: one 128-thread block per work item (the TPU
// grid ran the R tiles in order with all chunks of a tile in one grid step;
// here a skewed tile's hundreds of chunks spread over as many blocks). Each
// thread holds kRows S rows (key, payload) in registers per pass over 1024 S
// rows; the block stages the R tile through shared memory as interleaved
// (key, payload) pairs, kRTile at a time, so one 8-byte broadcast load feeds
// kRows compares. Per S row t = SUM of matched rp, then v += t * sp in
// uint32 (signed overflow is undefined in C++, unsigned wraps mod 2^32); the
// block reduces v with warp shuffles and adds it with one atomicAdd
// (addition mod 2^32 commutes, so SUM_s sp * SUM_r [eq] rp equals the TPU's
// SUM_r rp * SUM_s [eq] sp bit for bit, whatever order the atomics land in).
// The TPU kernel's double-buffered DMA of S chunks has no counterpart yet:
// each block reads its chunk once, coalesced; cp.async/TMA staging is later
// work. wgmma does not apply to integer equality.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;                     // S rows per thread per pass
constexpr int kSPass = kThreads * kRows;     // S rows per pass: 1024
constexpr int kRTile = 1024;                 // R rows staged at a time: 8 KB

__global__ void __launch_bounds__(kThreads)
probe_ranges_kernel(const int32_t* __restrict__ rk,
                    const int32_t* __restrict__ rp,
                    const int32_t* __restrict__ sk,
                    const int32_t* __restrict__ sp,
                    const int64_t* __restrict__ item_tile,
                    const int64_t* __restrict__ item_s0, int64_t tile_r,
                    int64_t tile_s, uint32_t* __restrict__ out) {
  __shared__ int2 r_kp[kRTile];
  __shared__ uint32_t warp_sum[kThreads / 32];
  const int64_t r0 = item_tile[blockIdx.x] * tile_r;
  const int64_t s0 = item_s0[blockIdx.x];

  uint32_t v = 0;
  for (int64_t sb = 0; sb < tile_s; sb += kSPass) {
    int32_t key[kRows];
    uint32_t pay[kRows];
    uint32_t t[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int64_t j = sb + q * kThreads + threadIdx.x;
      const bool in = j < tile_s;  // a short last pass: payload 0 adds 0
      key[q] = in ? sk[s0 + j] : 0;
      pay[q] = in ? static_cast<uint32_t>(sp[s0 + j]) : 0u;
      t[q] = 0;
    }
    for (int64_t rb = 0; rb < tile_r; rb += kRTile) {  // tile_r % kRTile == 0
      __syncthreads();  // every thread is done with the previous R tile
      for (int j = threadIdx.x; j < kRTile; j += kThreads) {
        r_kp[j] = make_int2(rk[r0 + rb + j], rp[r0 + rb + j]);
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kRTile; ++j) {
        const int2 kp = r_kp[j];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          t[q] += (kp.x == key[q]) ? static_cast<uint32_t>(kp.y) : 0u;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) v += t[q] * pay[q];
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w];
    atomicAdd(out, s);
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a tile_r that is not a multiple of 1024 or more
// items than a grid holds). Adds the sum to out[0] (a uint32 the caller
// zeroed). item_tile and item_s0 are int64 [n_items].
extern "C" int tj_probe_aggregate_ranges(const void* rk, const void* rp,
                                         const void* sk, const void* sp,
                                         const void* item_tile,
                                         const void* item_s0, void* sum,
                                         int64_t n_items, int64_t tile_r,
                                         int64_t tile_s, void* stream) {
  if (n_items <= 0) return 0;
  if (tile_r <= 0 || tile_r % kRTile != 0 || tile_s <= 0 ||
      n_items > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  probe_ranges_kernel<<<static_cast<unsigned int>(n_items), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rk), static_cast<const int32_t*>(rp),
      static_cast<const int32_t*>(sk), static_cast<const int32_t*>(sp),
      static_cast<const int64_t*>(item_tile),
      static_cast<const int64_t*>(item_s0), tile_r, tile_s,
      static_cast<uint32_t*>(sum));
  return static_cast<int>(cudaGetLastError());
}
