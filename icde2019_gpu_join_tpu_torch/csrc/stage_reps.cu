// stage_reps.cu: one compare-exchange stage, repeated, as a rate measurement;
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
//   tj_stage_reps  replaces stage_reps
//       (benchmarks/merge_sort_bench.py:86, kernel _stage_kernel :77): `reps`
//       times the `_cx` stage at distance d (strict <, a pair swapped as one,
//       every group ascending) over each tile of `tile` pairs of (sv, pv).
//       A stage is idempotent, so the result is that of one stage; the point
//       is the time of `reps` of them.
//
// On the TPU a tile of 2^18 pairs stays in fast memory for all reps. Here
// which memory a stage runs in follows from the tile:
//
//   tile <= 2^14  one block per tile: load once, `reps` stages in shared
//                 memory with a __syncthreads() each, store once. Every rep
//                 reads and writes shared memory again; nothing is kept in
//                 registers across reps.
//   tile >  2^14  a tile does not fit a block, so every rep is one pass over
//                 device memory (an exchange per thread; the first pass reads
//                 the inputs, the others work in place on the outputs).
//
// Both are rates of this card: the first is what a stage costs inside the
// merge kernels, the second what the global stages of a large sort cost.
// What bounds them: 16 bytes per pair once (0.080 ms at n = 2^24 at
// 3.35 TB/s) in shared memory, and once per rep in device memory; five
// integer operations per exchange.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxBlockElems = 1 << 14;   // pairs a block holds: 128 KB
constexpr int kGlobalThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
stage_reps_shared_kernel(const int32_t* __restrict__ sv,
                         const int32_t* __restrict__ pv,
                         int32_t* __restrict__ osv, int32_t* __restrict__ opv,
                         int tile, int d, int reps) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* key = smem;
  int32_t* pay = smem + tile;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    key[i] = sv[base + i];
    pay[i] = pv[base + i];
  }
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
    tj_stage_ascending(key, pay, tile, d);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    osv[base + i] = key[i];
    opv[base + i] = pay[i];
  }
}

// One stage over the whole arrays in device memory. The outputs may be the
// inputs: thread i owns exchange i and touches no other element.
__global__ void __launch_bounds__(kGlobalThreads)
stage_global_kernel(const int32_t* sv, const int32_t* pv, int32_t* osv,
                    int32_t* opv, int64_t exchanges, int64_t d) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < exchanges; i += stride) {
    const int64_t lo = ((i & ~(d - 1)) << 1) | (i & (d - 1));
    const int64_t hi = lo + d;
    const int32_t a = sv[lo];
    const int32_t b = sv[hi];
    const int32_t pa = pv[lo];
    const int32_t pb = pv[hi];
    const bool swap = b < a;
    osv[lo] = swap ? b : a;
    osv[hi] = swap ? a : b;
    opv[lo] = swap ? pb : pa;
    opv[hi] = swap ? pa : pb;
  }
}

bool is_pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// sv, pv -> osv, opv, int32 [n]: `reps` stages at distance d over tiles of
// `tile` pairs. Launches on `stream`, does not synchronise, and returns the
// CUDA error of the first launch that failed (cudaErrorInvalidValue for
// shapes the kernel does not take).
extern "C" int tj_stage_reps(const void* sv, const void* pv, void* osv,
                             void* opv, int64_t n, int64_t d, int64_t reps,
                             int64_t tile, void* stream) {
  if (!is_pow2(d) || !is_pow2(tile) || 2 * d > tile || tile < 128 ||
      tile > (int64_t{1} << 30) || n <= 0 || n % tile != 0 || reps < 1 ||
      reps > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* in_key = static_cast<const int32_t*>(sv);
  const int32_t* in_pay = static_cast<const int32_t*>(pv);
  int32_t* key = static_cast<int32_t*>(osv);
  int32_t* pay = static_cast<int32_t*>(opv);

  if (tile <= kMaxBlockElems) {
    if (n / tile > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    // dynamic shared memory above 48 KB has to be asked for
    cudaError_t err = cudaFuncSetAttribute(
        stage_reps_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxBlockElems * 2 * static_cast<int>(sizeof(int32_t)));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads =
        static_cast<int>(tile / 2 < kMaxThreads ? tile / 2 : kMaxThreads);
    stage_reps_shared_kernel<<<static_cast<unsigned int>(n / tile), threads,
                               tile * 2 * sizeof(int32_t), s>>>(
        in_key, in_pay, key, pay, static_cast<int>(tile), static_cast<int>(d),
        static_cast<int>(reps));
    return static_cast<int>(cudaGetLastError());
  }

  const int64_t exchanges = n / 2;
  const int64_t blocks = (exchanges + kGlobalThreads - 1) / kGlobalThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  for (int64_t r = 0; r < reps; ++r) {
    stage_global_kernel<<<static_cast<unsigned int>(blocks), kGlobalThreads, 0,
                          s>>>(r == 0 ? in_key : key, r == 0 ? in_pay : pay,
                               key, pay, exchanges, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
