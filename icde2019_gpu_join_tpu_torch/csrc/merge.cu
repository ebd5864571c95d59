// merge.cu: the two kernels of the merge-tree sort of (sortval, payload)
// pairs, for Hopper (sm_90a), with a plain C interface loaded through ctypes.
// All arrays are int32; n, run lengths and windows are powers of two.
//
// Run encoding (ops/merge.py): run r is stored sorted ascending by
// stored = actual ^ -(r & 1), so an odd run's actual keys descend in position
// and two neighbouring runs are one bitonic sequence.
//
//   tj_merge_levels     replaces merge_levels_vmem
//       (icde2019_gpu_join_tpu/ops/merge_pallas.py:206, kernel _vmem_kernel
//       :182): `levels` bitonic merge levels, runs of run_len -> runs of
//       run_len << levels, same encoding.
//   tj_merge_level_hbm  replaces merge_level_hbm (:442; kernels _hbm_kernel
//       :313 and _hbm_kernel_db :356): one merge-path level. Per output tile
//       the planner's meta column names two 128-aligned windows, one of each
//       run of a pair; the rows off the tile's diagonal are masked to -inf /
//       +inf, the 2 * window elements merge in one bitonic merge, and the
//       tile's rows of the output run are written.
//
// tj_merge_levels. What it computes does not depend on the TPU's tile: every
// compared pair lies inside one output run and the parities come from the
// global row. So a block takes exactly one output run (run_len << levels
// elements, at most 2^14: 128 KB of dynamic shared memory, hence
// cudaFuncSetAttribute), decodes on load (stored ^ -(input-run parity)), runs
// each level's stages d = l .. 1 with swap = (hi < lo) ^ (output-run parity),
// a __syncthreads() between stages, and re-encodes on store. What bounds it:
// 16 bytes moved per element (0.64 ms at n = 2^27 at 3.35 TB/s) against
// SUM log2 stages of exchanges in shared memory (27 at run_len 4096, levels
// 2), each 4 loads and up to 4 stores of 4 bytes; the shared-memory traffic,
// about 27 * 24 bytes per element, is what the time follows. One block per
// SM at 128 KB, so a block's loads do not overlap another's stages. Warp
// shuffles for d < 32, several elements a thread in registers and cp.async
// loads are later work.
//
// tj_merge_level_hbm. One block per output tile; it reads its own seven meta
// values (the TPU's scalar prefetch) and copies both windows into shared
// memory (2 * 8192 pairs = 128 KB). The TPU grid runs in order: there every
// tile writes window - 128 rows, junk included, and a pair's last tile, which
// runs later, overwrites the +inf tail of the tile before it. Blocks run in
// no order, so a block writes only its valid rows,
// (a_hi - a_lo) + (b_whi - b_wlo) of them: window - 128 for every tile but
// the second to last of a pair. Then no two blocks write the same row and the
// output is the TPU's. The double-buffered TPU body overlapped one grid
// step's copies with the next one's merge; parallel blocks need no such
// body, so one kernel stands for both. What bounds it: 16 bytes per element
// against 14 stages in shared memory at window 8192; one block per SM, no
// overlap of copy and merge inside it. A smaller window with a staging ring,
// and the binary search inside the block, are later work.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxBlockElems = 1 << 14;   // pairs a block holds: 128 KB

__global__ void __launch_bounds__(kMaxThreads)
merge_levels_kernel(const int32_t* __restrict__ sv,
                    const int32_t* __restrict__ pv, int32_t* __restrict__ osv,
                    int32_t* __restrict__ opv, int log_run, int levels) {
  extern __shared__ __align__(16) int32_t smem[];
  const int span = 1 << (log_run + levels);
  int32_t* key = smem;
  int32_t* pay = smem + span;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * span;

  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const int64_t g = base + i;
    const int32_t odd = static_cast<int32_t>((g >> log_run) & 1);
    key[i] = sv[g] ^ -odd;   // stored -> actual
    pay[i] = pv[g];
  }
  __syncthreads();

  for (int lv = 0; lv < levels; ++lv) {
    const int log_out = log_run + lv + 1;   // this level's output runs
    for (int d = 1 << (log_out - 1); d >= 1; d >>= 1) {
      for (int i = threadIdx.x; i < span / 2; i += blockDim.x) {
        const int lo = tj_stage_lo(i, d);
        const bool descending = ((base + lo) >> log_out) & 1;
        tj_compare_exchange(key, pay, lo, lo + d, descending);
      }
      __syncthreads();
    }
  }

  const int32_t odd = static_cast<int32_t>(blockIdx.x & 1);  // span == out run
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    osv[base + i] = key[i] ^ -odd;   // actual -> stored
    opv[base + i] = pay[i];
  }
}

__global__ void __launch_bounds__(kMaxThreads)
merge_level_hbm_kernel(const int32_t* __restrict__ meta, int64_t ntiles,
                       const int32_t* __restrict__ sv,
                       const int32_t* __restrict__ pv,
                       int32_t* __restrict__ osv, int32_t* __restrict__ opv,
                       int64_t n, int window) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* key = smem;
  int32_t* pay = smem + 2 * window;
  const int64_t t = blockIdx.x;
  const int64_t a0 = static_cast<int64_t>(meta[0 * ntiles + t]) * 128;
  const int64_t b0 = static_cast<int64_t>(meta[1 * ntiles + t]) * 128;
  const int a_lo = meta[2 * ntiles + t];
  const int a_hi = meta[3 * ntiles + t];
  const int b_wlo = meta[4 * ntiles + t];
  const int b_whi = meta[5 * ntiles + t];
  const int64_t out0 = static_cast<int64_t>(meta[6 * ntiles + t]) * 128;
  // the merged -inf front, and the tile's valid rows after it
  const int front = a_lo + window - b_whi;
  const int count = (a_hi - a_lo) + (b_whi - b_wlo);
  // a plan that points outside the arrays is a fault of the planner: trap,
  // so that the next synchronisation raises, and never leave rows unwritten
  if (a0 < 0 || b0 < 0 || a0 + window > n || b0 + window > n || front < 0 ||
      count < 0 || front + count > 2 * window || out0 < 0 ||
      out0 + count > n) {
    __trap();
  }

  for (int i = threadIdx.x; i < window; i += blockDim.x) {
    // A ascends, stored == working
    int32_t a = sv[a0 + i];
    if (i < a_lo) a = INT32_MIN;
    if (i >= a_hi) a = INT32_MAX;
    key[i] = a;
    pay[i] = pv[a0 + i];
    // B is complement-encoded and descends in working values: junk before
    // its valid rows is larger, junk after them smaller, so [A | B] stays
    // bitonic
    int32_t b = ~sv[b0 + i];
    if (i < b_wlo) b = INT32_MAX;
    if (i >= b_whi) b = INT32_MIN;
    key[window + i] = b;
    pay[window + i] = pv[b0 + i];
  }
  __syncthreads();

  for (int d = window; d >= 1; d >>= 1) {
    tj_stage_ascending(key, pay, 2 * window, d);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    osv[out0 + i] = key[front + i];
    opv[out0 + i] = pay[front + i];
  }
}

bool is_pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

int log2_of(int64_t x) {
  int l = 0;
  while ((int64_t{1} << l) < x) ++l;
  return l;
}

// Dynamic shared memory above 48 KB has to be asked for.
template <typename Kernel>
cudaError_t allow_block_memory(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxBlockElems * 2 * static_cast<int>(sizeof(int32_t)));
}

}  // namespace

// Both launch on `stream`, do not synchronise, and return the CUDA error of
// the launch (cudaErrorInvalidValue for shapes the kernel does not take).

// sv, pv -> osv, opv, int32 [n]: runs of run_len -> runs of run_len << levels.
extern "C" int tj_merge_levels(const void* sv, const void* pv, void* osv,
                               void* opv, int64_t n, int64_t run_len,
                               int64_t levels, void* stream) {
  if (!is_pow2(run_len) || run_len < 128 || levels < 1 || levels > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t span = run_len << levels;
  if (span > kMaxBlockElems || n <= 0 || n % span != 0 ||
      n / span > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_block_memory(merge_levels_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads =
      static_cast<int>(span / 2 < kMaxThreads ? span / 2 : kMaxThreads);
  merge_levels_kernel<<<static_cast<unsigned int>(n / span), threads,
                        span * 2 * sizeof(int32_t),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sv), static_cast<const int32_t*>(pv),
      static_cast<int32_t*>(osv), static_cast<int32_t*>(opv),
      log2_of(run_len), static_cast<int>(levels));
  return static_cast<int>(cudaGetLastError());
}

// meta int32 [7, ntiles] (ops/merge.py, merge_level_meta); sv, pv -> osv, opv,
// int32 [n]; every tile's valid rows are written, nothing else.
extern "C" int tj_merge_level_hbm(const void* meta, const void* sv,
                                  const void* pv, void* osv, void* opv,
                                  int64_t n, int64_t ntiles, int64_t window,
                                  void* stream) {
  if (ntiles == 0) return 0;
  if (!is_pow2(window) || window < 128 || 2 * window > kMaxBlockElems ||
      n < 2 * window || ntiles < 0 || ntiles > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_block_memory(merge_level_hbm_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads =
      static_cast<int>(window < kMaxThreads ? window : kMaxThreads);
  merge_level_hbm_kernel<<<static_cast<unsigned int>(ntiles), threads,
                           window * 4 * sizeof(int32_t),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(meta), ntiles,
      static_cast<const int32_t*>(sv), static_cast<const int32_t*>(pv),
      static_cast<int32_t*>(osv), static_cast<int32_t*>(opv), n,
      static_cast<int>(window));
  return static_cast<int>(cudaGetLastError());
}
