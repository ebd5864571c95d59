// construct_probes.cu: a ladder of minimal kernels, each one construct of the
// merge kernels more than the last, for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
//   tj_probe_*  replace the probes of benchmarks/mosaic_bisect.py: _mk_pallas
//       (:89) with p_min_dma (:106) and p_min_dma_compute (:131), and the
//       kernels of p_concat_merge (:163), _stage_probe (:193), p_concat_only
//       (:210), p_sublane_ladder (:225), p_dirmask_stage (:246),
//       p_transpose_only (:265), p_lane_ladder_T (:281), p_full_merge_T (:302)
//       and p_merge_T_dm (:322).
//
// On the TPU the ladder only compiles: it found the construct that crashed
// the kernel compiler. Here each probe runs its construct on real blocks and
// is held against its plain version (benchmarks/construct_probes.py), so each
// is the smallest working example of one construct on this card: an
// asynchronous copy into shared memory (cp.async through the pipeline
// primitives, then a wait), window masking, a concatenation, one stage, a
// ladder of stages, a stage with a per-row direction, a transpose through a
// padded tile, and the small stages run out of a transposed layout.
//
// Blocks are rows of 128 int32. A block of [128, 128] is 2^14 elements; as a
// (key, payload) pair it takes 128 KB of shared memory, 129 KB with rows
// padded to 129 words. The padded layout makes a column walk conflict-free
// (129 = 1 mod 32 banks), so a [128, 128] tile transposes in place by
// swapping (r, c) with (c, r), and after it the stages at distance d < 128,
// which pair neighbours inside a row, pair whole rows: `_cx_rows` on the
// transpose computes what `_cx` computes at d < 128 (merge_pallas.py:128,
// :170-175). The two probes that concatenate two [128, 128] blocks work on
// 2^15 pairs, more than a block holds: their first stage, at distance 2^14,
// pairs element i of the one block with element i of the other and runs from
// device memory as the halves are loaded; the halves then go through shared
// memory one after the other.
//
// What bounds them: every probe moves at most 2^15 pairs (256 KB); the bytes
// over 3.35 TB/s are below 0.1 us and a ladder of 15 stages of 2^14 exchanges
// below 0.1 us of the card's integer rate, so each probe's time is a launch's
// latency plus one block's serial stages, not a rate of the card.

#include <climits>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kLanes = 128;
constexpr int kWindowRows = 64;                   // rows of a copy window
constexpr int kWindow = kWindowRows * kLanes;     // 8192 elements
constexpr int kBlockRows = 128;                   // rows of a full block
constexpr int kBlock = kBlockRows * kLanes;       // 2^14 elements
constexpr int kPitch = kLanes + 1;                // padded row, in words
constexpr int kPadded = kBlockRows * kPitch;      // a padded [128, 128] tile

// Element (r, c) of a [128, 128] tile, flat place i = r * 128 + c, at row r
// of the padded tile ...
struct Padded {
  __device__ __forceinline__ int operator()(int i) const {
    return (i >> 7) * kPitch + (i & 127);
  }
};
// ... and at row c after the tile was transposed.
struct PaddedT {
  __device__ __forceinline__ int operator()(int i) const {
    return (i & 127) * kPitch + (i >> 7);
  }
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// Copy `words` int32 (a multiple of 4, both sides 16-byte aligned) from
// device memory into shared memory with cp.async, 16 bytes a request, and
// wait for the block's copies.
__device__ __forceinline__ void copy_async(int32_t* dst, const int32_t* src,
                                           int words) {
  for (int i = threadIdx.x * 4; i < words; i += blockDim.x * 4) {
    __pipeline_memcpy_async(dst + i, src + i, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Swap (r, c) with (c, r) over a padded [128, 128] tile, in place.
__device__ __forceinline__ void transpose_in_place(int32_t* tile) {
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
    const int r = i >> 7;
    const int c = i & 127;
    if (r < c) {
      const int32_t x = tile[r * kPitch + c];
      tile[r * kPitch + c] = tile[c * kPitch + r];
      tile[c * kPitch + r] = x;
    }
  }
}

// The stages at distance 64 .. 1 of a [128, 128] pair held in the padded
// layout, run as row stages on its transpose, and back.
__device__ __forceinline__ void lane_stages_transposed(int32_t* key,
                                                       int32_t* pay,
                                                       bool row_mask) {
  transpose_in_place(key);
  transpose_in_place(pay);
  __syncthreads();
  for (int d = 64; d >= 1; d >>= 1) {
    tj_stage_row_mask(key, pay, kBlock, d, row_mask, PaddedT());
    __syncthreads();
  }
  transpose_in_place(key);
  transpose_in_place(pay);
  __syncthreads();
}

// ---- the asynchronous copy ---------------------------------------------------

// Block t copies the window of 64 rows that starts at row meta[t, 0] into
// shared memory and back out at the same rows. meta int32 [2, 2].
__global__ void __launch_bounds__(kThreads)
min_dma_kernel(const int32_t* __restrict__ meta, const int32_t* __restrict__ x,
               int32_t* __restrict__ o, int rows) {
  __shared__ __align__(16) int32_t buf[kWindow];
  const int r0 = meta[blockIdx.x * 2];
  if (r0 < 0 || r0 + kWindowRows > rows) __trap();
  copy_async(buf, x + static_cast<int64_t>(r0) * kLanes, kWindow);
  int4* out = reinterpret_cast<int4*>(o + static_cast<int64_t>(r0) * kLanes);
  const int4* in = reinterpret_cast<const int4*>(buf);
  for (int i = threadIdx.x; i < kWindow / 4; i += blockDim.x) out[i] = in[i];
}

// min_dma plus the merge kernel's body between the copies: two windows, the
// masking of merge_pallas.py:297 (`_mask_windows`), a bitonic merge of the
// concatenation, and the first 64 rows of key + payload written at the
// tile's output row. meta int32 [7, ntiles], the layout of the merge-path
// plan (ops/merge.py, merge_level_meta): rows 0, 1 the windows' first rows,
// 2, 3 the valid span of A, 4, 5 that of B, 6 the output row. The payloads
// are the raw windows.
__global__ void __launch_bounds__(kThreads)
min_dma_compute_kernel(const int32_t* __restrict__ meta, int ntiles,
                       const int32_t* __restrict__ x, int32_t* __restrict__ o,
                       int rows) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* key = smem;
  int32_t* pay = smem + 2 * kWindow;
  const int t = blockIdx.x;
  const int a_row = meta[0 * ntiles + t];
  const int b_row = meta[1 * ntiles + t];
  const int a_lo = meta[2 * ntiles + t];
  const int a_hi = meta[3 * ntiles + t];
  const int b_wlo = meta[4 * ntiles + t];
  const int b_whi = meta[5 * ntiles + t];
  const int out_row = meta[6 * ntiles + t];
  if (a_row < 0 || a_row + kWindowRows > rows || b_row < 0 ||
      b_row + kWindowRows > rows || out_row < 0 ||
      out_row + kWindowRows > rows) {
    __trap();
  }
  for (int i = threadIdx.x * 4; i < kWindow; i += blockDim.x * 4) {
    __pipeline_memcpy_async(pay + i,
                            x + static_cast<int64_t>(a_row) * kLanes + i, 16);
    __pipeline_memcpy_async(pay + kWindow + i,
                            x + static_cast<int64_t>(b_row) * kLanes + i, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int i = threadIdx.x; i < kWindow; i += blockDim.x) {
    int32_t a = pay[i];
    if (i < a_lo) a = INT32_MIN;
    if (i >= a_hi) a = INT32_MAX;
    key[i] = a;
    int32_t b = ~pay[kWindow + i];
    if (i < b_wlo) b = INT32_MAX;
    if (i >= b_whi) b = INT32_MIN;
    key[kWindow + i] = b;
  }
  __syncthreads();
  for (int d = kWindow; d >= 1; d >>= 1) {
    tj_stage_ascending(key, pay, 2 * kWindow, d);
    __syncthreads();
  }
  int32_t* out = o + static_cast<int64_t>(out_row) * kLanes;
  for (int i = threadIdx.x; i < kWindow; i += blockDim.x) {
    out[i] = wrap_add(key[i], pay[i]);
  }
}

// ---- concatenation, stages, ladders -------------------------------------------

// o [128, 128] = a [64, 128] over b [64, 128], through shared memory.
__global__ void __launch_bounds__(kThreads)
concat_only_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ o) {
  extern __shared__ __align__(16) int32_t smem[];
  for (int i = threadIdx.x; i < kWindow; i += blockDim.x) {
    smem[i] = a[i];
    smem[kWindow + i] = b[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * kWindow; i += blockDim.x) o[i] = smem[i];
}

// Block t: keys = a_t over b_t, payloads = b_t over a_t (the t-th windows of
// 64 rows), the merge ladder at distance 2^13 .. 1, o_t [128, 128] = key +
// payload.
__global__ void __launch_bounds__(kThreads)
concat_merge_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    int32_t* __restrict__ o) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* key = smem;
  int32_t* pay = smem + kBlock;
  const int32_t* at = a + static_cast<int64_t>(blockIdx.x) * kWindow;
  const int32_t* bt = b + static_cast<int64_t>(blockIdx.x) * kWindow;
  for (int i = threadIdx.x; i < kWindow; i += blockDim.x) {
    key[i] = at[i];
    key[kWindow + i] = bt[i];
    pay[i] = bt[i];
    pay[kWindow + i] = at[i];
  }
  __syncthreads();
  for (int d = kBlock / 2; d >= 1; d >>= 1) {
    tj_stage_ascending(key, pay, kBlock, d);
    __syncthreads();
  }
  int32_t* out = o + static_cast<int64_t>(blockIdx.x) * kBlock;
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
    out[i] = wrap_add(key[i], pay[i]);
  }
}

// A [128, 128] pair (keys a, payloads b) into shared memory in layout `at`.
template <typename At>
__device__ __forceinline__ void load_pair(int32_t* key, int32_t* pay,
                                          const int32_t* a, const int32_t* b,
                                          At at) {
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
    key[at(i)] = a[i];
    pay[at(i)] = b[i];
  }
  __syncthreads();
}

template <typename At>
__device__ __forceinline__ void store_sum(int32_t* o, const int32_t* key,
                                          const int32_t* pay, At at) {
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
    o[i] = wrap_add(key[at(i)], pay[at(i)]);
  }
}

// One stage at distance d, every group ascending; o = key + payload.
__global__ void __launch_bounds__(kThreads)
stage_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             int32_t* __restrict__ o, int d) {
  extern __shared__ __align__(16) int32_t smem[];
  load_pair(smem, smem + kBlock, a, b, TjFlat());
  tj_stage_ascending(smem, smem + kBlock, kBlock, d);
  __syncthreads();
  store_sum(o, smem, smem + kBlock, TjFlat());
}

// The stages at distance 2^13 .. 128 (whole rows).
__global__ void __launch_bounds__(kThreads)
sublane_ladder_kernel(const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b, int32_t* __restrict__ o) {
  extern __shared__ __align__(16) int32_t smem[];
  load_pair(smem, smem + kBlock, a, b, TjFlat());
  for (int d = kBlock / 2; d >= kLanes; d >>= 1) {
    tj_stage_ascending(smem, smem + kBlock, kBlock, d);
    __syncthreads();
  }
  store_sum(o, smem, smem + kBlock, TjFlat());
}

// One stage at distance 128 whose direction comes from the row's parity.
__global__ void __launch_bounds__(kThreads)
dirmask_stage_kernel(const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b, int32_t* __restrict__ o) {
  extern __shared__ __align__(16) int32_t smem[];
  load_pair(smem, smem + kBlock, a, b, TjFlat());
  tj_stage_row_mask(smem, smem + kBlock, kBlock, kLanes, true, TjFlat());
  __syncthreads();
  store_sum(o, smem, smem + kBlock, TjFlat());
}

// ---- the transposed layout ----------------------------------------------------

// o = a.T.T + 1: a [128, 128] into one padded tile, transposed into a second
// one, and transposed back into the first.
__global__ void __launch_bounds__(kThreads)
transpose_only_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ o) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* x = smem;
  int32_t* xt = smem + kPadded;
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) x[Padded()(i)] = a[i];
  __syncthreads();
  // i walks the target's rows, so each read is a column walk of the source
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
    xt[Padded()(i)] = x[PaddedT()(i)];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
    x[Padded()(i)] = xt[PaddedT()(i)];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
    o[i] = wrap_add(x[Padded()(i)], 1);
  }
}

// The seven stages at distance 64 .. 1 as row stages on the transposed tile.
__global__ void __launch_bounds__(kThreads)
lane_ladder_T_kernel(const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b, int32_t* __restrict__ o) {
  extern __shared__ __align__(16) int32_t smem[];
  load_pair(smem, smem + kPadded, a, b, Padded());
  lane_stages_transposed(smem, smem + kPadded, false);
  store_sum(o, smem, smem + kPadded, Padded());
}

// keys = a over b, payloads = b over a ([256, 128], 2^15 pairs); the merge
// ladder at distance 2^14 .. 1 with the stages below 128 on the transposed
// tile and, with row_mask, every stage's direction from the row's parity;
// o [128, 128] = the keys' first half + the payloads' second half.
__device__ __forceinline__ void merge_T(const int32_t* a, const int32_t* b,
                                        int32_t* o, bool row_mask) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* key = smem;
  int32_t* pay = smem + kPadded;
  for (int half = 0; half < 2; ++half) {
    // the stage at distance 2^14, from device memory: exchange i pairs
    // (a[i], b[i]) of the first block with (b[i], a[i]) of the second; this
    // half keeps the lower or the upper result
    for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
      const int32_t ka = a[i];
      const int32_t kb = b[i];
      const bool descending = row_mask && ((i >> 7) & 1);
      const bool swap = (kb < ka) != descending;
      const bool first = swap == (half == 1);   // this half gets (a[i], b[i])
      key[Padded()(i)] = first ? ka : kb;
      pay[Padded()(i)] = first ? kb : ka;
    }
    __syncthreads();
    for (int d = kBlock / 2; d >= kLanes; d >>= 1) {
      tj_stage_row_mask(key, pay, kBlock, d, row_mask, Padded());
      __syncthreads();
    }
    lane_stages_transposed(key, pay, row_mask);
    for (int i = threadIdx.x; i < kBlock; i += blockDim.x) {
      o[i] = half == 0 ? key[Padded()(i)] : wrap_add(o[i], pay[Padded()(i)]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
full_merge_T_kernel(const int32_t* a, const int32_t* b, int32_t* o) {
  merge_T(a, b, o, false);
}

__global__ void __launch_bounds__(kThreads)
merge_T_dm_kernel(const int32_t* a, const int32_t* b, int32_t* o) {
  merge_T(a, b, o, true);
}

constexpr int kPairBytes = 2 * kBlock * static_cast<int>(sizeof(int32_t));
constexpr int kPaddedPairBytes = 2 * kPadded * static_cast<int>(sizeof(int32_t));

// Launch one block-sized probe with `bytes` of dynamic shared memory (above
// 48 KB it has to be asked for) and return the launch's CUDA error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int bytes, void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* out(void* p) { return static_cast<int32_t*>(p); }

}  // namespace

// Every entry point has one signature: (meta, a, b, o, arg, stream), with
// null pointers and 0 where a probe takes no such operand. All launch on
// `stream`, do not synchronise, and return the CUDA error of the launch
// (cudaErrorInvalidValue for an argument the probe does not take). Shapes
// are the probes' own and are checked by the Python wrappers.

// meta int32 [2, 2], a = x int32 [arg, 128] -> o int32 [arg, 128] (zeroed by
// the caller: only the two windows are written).
extern "C" int tj_probe_min_dma(const void* meta, const void* a, const void* b,
                                void* o, int64_t arg, void* stream) {
  (void)b;
  if (arg < kWindowRows || arg > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  min_dma_kernel<<<2, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in(meta), in(a), out(o), static_cast<int>(arg));
  return static_cast<int>(cudaGetLastError());
}

// meta int32 [7, 2], a = x int32 [arg, 128] -> o int32 [arg, 128] (zeroed by
// the caller).
extern "C" int tj_probe_min_dma_compute(const void* meta, const void* a,
                                        const void* b, void* o, int64_t arg,
                                        void* stream) {
  (void)b;
  if (arg < kWindowRows || arg > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(min_dma_compute_kernel, 2, kPairBytes, stream, in(meta), 2,
                in(a), out(o), static_cast<int>(arg));
}

// a, b int32 [64, 128] -> o int32 [128, 128].
extern "C" int tj_probe_concat_only(const void* meta, const void* a,
                                    const void* b, void* o, int64_t arg,
                                    void* stream) {
  (void)meta; (void)arg;
  return launch(concat_only_kernel, 1, kPairBytes / 2, stream, in(a), in(b),
                out(o));
}

// a, b int32 [128, 128] -> o int32 [256, 128].
extern "C" int tj_probe_concat_merge(const void* meta, const void* a,
                                     const void* b, void* o, int64_t arg,
                                     void* stream) {
  (void)meta; (void)arg;
  return launch(concat_merge_kernel, 2, kPairBytes, stream, in(a), in(b),
                out(o));
}

// a, b int32 [128, 128] -> o int32 [128, 128]; arg = the distance, a power of
// two in [1, 2^13].
extern "C" int tj_probe_stage(const void* meta, const void* a, const void* b,
                              void* o, int64_t arg, void* stream) {
  (void)meta;
  if (arg < 1 || arg > kBlock / 2 || (arg & (arg - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(stage_kernel, 1, kPairBytes, stream, in(a), in(b), out(o),
                static_cast<int>(arg));
}

// The remaining probes: a, b int32 [128, 128] -> o int32 [128, 128]
// (transpose_only takes a alone).
extern "C" int tj_probe_sublane_ladder(const void* meta, const void* a,
                                       const void* b, void* o, int64_t arg,
                                       void* stream) {
  (void)meta; (void)arg;
  return launch(sublane_ladder_kernel, 1, kPairBytes, stream, in(a), in(b),
                out(o));
}

extern "C" int tj_probe_dirmask_stage(const void* meta, const void* a,
                                      const void* b, void* o, int64_t arg,
                                      void* stream) {
  (void)meta; (void)arg;
  return launch(dirmask_stage_kernel, 1, kPairBytes, stream, in(a), in(b),
                out(o));
}

extern "C" int tj_probe_transpose_only(const void* meta, const void* a,
                                       const void* b, void* o, int64_t arg,
                                       void* stream) {
  (void)meta; (void)b; (void)arg;
  return launch(transpose_only_kernel, 1, kPaddedPairBytes, stream, in(a),
                out(o));
}

extern "C" int tj_probe_lane_ladder_T(const void* meta, const void* a,
                                      const void* b, void* o, int64_t arg,
                                      void* stream) {
  (void)meta; (void)arg;
  return launch(lane_ladder_T_kernel, 1, kPaddedPairBytes, stream, in(a),
                in(b), out(o));
}

extern "C" int tj_probe_full_merge_T(const void* meta, const void* a,
                                     const void* b, void* o, int64_t arg,
                                     void* stream) {
  (void)meta; (void)arg;
  return launch(full_merge_T_kernel, 1, kPaddedPairBytes, stream, in(a), in(b),
                out(o));
}

extern "C" int tj_probe_merge_T_dm(const void* meta, const void* a,
                                   const void* b, void* o, int64_t arg,
                                   void* stream) {
  (void)meta; (void)arg;
  return launch(merge_T_dm_kernel, 1, kPaddedPairBytes, stream, in(a), in(b),
                out(o));
}
