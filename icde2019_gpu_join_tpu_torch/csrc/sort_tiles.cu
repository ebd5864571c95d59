// sort_tiles.cu: the full bitonic sort of every tile of (sortval, payload)
// pairs, for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
//   tj_sort_tiles  replaces sort_tiles
//       (benchmarks/experimental_sort_pallas.py:107, kernel _sort_kernel :100,
//       network bitonic_tile :41): each tile of tile_elems pairs sorted by
//       sortval ascending, signed; n a multiple of tile_elems, a power of two
//       of at least 1024. The network is the classic one: for k = 1 ..
//       log2(tile), stages at distance 2^(k-1) .. 1, a group ascending iff bit
//       k of an element's flat index within its tile is 0. The exchange is
//       element-wise (bitonic.cuh, tj_exchange_elementwise), so on equal keys
//       payloads are duplicated and lost exactly as the reference does it.
//
// The TPU kernel holds a whole tile (2^20 pairs, 8 MB) in fast memory. A
// thread block holds 2^14 pairs (128 KB of its 227 KB of shared memory), so
// the network is split the way a bitonic sort is split on a GPU:
//
//   (a) sort_chunks_kernel, k = 1 .. 14: every stage lies inside a chunk of
//       2^14 pairs, one block per chunk, all 105 stages in shared memory;
//   (b) for each k > 14, the stages at distance >= 2^14 as passes over device
//       memory (sort_global_stage_kernel, an exchange per thread, in place),
//   (c) then the stages at distance 2^13 .. 1 of that k inside shared memory
//       again (sort_chunks_kernel with k_lo = k_hi = k, in place).
//
// The TPU reaches a partner with two rolls and selects over the whole tile;
// here a thread owns an exchange and indexes both elements (tj_stage_lo).
// What bounds it: 16 bytes per pair if everything stayed on chip (0.64 ms at
// n = 2^27 at 3.35 TB/s) against log2(tile) * (log2(tile) + 1) / 2 stages of
// n / 2 exchanges (210 at 2^20), five integer operations each. At tile 2^20
// the design pays 21 passes over device memory and 7 loads and stores of the
// chunks besides; 189 stages run in shared memory, each 4 loads and up to 4
// stores of 4 bytes per exchange. Warp shuffles for d < 32, several elements a
// thread in registers and fusing two global stages into one pass are later
// work.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kLogBlockElems = 14;   // pairs a block holds: 2^14, 128 KB
constexpr int kGlobalThreads = 256;

// Stages k = k_lo .. k_hi, each from distance min(2^(k-1), chunk / 2) down to
// 1, over one chunk of 1 << log_chunk pairs per block. The outputs may be the
// inputs: a block reads its whole chunk before it writes it.
__global__ void __launch_bounds__(kMaxThreads)
sort_chunks_kernel(const int32_t* sv, const int32_t* pv, int32_t* osv,
                   int32_t* opv, int log_chunk, int k_lo, int k_hi,
                   int64_t tile_mask) {
  extern __shared__ __align__(16) int32_t smem[];
  const int chunk = 1 << log_chunk;
  int32_t* key = smem;
  int32_t* pay = smem + chunk;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    key[i] = sv[base + i];
    pay[i] = pv[base + i];
  }
  __syncthreads();

  const int64_t flat = base & tile_mask;   // the chunk's place in its tile
  for (int k = k_lo; k <= k_hi; ++k) {
    for (int j = (k < log_chunk ? k : log_chunk) - 1; j >= 0; --j) {
      tj_stage_index_bit(key, pay, chunk, j, k, flat);
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    osv[base + i] = key[i];
    opv[base + i] = pay[i];
  }
}

// One stage at distance 1 << j of merge k over the whole arrays in device
// memory, in place: thread i owns exchange i and touches no other element.
__global__ void __launch_bounds__(kGlobalThreads)
sort_global_stage_kernel(int32_t* key, int32_t* pay, int64_t exchanges, int j,
                         int k, int64_t tile_mask) {
  const int64_t d = int64_t{1} << j;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < exchanges; i += stride) {
    const int64_t lo = ((i & ~(d - 1)) << 1) | (i & (d - 1));
    const bool ascending = (((lo & tile_mask) >> k) & 1) == 0;
    tj_exchange_elementwise(key + lo, pay + lo, 0, static_cast<int>(d),
                            ascending);
  }
}

bool is_pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

int log2_of(int64_t x) {
  int l = 0;
  while ((int64_t{1} << l) < x) ++l;
  return l;
}

}  // namespace

// sv, pv -> osv, opv, int32 [n]: every tile of tile_elems pairs sorted by sv.
// Launches on `stream`, does not synchronise, and returns the CUDA error of
// the first launch that failed (cudaErrorInvalidValue for shapes the kernel
// does not take).
extern "C" int tj_sort_tiles(const void* sv, const void* pv, void* osv,
                             void* opv, int64_t n, int64_t tile_elems,
                             void* stream) {
  if (!is_pow2(tile_elems) || tile_elems < 1024 ||
      tile_elems > (int64_t{1} << 30) || n <= 0 || n % tile_elems != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int log_tile = log2_of(tile_elems);
  const int log_chunk = log_tile < kLogBlockElems ? log_tile : kLogBlockElems;
  const int64_t chunks = n >> log_chunk;
  const int64_t exchanges = n / 2;
  const int64_t global_blocks = (exchanges + kGlobalThreads - 1) / kGlobalThreads;
  if (chunks > INT32_MAX || global_blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // dynamic shared memory above 48 KB has to be asked for
  cudaError_t err = cudaFuncSetAttribute(
      sort_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (1 << kLogBlockElems) * 2 * static_cast<int>(sizeof(int32_t)));
  if (err != cudaSuccess) return static_cast<int>(err);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = (1 << log_chunk) / 2 < kMaxThreads ? (1 << log_chunk) / 2
                                                         : kMaxThreads;
  const size_t shared = (size_t{2} << log_chunk) * sizeof(int32_t);
  const int64_t tile_mask = tile_elems - 1;
  int32_t* key = static_cast<int32_t*>(osv);
  int32_t* pay = static_cast<int32_t*>(opv);

  sort_chunks_kernel<<<static_cast<unsigned int>(chunks), threads, shared, s>>>(
      static_cast<const int32_t*>(sv), static_cast<const int32_t*>(pv), key,
      pay, log_chunk, 1, log_chunk, tile_mask);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  for (int k = log_chunk + 1; k <= log_tile; ++k) {
    for (int j = k - 1; j >= log_chunk; --j) {
      sort_global_stage_kernel<<<static_cast<unsigned int>(global_blocks),
                                 kGlobalThreads, 0, s>>>(key, pay, exchanges,
                                                         j, k, tile_mask);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    sort_chunks_kernel<<<static_cast<unsigned int>(chunks), threads, shared,
                         s>>>(key, pay, key, pay, log_chunk, k, k, tile_mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
