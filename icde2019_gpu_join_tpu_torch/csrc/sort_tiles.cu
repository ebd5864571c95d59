// sort_tiles.cu: the full bitonic sort of every tile of (sortval, payload)
// pairs, for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
//   tj_sort_chunks, tj_sort_strided  together replace sort_tiles
//       (benchmarks/experimental_sort_pallas.py:107, kernel _sort_kernel :100,
//       network bitonic_tile :41): each tile of tile_elems pairs sorted by
//       sortval ascending, signed; n a multiple of tile_elems, a power of two
//       of at least 1024. The network is the classic one: for k = 1 ..
//       log2(tile), stages at distance 2^(k-1) .. 1, a group ascending iff bit
//       k of an element's flat index within its tile is 0. The exchange is
//       element-wise (bitonic.cuh, TjElementwise), so on equal keys payloads
//       are duplicated and lost exactly as the reference does it.
//
// The TPU kernel holds a whole tile (2^20 pairs, 8 MB) in fast memory. A
// thread block holds at most 2^14 pairs, 16 a thread in registers
// (bitonic.cuh), with shared memory (8 bytes a pair) as the exchange buffer
// between register layouts. What bounds it: 16 bytes per pair if everything
// stayed on chip (0.64 ms at n = 2^27 at 3.35 TB/s) against
// log2(tile) * (log2(tile) + 1) / 2 stages of n / 2 exchanges (210 at 2^20),
// five integer operations each: operations. What the time follows is the
// number of trips, through device memory and through shared memory, so the
// launches are cut to fit a block and each runs as many stages a trip as it
// can:
//
//   (a) sort_chunks_kernel, merges k = 1 .. 14: every stage lies inside a
//       chunk of 2^14 pairs, one block a chunk. Merges up to k = 9 never
//       leave the contiguous layout (shuffles and registers); a longer one
//       takes two or three trips through shared memory;
//   (b) for each k > 14, the stages at distance 2^(k-1) .. 2^13 touch only
//       index bits 13 .. k-1. sort_strided_kernel gives a block the 2^14
//       pairs that agree in every other bit: 2^bits segments of 2^(14-bits)
//       neighbours, at most 7 bits a launch so that a segment is 128 pairs
//       (512 contiguous bytes an array) or more. One pass over device memory
//       for up to 7 stages, where a pass a stage was paid before; a tile
//       above 2^20 needs more than one such pass for its longest merges;
//   (c) then the stages at distance 2^12 .. 1 of that k inside chunks of
//       2^13 pairs (sort_chunks_kernel with k_lo = k_hi = k), in place: 512
//       threads and 64 KB a block, so two blocks share a multiprocessor and
//       one's loads and stores run under the other's stages.
//
// At tile 2^20: 1 + 6 + 6 = 13 launches, each one read and one write of the
// arrays. Which launches, in which order, is decided in one place only:
// `launch_schedule` of benchmarks/experimental_sort.py, which the CPU tests
// hold against the network. Its wrapper walks that list and calls one entry
// point here per launch, tj_sort_chunks for (a) and (c), tj_sort_strided for
// (b); this file holds no schedule of its own, only what one launch can take.

#include <climits>
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kE = 16;               // pairs a thread holds
constexpr int kLogE = TjLog2<kE>::value;
constexpr int kLogBlockElems = 14;   // pairs a block holds: at most 2^14
constexpr int kLogMinChunk = 10;     // and a chunk at least 2^10: 64 threads
constexpr int kMaxStridedBits = 7;   // a strided segment: 128 pairs or more
constexpr int kUniform = 30;         // a direction bit above every index bit

// Merges k = k_lo .. k_hi, each from distance min(2^(k-1), chunk / 2) down to
// 1, over one chunk of 1 << log_chunk pairs per block. The outputs may be the
// inputs: a block reads its whole chunk before it writes it.
__global__ void __launch_bounds__((1 << kLogBlockElems) / kE)
sort_chunks_kernel(const int32_t* sv, const int32_t* pv, int32_t* osv,
                   int32_t* opv, int log_chunk, int k_lo, int k_hi,
                   int64_t tile_mask) {
  extern __shared__ __align__(16) int2 exchange[];
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_chunk;
  const auto at = [base](int i) { return base + i; };
  // the chunk's place in its tile; tiles hold at most 2^30 pairs
  const int flat = static_cast<int>(base & tile_mask);

  TjRegs<kE> v;
  TjLayout l;
  if (k_lo >= log_chunk) {
    // one merge's last stages, from the top bit down: the vectors arrive in
    // the layout that runs the first two
    l = tj_layout_vec4<kE>(t, log_chunk);
    tj_load_block(v, l, sv, pv, at);
  } else {
    l = tj_layout_group<kE>(t, 0);
    tj_load_block(v, l, sv, pv, at);
  }
  for (int k = k_lo; k <= k_hi; ++k) {
    int hi = (k < log_chunk ? k : log_chunk) - 1;
    if (!tj_is_group(l, 0) && l.s0 == 0) {
      // vec4: its top register bits are the merge's first stages
      tj_stages_directed<kE, TjElementwise, true>(
          v, l, hi, log_chunk - kLogE + 2, false, flat, k);
      hi = log_chunk - kLogE + 1;
    }
    tj_block_stages<kE, TjElementwise, true>(v, l, hi, 0, flat, k, exchange);
  }
  // every merge ends in the contiguous layout
  tj_store_block(v, l, osv, opv, at);
}

// The stages at index bits bit_lo + bits - 1 .. bit_lo (>= 13) of merge k,
// in place. Block b holds the 2^14 pairs whose other bits spell b: local
// index (segment << seg_log) | offset, segment = the stage bits.
__global__ void __launch_bounds__((1 << kLogBlockElems) / kE)
sort_strided_kernel(int32_t* key, int32_t* pay, int bit_lo, int bits, int k,
                    int64_t tile_mask) {
  constexpr int log_block = kLogBlockElems;
  extern __shared__ __align__(16) int2 exchange[];
  const int t = threadIdx.x;
  const int seg_log = log_block - bits;
  const int64_t b = blockIdx.x;
  const int64_t b_low = b & ((int64_t{1} << (bit_lo - seg_log)) - 1);
  const int64_t b_high = b >> (bit_lo - seg_log);
  const int64_t base = (b_low << seg_log) | (b_high << (bit_lo + bits));
  const auto at = [base, seg_log, bit_lo](int i) {
    return base | (i & ((1 << seg_log) - 1)) |
           (static_cast<int64_t>(i >> seg_log) << bit_lo);
  };
  // bit k lies above the stage bits: one direction for the whole block
  const int flat = static_cast<int>(((base & tile_mask) >> k) & 1) << kUniform;

  TjRegs<kE> v;
  TjLayout l = tj_layout_vec4<kE>(t, log_block);
  tj_load_block(v, l, key, pay, at);
  const int top = log_block - kLogE + 2;   // the vectors' register bits
  tj_stages_directed<kE, TjElementwise, true>(
      v, l, log_block - 1, seg_log > top ? seg_log : top, false, flat,
      kUniform);
  tj_block_stages<kE, TjElementwise, true>(v, l, top - 1, seg_log, flat,
                                           kUniform, exchange);
  tj_store_block(v, l, key, pay, at);
}

// Dynamic shared memory above 48 KB has to be asked for.
template <typename Kernel>
cudaError_t allow_block_memory(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (1 << kLogBlockElems) * 2 * static_cast<int>(sizeof(int32_t)));
}

// n pairs in tiles of 1 << log_tile, cut into blocks of 1 << log_block.
bool shape_ok(int64_t n, int64_t log_tile, int64_t log_block) {
  return log_tile >= log_block && log_tile <= 30 && n > 0 &&
         n % (int64_t{1} << log_tile) == 0 && (n >> log_block) <= INT32_MAX;
}

bool aligned(std::initializer_list<const void*> arrays) {
  for (const void* p : arrays) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  }
  return true;
}

}  // namespace

// Both launch on `stream`, do not synchronise, and return the CUDA error of
// the launch (cudaErrorInvalidValue for what the kernel does not take). All
// arrays are int32 [n] and 16-byte aligned; tiles hold 1 << log_tile pairs.

// Merges k_lo .. k_hi inside chunks of 1 << log_block pairs, sv, pv -> osv,
// opv (which may be sv, pv): either every merge that fits a chunk, from the
// unsorted input (k_lo = 1, k_hi = log_block), or the last log_block stages
// of one longer merge (k_lo = k_hi > log_block).
extern "C" int tj_sort_chunks(const void* sv, const void* pv, void* osv,
                              void* opv, int64_t n, int64_t log_tile,
                              int64_t log_block, int64_t k_lo, int64_t k_hi,
                              void* stream) {
  const bool within = k_lo == 1 && k_hi == log_block;
  const bool tail = k_lo == k_hi && k_lo > log_block && k_hi <= log_tile;
  if (log_block < kLogMinChunk || log_block > kLogBlockElems ||
      !shape_ok(n, log_tile, log_block) || !(within || tail) ||
      !aligned({sv, pv, osv, opv})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_block_memory(sort_chunks_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_chunks_kernel<<<static_cast<unsigned int>(n >> log_block),
                       (1 << log_block) / kE,
                       (size_t{2} << log_block) * sizeof(int32_t),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sv), static_cast<const int32_t*>(pv),
      static_cast<int32_t*>(osv), static_cast<int32_t*>(opv),
      static_cast<int>(log_block), static_cast<int>(k_lo),
      static_cast<int>(k_hi), (int64_t{1} << log_tile) - 1);
  return static_cast<int>(cudaGetLastError());
}

// The stages of merge k at index bits bit_lo + bits - 1 .. bit_lo, in place,
// by blocks of 1 << log_block pairs (2^14, the one size the kernel is built
// for) in 2^bits segments: at most 7 bits, all below k, and bit_lo no lower
// than a segment's length.
extern "C" int tj_sort_strided(void* key, void* pay, int64_t n,
                               int64_t log_tile, int64_t log_block,
                               int64_t bit_lo, int64_t bits, int64_t k,
                               void* stream) {
  if (log_block != kLogBlockElems || bits < 1 || bits > kMaxStridedBits ||
      bit_lo + bits > k || k > log_tile || bit_lo < kLogBlockElems - bits ||
      !shape_ok(n, log_tile, kLogBlockElems) || !aligned({key, pay})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = allow_block_memory(sort_strided_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_strided_kernel<<<static_cast<unsigned int>(n >> kLogBlockElems),
                        (1 << kLogBlockElems) / kE,
                        (size_t{2} << kLogBlockElems) * sizeof(int32_t),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(key), static_cast<int32_t*>(pay),
      static_cast<int>(bit_lo), static_cast<int>(bits), static_cast<int>(k),
      (int64_t{1} << log_tile) - 1);
  return static_cast<int>(cudaGetLastError());
}
