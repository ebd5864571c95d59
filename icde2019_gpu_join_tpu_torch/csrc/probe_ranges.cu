// probe_ranges.cu: the stream-range probe kernel, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes.
//
// Replaces the TPU kernel of icde2019_gpu_join_tpu/ops/probe_pallas.py,
// probe_aggregate_ranges (:139, kernel _probe_agg_kernel :76):
//
//   *out += SUM over work items w of
//           SUM_{s < TS} sp[S0+s] * SUM_{r < TR, rk[R0+r] == sk[S0+s]} rp[R0+r]
//   where R0 = item_tile[w] * TR and S0 = item_s0[w]      (mod 2^32)
//
// R and S are radix-partitioned (CSR) int32 columns, padded with payload-0
// rows to multiples of TR and TS; the host (ops/probe_ranges.py) flattens
// each R tile's S range into one work item per TS-row chunk and clamps the
// chunks to S, as the TPU kernel clamps its chunk count. Pad rows add 0.
//
// The TPU kernel compares every R row of a tile with every S row of a chunk
// (TR * TS compares an item), because a TPU core cannot scatter into its
// on-chip memory; the reference walks a shared-memory hash table instead
// (join_partitioned_aggregate, src/join-primitives.cu:1052-1087), and so does
// this kernel: an R sub-tile of kSub = 1024 rows goes into a table of kSlots =
// 2048 slots, and each S row costs one lookup, not 1024 compares. What bounds
// it then is memory: every R and S row read once, 8 bytes a row.
//
//   * A slot is a 64-bit word, 0 when empty, else (1 << 32) | (uint32)key,
//     claimed by a shared 64-bit atomicCAS; the uint32 sum of its rows'
//     payloads lies in a second array and is added by a shared atomicAdd. So
//     every int32 key is exact, INT32_MIN, -1, 0 and INT32_MAX included: no key
//     doubles as the empty marker. Duplicates sum into one slot; the sums,
//     mod 2^32, do not depend on the order the atomics land in, so the result
//     does not depend on the order of the rows (the contract does not promise
//     sorted rows).
//   * The slot is the top 11 bits of key * 0x9E3779B1 (a multiplicative hash
//     of the full 32-bit key): keys of one tile share their radix field, the
//     low bits, so a hash of the low bits would send the whole tile to one
//     slot. Collisions probe linearly, wrapping at the table's end; at most
//     1024 keys in 2048 slots, so an empty slot always ends a miss.
//   * A block of kThreads threads takes kItemsPerBlock consecutive items (the
//     host lists them tile by tile), and builds the table once for each run of
//     items of one R tile, per 1024-row sub-tile where TR is larger; a long
//     run still spreads over several blocks. Building the table for every
//     item instead (kItemsPerBlock = 1) was measured and dropped: on an H100
//     it took 0.1034 against 0.0563 ms at config 1's plan (16 chunks a tile),
//     0.2513 against 0.0787 where every tile is one key (1024 shared atomics
//     on one address a build), 0.0606 against 0.0546 at the 2^22 Zipf plan,
//     and tied at config 2's (one chunk a tile: 0.6774 against 0.6718, the
//     bytes bound 0.641). 4 and 16 items a block were no better overall.
//   * Rows are read 16 bytes a load (four keys, four payloads a thread) where
//     the columns start on 16-byte boundaries: R sub-tiles start at multiples
//     of 1024 rows and S chunks at multiples of TS, a multiple of 128.
//   * Per S row the looked-up sum times sp adds into a uint32 (signed overflow
//     is undefined in C++, unsigned wraps mod 2^32); the block reduces it with
//     warp reductions and adds it to *out with one atomicAdd.
//   * A block's items and the run's first S rows are loaded before the table
//     is cleared and built, so their latency overlaps the build.
// What the compiler made of it (nvcc 12.8, -O3, sm_90a, `-Xptxas -v`): 37 /
// 40 registers (columns unaligned / aligned), no spills, 24,736 bytes of
// shared memory a block: 6 blocks of 256 threads an SM.
// wgmma does not apply to integer equality.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                     // rows a thread loads at once
constexpr int kSub = kThreads * kVec;       // R rows a table holds: 1024
constexpr int kSlotBits = 11;
constexpr int kSlots = 1 << kSlotBits;      // 2048: 16 KB of keys, 8 KB of sums
constexpr uint32_t kHashMul = 0x9E3779B1u;
constexpr int kItemsPerBlock = 8;
constexpr unsigned long long kOccupied = 1ull << 32;

__device__ __forceinline__ uint32_t slot_of(int32_t key) {
  return (static_cast<uint32_t>(key) * kHashMul) >> (32 - kSlotBits);
}

__device__ __forceinline__ unsigned long long tag_of(int32_t key) {
  return kOccupied | static_cast<uint32_t>(key);
}

// Four consecutive int32 from p: one 16-byte load where the columns are
// aligned, else four loads.
template <bool kAligned>
__device__ __forceinline__ int4 load4(const int32_t* p) {
  if constexpr (kAligned) {
    return *reinterpret_cast<const int4*>(p);
  } else {
    return make_int4(p[0], p[1], p[2], p[3]);
  }
}

__device__ __forceinline__ void insert(unsigned long long* keys,
                                       uint32_t* sums, int32_t key,
                                       int32_t pay) {
  const unsigned long long tag = tag_of(key);
  for (uint32_t s = slot_of(key);; s = (s + 1) & (kSlots - 1)) {
    const unsigned long long prev = atomicCAS(&keys[s], 0ull, tag);
    if (prev == 0ull || prev == tag) {
      atomicAdd(&sums[s], static_cast<uint32_t>(pay));
      return;
    }
  }
}

// The sum of the payloads of `key` in the table (0 if absent) times pay.
__device__ __forceinline__ uint32_t lookup(const unsigned long long* keys,
                                           const uint32_t* sums, int32_t key,
                                           int32_t pay) {
  const unsigned long long tag = tag_of(key);
  for (uint32_t s = slot_of(key);; s = (s + 1) & (kSlots - 1)) {
    const unsigned long long k = keys[s];
    if (k == tag) return sums[s] * static_cast<uint32_t>(pay);
    if (k == 0ull) return 0u;
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
probe_ranges_kernel(const int32_t* __restrict__ rk,
                    const int32_t* __restrict__ rp,
                    const int32_t* __restrict__ sk,
                    const int32_t* __restrict__ sp,
                    const int64_t* __restrict__ item_tile,
                    const int64_t* __restrict__ item_s0, int64_t n_items,
                    int64_t tile_r, int64_t tile_s,
                    uint32_t* __restrict__ out) {
  __shared__ __align__(16) unsigned long long keys[kSlots];
  __shared__ __align__(16) uint32_t sums[kSlots];
  __shared__ int64_t tiles[kItemsPerBlock], starts[kItemsPerBlock];
  __shared__ uint32_t warp_sum[kThreads / 32];
  const int tid = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kItemsPerBlock;
  const int n = static_cast<int>(min(static_cast<int64_t>(kItemsPerBlock),
                                     n_items - first));
  if (tid < n) {
    tiles[tid] = item_tile[first + tid];
    starts[tid] = item_s0[first + tid];
  }
  __syncthreads();

  uint32_t v = 0;
  const int64_t q0 = kVec * tid;   // a thread's first row in a sub-tile or chunk
  for (int i = 0; i < n;) {
    const int64_t tile = tiles[i];
    int end = i + 1;   // the items of this R tile in the block's run
    while (end < n && tiles[end] == tile) ++end;
    for (int64_t sub = 0; sub < tile_r; sub += kSub) {   // tile_r % kSub == 0
      const int64_t r = tile * tile_r + sub + q0;
      const int4 kk = load4<kAligned>(rk + r);
      const int4 pp = load4<kAligned>(rp + r);
      // the run's first S rows, loaded while the table is built
      // (tile_s % 128 == 0: a thread's four rows lie in the chunk or not)
      int4 sk4 = make_int4(0, 0, 0, 0), sp4 = sk4;
      if (q0 < tile_s) {
        sk4 = load4<kAligned>(sk + starts[i] + q0);
        sp4 = load4<kAligned>(sp + starts[i] + q0);
      }
      __syncthreads();   // every thread is done with the previous table
      for (int j = tid; j < kSlots / 2; j += kThreads) {
        reinterpret_cast<ulonglong2*>(keys)[j] = make_ulonglong2(0ull, 0ull);
      }
      for (int j = tid; j < kSlots / 4; j += kThreads) {
        reinterpret_cast<uint4*>(sums)[j] = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
      insert(keys, sums, kk.x, pp.x);
      insert(keys, sums, kk.y, pp.y);
      insert(keys, sums, kk.z, pp.z);
      insert(keys, sums, kk.w, pp.w);
      __syncthreads();
      for (int it = i; it < end; ++it) {
        for (int64_t q = q0; q < tile_s; q += kSub) {
          if (it != i || q != q0) {
            sk4 = load4<kAligned>(sk + starts[it] + q);
            sp4 = load4<kAligned>(sp + starts[it] + q);
          }
          v += lookup(keys, sums, sk4.x, sp4.x);
          v += lookup(keys, sums, sk4.y, sp4.y);
          v += lookup(keys, sums, sk4.z, sp4.z);
          v += lookup(keys, sums, sk4.w, sp4.w);
        }
      }
    }
    i = end;
  }

  v = __reduce_add_sync(0xffffffffu, v);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w];
    atomicAdd(out, s);
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for a tile_r that is not a multiple of 1024, a
// tile_s that is not a multiple of 128, or more blocks than a grid holds).
// Adds the sum to out[0] (a uint32 the caller zeroed). item_tile and item_s0
// are int64 [n_items], tile by tile.
extern "C" int tj_probe_aggregate_ranges(const void* rk, const void* rp,
                                         const void* sk, const void* sp,
                                         const void* item_tile,
                                         const void* item_s0, void* sum,
                                         int64_t n_items, int64_t tile_r,
                                         int64_t tile_s, void* stream) {
  if (n_items <= 0) return 0;
  const int64_t blocks = (n_items + kItemsPerBlock - 1) / kItemsPerBlock;
  if (tile_r <= 0 || tile_r % kSub != 0 || tile_s <= 0 || tile_s % 128 != 0 ||
      blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = ((reinterpret_cast<uintptr_t>(rk) |
                         reinterpret_cast<uintptr_t>(rp) |
                         reinterpret_cast<uintptr_t>(sk) |
                         reinterpret_cast<uintptr_t>(sp)) & 15) == 0;
  auto kernel = aligned ? probe_ranges_kernel<true> : probe_ranges_kernel<false>;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rk), static_cast<const int32_t*>(rp),
      static_cast<const int32_t*>(sk), static_cast<const int32_t*>(sp),
      static_cast<const int64_t*>(item_tile),
      static_cast<const int64_t*>(item_s0), n_items, tile_r, tile_s,
      static_cast<uint32_t*>(sum));
  return static_cast<int>(cudaGetLastError());
}
