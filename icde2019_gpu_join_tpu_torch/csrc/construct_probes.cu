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
// the kernel compiler. Here each probe runs on real blocks and is held
// against its plain version (benchmarks/construct_probes.py), and each kernel
// is built around the Hopper construct that stands for the TPU construct the
// reference's probe isolated, so that its time on an idle card says what that
// construct costs at its smallest scale:
//
//   min_dma, min_dma_compute  the Tensor Memory Accelerator. One thread
//       issues a 1-D bulk copy (cp.async.bulk) of a window or a part of it
//       into shared memory onto an mbarrier, the readers wait on the
//       barrier's phase, and the result leaves by a bulk store (bulk_group,
//       commit, wait): the counterpart of make_async_copy on DMA semaphores.
//       The kernels write the rows outside the windows themselves (zeros), so
//       a probe is one launch. min_dma_compute's merge runs on the ladders'
//       kernel below, a tile on a cluster of 8 CTAs, each staging its slice
//       of both windows by TMA and masking it on the way into registers.
//   concat_only  through registers, 16 bytes a thread, which measured faster
//       than its TMA form and than torch.cat.
//   lane_64, lane_16, lane_1, dirmask_stage  one stage is 2^13 independent
//       exchanges: spread over blocks, four a thread in 16-byte loads.
//   transpose_only  the padded-tile transpose, a [32, 32] sub-tile a block.
//   sublane_ladder, lane_ladder_T, concat_merge, full_merge_T, merge_T_dm
//       the pairs in registers (bitonic.cuh, second half): the stages on a
//       thread's slots in registers, those within a warp by __shfl_xor_sync,
//       and only layout changes through shared memory, which is what the
//       TPU's lane transpose becomes. A problem is cut into slices, one a
//       CTA (ladder_spec), each staging its operands' slices by TMA
//       (lane_ladder_T loads 16 bytes a thread instead). A ladder's first stage, when it
//       spans the whole problem, runs on the way in (element i against
//       i + n / 2). With more than one CTA the stages at distances of a
//       slice or more exchange through distributed shared memory in a
//       thread-block cluster, and the merges of 2^15 pairs form their
//       output, the keys' first half + the payloads' second half, from the
//       lower CTAs' keys on the upper CTAs. A CTA sends its slice to its
//       partner whole, by one bulk copy into the partner's shared memory onto
//       the partner's mbarrier, and reads what it received locally: element-
//       wise remote reads (map_shared_rank) were measured at 2-2.7 us a stage
//       and 5-24 us for the keys (PERF.md, section 6). One CTA holds at most
//       2^14 pairs, so a merge of 2^15 on one CTA would run its halves one
//       after the other. Every output leaves from shared memory by a bulk
//       store.
//
// What bounds them: every probe moves at most 2^15 pairs (256 KB) and runs at
// most 15 stages of 2^14 exchanges: below a microsecond of the card's memory
// or integer rate. A probe's time is a launch's latency plus the chain of its
// dependent steps: a copy's round trip, a stage's chain of register work
// (about 0.2 us a stage at 16 pairs a thread), a trip through shared memory,
// and a cross-CTA stage, whose push is bound by the rate of the network
// between SMs (1.0-1.4 us for 16-32 KB a CTA), not by a rate of the card.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kWindowRows = 64;                   // rows of a copy window
constexpr int kWindow = kWindowRows * kLanes;     // 8192 elements
constexpr int kWindowBytes = kWindow * 4;         // 32 KB
constexpr int kBlock = 2 * kWindow;               // a [128, 128] block
constexpr int kShuffles = 5;                      // a warp's lane bits

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// ---- the Tensor Memory Accelerator: bulk copies on an mbarrier --------------

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A barrier that completes its phase on one arrival and the bytes its
// arrival expects; the fences make its initialisation visible to the copy
// engine and to the cluster.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(shared_address(bar)), "r"(1) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The one arrival, expecting `bytes` of copies before the phase completes.
__device__ __forceinline__ void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(shared_address(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of `parity` (0 the first, 1 the second,
// ...) has completed.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity = 0) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(shared_address(bar)), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16, both sides 16-byte aligned) from device memory
// into shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(shared_address(dst)), "l"(src), "r"(bytes),
         "r"(shared_address(bar)) : "memory");
}

// Shared memory out to device memory in one bulk copy, waited for until the
// copy has read the shared memory (so that the CTA may leave or reuse it);
// its writes complete with the grid, as a TMA store epilogue's do. What the
// block's threads wrote there must be fenced for the copy engine
// (fence_for_copy) and synchronised before.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(shared_address(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void fence_for_copy() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` of this CTA's shared memory at `src` into CTA `rank` of the
// cluster at the same offset as `dst` is here, completed on that CTA's
// barrier at the offset of `bar`: a bulk copy over distributed shared memory
// by the copy engine, whose one request replaces a thread's element-wise
// remote reads. What the CTA's threads wrote to src must be fenced
// (fence_for_copy) and synchronised before.
__device__ __forceinline__ void bulk_push(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          int rank) {
  uint32_t remote_dst, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote_dst) : "r"(shared_address(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote_bar) : "r"(shared_address(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(remote_dst), "r"(shared_address(src)), "r"(bytes),
         "r"(remote_bar) : "memory");
}

// The cluster's barrier in two halves, so that the wait can come well after
// the arrival: every thread of every CTA arrives, then waits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Zero the rows of o [rows, 128] that lie in none of the `count` windows of
// 64 rows that start at starts[0], starts[stride], ...: 16-byte stores over
// the whole grid. No row of a window is touched, so the zeros never race
// with the windows' copies.
__device__ __forceinline__ void zero_outside(int32_t* o, int rows,
                                             const int32_t* starts, int count,
                                             int stride) {
  constexpr int kVecs = kLanes / 4;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < rows * kVecs;
       i += gridDim.x * blockDim.x) {
    const int r = i / kVecs;
    bool inside = false;
    for (int w = 0; w < count; ++w) {
      const int first = starts[w * stride];
      inside |= r >= first && r < first + kWindowRows;
    }
    if (!inside) reinterpret_cast<int4*>(o)[i] = make_int4(0, 0, 0, 0);
  }
}

// ---- the asynchronous copies ---------------------------------------------------

constexpr int kCopyThreads = 256;
// CTAs a window of min_dma: each copies 64 / kDmaParts rows by TMA (smaller
// copies in parallel finish sooner; the variants were measured, PERF.md)
constexpr int kDmaParts = 8;
constexpr int kDmaPartBytes = kWindowBytes / kDmaParts;

// Block b < 2 * kDmaParts copies part b % kDmaParts of the window of 64 rows
// at row meta[b / kDmaParts, 0] (meta int32 [2, 2]) by TMA: thread 0 issues a
// bulk copy into shared memory onto an mbarrier, waits on its phase and
// sends the part back out at the same rows by a bulk store, while every
// block's threads zero the rows outside both windows. Overlapping windows
// write the same values.
__global__ void __launch_bounds__(kCopyThreads)
min_dma_kernel(const int32_t* __restrict__ meta, const int32_t* __restrict__ x,
               int32_t* __restrict__ o, int rows) {
  __shared__ __align__(128) int32_t part[kDmaPartBytes / 4];
  __shared__ __align__(8) uint64_t full;
  const int w0 = meta[0];
  const int w1 = meta[2];
  if (w0 < 0 || w0 > rows - kWindowRows || w1 < 0 ||
      w1 > rows - kWindowRows) {
    __trap();
  }
  const bool copies = blockIdx.x < 2 * kDmaParts && threadIdx.x == 0;
  const int64_t at =
      static_cast<int64_t>(blockIdx.x < kDmaParts ? w0 : w1) * kLanes +
      (blockIdx.x % kDmaParts) * (kDmaPartBytes / 4);
  if (copies) {
    barrier_init(&full);
    barrier_expect(&full, kDmaPartBytes);
    bulk_load(part, x + at, kDmaPartBytes, &full);
  }
  zero_outside(o, rows, meta, 2, 2);
  if (copies) {
    barrier_wait(&full);
    fence_for_copy();
    bulk_store(o + at, part, kDmaPartBytes);
  }
}

// ---- the pairs in registers ------------------------------------------------------

// One stage on index bit j whose exchanges a layout holds in a thread's slots
// (register bit) or, with `lanes`, across a warp's lanes. With row_mask the
// direction is the parity of the lower element's row, bit 7 of its index:
// both elements share it except at j = 7 (distance 128), where the lower
// element's bit 7 is 0, so that stage ascends.
template <int E>
__device__ __forceinline__ void probe_stage(TjRegs<E>& v, const TjLayout& l,
                                            int j, bool lanes, bool row_mask) {
  if (!row_mask || j == 7) {
    tj_stages_here<E, TjSwapLess>(v, l, j, j, lanes, TjDirAscending{});
  } else {
    tj_stages_directed<E, TjSwapLess, true>(v, l, j, j, lanes, 0, 7);
  }
}

// The stages at index bits hi .. lo (falling) within a CTA's pairs, as
// tj_block_stages schedules them (bits from B + kShuffles up in groups of B
// on group layouts, one trip through `buffer` each, the rest on the
// contiguous layout in shuffles and registers), stage by stage so that the
// row parity can direct them. `l` is the layout the pairs are left in.
template <int E>
__device__ __forceinline__ void local_stages(TjRegs<E>& v, TjLayout& l, int hi,
                                             int lo, bool row_mask,
                                             int2* buffer) {
  constexpr int B = TjLog2<E>::value;
  const int t = threadIdx.x;
  while (hi >= lo && hi > B - 1 + kShuffles) {
    const int g = hi - B + 1;
    if (!tj_is_group(l, g)) {
      const TjLayout to = tj_layout_group<E>(t, g);
      tj_relayout(v, l, to, buffer);
      l = to;
    }
    for (int j = hi; j >= g && j >= lo; --j) probe_stage(v, l, j, false, row_mask);
    hi = g - 1;
  }
  if (hi < lo) return;
  if (!tj_is_group(l, 0)) {
    const TjLayout to = tj_layout_group<E>(t, 0);
    tj_relayout(v, l, to, buffer);
    l = to;
  }
  for (int j = hi; j >= lo; --j) probe_stage(v, l, j, true, row_mask);
}

// The layout a CTA loads in: the one that runs its first local stage, bit
// `hi`, with no trip (as tj_block_stages would choose it).
template <int E>
__device__ __forceinline__ TjLayout first_layout(int hi) {
  constexpr int B = TjLog2<E>::value;
  return tj_layout_group<E>(threadIdx.x,
                            hi > B - 1 + kShuffles ? hi - B + 1 : 0);
}

// o[index] = value(slot) for the pairs a layout holds: 16-byte stores where
// a thread's four slots are neighbours (s0 == 0), else 4-byte stores with a
// warp on 128 neighbouring bytes.
template <int E, typename Value>
__device__ __forceinline__ void store_values(const TjLayout& l, int32_t* o,
                                             Value value) {
  if (l.s0 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      *reinterpret_cast<int4*>(o + tj_index(l, 4 * q)) =
          make_int4(value(4 * q), value(4 * q + 1), value(4 * q + 2),
                    value(4 * q + 3));
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) o[tj_index(l, e)] = value(e);
  }
}

// ---- concatenation --------------------------------------------------------------

// o [128, 128] = a [64, 128] over b [64, 128], a thread a 16-byte vector
// through registers, no shared memory: faster than one TMA copy of each half
// in and one bulk store out, in every split into parts that was measured
// (PERF.md).
constexpr int kConcatThreads = 128;
__global__ void __launch_bounds__(kConcatThreads)
concat_registers_kernel(const int32_t* __restrict__ a,
                        const int32_t* __restrict__ b,
                        int32_t* __restrict__ o) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int32_t* from = i < kWindow ? a + i : b + (i - kWindow);
  *reinterpret_cast<int4*>(o + i) = *reinterpret_cast<const int4*>(from);
}

// ---- one stage -------------------------------------------------------------------

constexpr int kStageThreads = 128;

// One stage at distance d over the keys a and payloads b of a [128, 128]
// block, spread over blocks; o = key + payload. For d >= 4 a thread takes the
// four exchanges whose lower elements are neighbours: a 16-byte vector of
// keys and one of payloads at each side. For d < 4 it takes one vector of
// four elements and the exchanges inside it. With row_mask an exchange
// descends where its lower element's row is odd.
__global__ void __launch_bounds__(kStageThreads)
stage_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
             int32_t* __restrict__ o, int d, bool row_mask) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= 4) {
    const int lo = tj_stage_lo(4 * q, d);
    int4 ka = *reinterpret_cast<const int4*>(a + lo);
    int4 kb = *reinterpret_cast<const int4*>(a + lo + d);
    int4 pa = *reinterpret_cast<const int4*>(b + lo);
    int4 pb = *reinterpret_cast<const int4*>(b + lo + d);
    const bool desc = row_mask && ((lo >> 7) & 1);   // one row for all four
    TjSwapLess::regs(ka.x, pa.x, kb.x, pb.x, desc);
    TjSwapLess::regs(ka.y, pa.y, kb.y, pb.y, desc);
    TjSwapLess::regs(ka.z, pa.z, kb.z, pb.z, desc);
    TjSwapLess::regs(ka.w, pa.w, kb.w, pb.w, desc);
    *reinterpret_cast<int4*>(o + lo) =
        make_int4(wrap_add(ka.x, pa.x), wrap_add(ka.y, pa.y),
                  wrap_add(ka.z, pa.z), wrap_add(ka.w, pa.w));
    *reinterpret_cast<int4*>(o + lo + d) =
        make_int4(wrap_add(kb.x, pb.x), wrap_add(kb.y, pb.y),
                  wrap_add(kb.z, pb.z), wrap_add(kb.w, pb.w));
  } else {
    int4 k = *reinterpret_cast<const int4*>(a + 4 * q);
    int4 p = *reinterpret_cast<const int4*>(b + 4 * q);
    const bool desc = row_mask && (((4 * q) >> 7) & 1);
    if (d == 1) {
      TjSwapLess::regs(k.x, p.x, k.y, p.y, desc);
      TjSwapLess::regs(k.z, p.z, k.w, p.w, desc);
    } else {
      TjSwapLess::regs(k.x, p.x, k.z, p.z, desc);
      TjSwapLess::regs(k.y, p.y, k.w, p.w, desc);
    }
    *reinterpret_cast<int4*>(o + 4 * q) =
        make_int4(wrap_add(k.x, p.x), wrap_add(k.y, p.y),
                  wrap_add(k.z, p.z), wrap_add(k.w, p.w));
  }
}

// ---- the transposed layout ---------------------------------------------------------

constexpr int kSub = 32;                          // a sub-tile's side
constexpr int kSubThreads = 256;

// o = a.T.T + 1 for a [128, 128]: block s takes the [32, 32] sub-tile
// (s / 4, s % 4) into a padded tile (rows of 33 words: a column walk meets
// 32 banks), transposes it into a second padded tile and back, and writes it
// plus 1.
__global__ void __launch_bounds__(kSubThreads)
transpose_only_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ o) {
  __shared__ int32_t x[kSub][kSub + 1];
  __shared__ int32_t xt[kSub][kSub + 1];
  const int t = threadIdx.x;
  const int r = t / 8;                            // a row of 4 vectors
  const int c = (t % 8) * 4;
  const int64_t at = static_cast<int64_t>((blockIdx.x / 4) * kSub + r) * kLanes +
                     (blockIdx.x % 4) * kSub + c;
  const int4 in = *reinterpret_cast<const int4*>(a + at);
  x[r][c] = in.x; x[r][c + 1] = in.y; x[r][c + 2] = in.z; x[r][c + 3] = in.w;
  __syncthreads();
  // a warp takes one target row, so each read is a column walk of the source
#pragma unroll
  for (int k = 0; k < kSub * kSub / kSubThreads; ++k) {
    const int i = t + k * kSubThreads;
    xt[i / kSub][i % kSub] = x[i % kSub][i / kSub];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSub * kSub / kSubThreads; ++k) {
    const int i = t + k * kSubThreads;
    x[i / kSub][i % kSub] = xt[i % kSub][i / kSub];
  }
  __syncthreads();
  *reinterpret_cast<int4*>(o + at) =
      make_int4(wrap_add(x[r][c], 1), wrap_add(x[r][c + 1], 1),
                wrap_add(x[r][c + 2], 1), wrap_add(x[r][c + 3], 1));
}

// ---- the ladders: pairs in registers, slices in a cluster ------------------------

enum Ladder { kSublane, kLaneT, kConcatMerge, kFullMerge, kMergeDm, kMasked };

// What a ladder probe runs: log2 of a problem's pairs, its stages' bits
// (falling, hi .. lo), whether a stage's direction is the row parity, whether
// the keys are a over b and the payloads b over a (else keys a, payloads b),
// whether the output is the keys' first half + the payloads' second half
// (else key + payload), whether the pairs come from two masked windows
// (min_dma_compute), the problems a launch runs (concat_merge: one a window t
// of 64 rows of a and of b; min_dma_compute: one a tile), the pairs a thread
// holds at the least (more where a CTA's pairs would need more than 1024
// threads), and the CTAs a problem is cut into. Fewer pairs a thread shorten
// the chain of work a thread runs each stage and more threads hide its
// latency, but the group layouts then change every few stages. The pairs a
// thread (4, 8, 16) and the CTAs (1, 2, 4, 8; 16 for the rows' stages, which
// need no cluster) were measured on copies with these constants changed, and
// each ladder keeps its fastest (PERF.md).
struct LadderSpec {
  int log_n, hi, lo;
  bool row_mask, halves_in, halves_out, windows;
  int problems, pairs, ctas;
};

__host__ __device__ constexpr LadderSpec ladder_spec(Ladder p) {
  return p == kSublane ? LadderSpec{14, 13, 7, false, false, false, false, 1, 16, 8}
       : p == kLaneT   ? LadderSpec{14, 6, 0, false, false, false, false, 1, 4, 16}
       : p == kConcatMerge
                       ? LadderSpec{14, 13, 0, false, true, false, false, 2, 4, 8}
       : p == kFullMerge ? LadderSpec{15, 14, 0, false, true, true, false, 1, 16, 8}
       : p == kMergeDm ? LadderSpec{15, 14, 0, true, true, true, false, 1, 16, 8}
       // the lower half of the merge of two windows: its first stage, A[i]
       // against B[i], runs on the way in and leaves the halves independent
                       : LadderSpec{13, 12, 0, false, false, false, true, 2, 4, 8};
}

constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }

// A problem cut into C slices, one a CTA; a CTA holds at most 2^14 pairs at
// once, so a longer slice runs in passes (only the merges of 2^15 on one CTA,
// whose halves are independent once the first stage ran on the way in).
template <Ladder P>
struct Geometry {
  static constexpr LadderSpec kSpec = ladder_spec(P);
  static constexpr int C = kSpec.ctas;
  static constexpr int kN = 1 << kSpec.log_n;
  static constexpr int kSlice = kN / C;
  static constexpr int kHeld = kSlice < kBlock ? kSlice : kBlock;
  static constexpr int kPasses = kSlice / kHeld;
  static constexpr int kPairs = kSpec.pairs > kHeld / 1024 ? kSpec.pairs
                                                           : kHeld / 1024;
  static constexpr int kThreads = kHeld / kPairs;
  static constexpr int kLogSlice = log2_of(kSlice);
  static constexpr int kLogHeld = log2_of(kHeld);
  // the first stage, when it spans the problem, runs on the way in
  static constexpr bool kTopOnLoad = kSpec.hi == kSpec.log_n - 1 && !kSpec.windows;
  // the slices of the operands a CTA stages by TMA: a's and b's at its own
  // places, and at the partner places g ^ n / 2 where those lie in another
  // slice (the first stage of the sublane ladder); none for the rows'
  // ladder, whose 16-byte loads from device memory into the contiguous
  // layout measured faster than a bulk copy (PERF.md)
  static constexpr int kStaged =
      !kTopOnLoad && !kSpec.windows ? 0
      : kTopOnLoad && !kSpec.halves_in && C > 1 ? 4 : 2;
  // a staged slice's pairs: the halves' operands hold half a problem, so a
  // CTA that holds both halves stages n / 2 of each and reads them twice
  static constexpr int kStagedLen =
      kSpec.halves_in && kHeld > kN / 2 ? kN / 2 : kHeld;
  static constexpr int kAfterLoad = kTopOnLoad ? kSpec.hi - 1 : kSpec.hi;
  // the stages between slices (bits kAfterLoad .. kLogSlice, down to lo)
  static constexpr int kLowestCross = kLogSlice > kSpec.lo ? kLogSlice : kSpec.lo;
  static constexpr int kCross = kAfterLoad >= kLowestCross
                                    ? kAfterLoad - kLowestCross + 1 : 0;
  static constexpr bool kCluster = C > 1 && (kCross > 0 || kSpec.halves_out);
  // shared memory, in units of a CTA's pairs (8 bytes a pair): the exchange
  // buffer (the output's staging at the end), then a send buffer a cross
  // stage, then a receive buffer a cross stage, then, for the halves'
  // output, the lower half's keys (4 bytes a pair: kept from pass 0 on one
  // CTA, received on the upper CTAs)
  // The staged operands (4 bytes a pair each) lie over the exchange and the
  // send buffers, which no partner writes, so they are read before any
  // partner's copy may land.
  static constexpr int kBuffers = kHeld * 8 * (1 + 2 * kCross);
  static constexpr int kStagedBytes = kStaged * kStagedLen * 4;
  static constexpr int kSmem =
      (kBuffers > kStagedBytes ? kBuffers : kStagedBytes) +
      (kSpec.halves_out ? kHeld * 4 : 0);
  static_assert(kStagedBytes <= kHeld * 8 * (1 + kCross) || kCross == 0,
                "the staged operands stay clear of the receive buffers");
  static_assert(kPasses == 1 || (C == 1 && kAfterLoad < kLogHeld),
                "passes only where no stage after the first spans them");
  static_assert(kThreads >= 64 && kThreads <= 1024, "whole warps, one CTA");
  static_assert(kSmem <= 227 * 1024, "a CTA's shared memory");
};

// out[index] = keys[index] + payload for the pairs a layout holds, both in
// shared memory in index order: 16-byte accesses where a thread's four slots
// are neighbours.
template <int E>
__device__ __forceinline__ void store_key_sums(const TjLayout& l,
                                               const int32_t* keys,
                                               const TjRegs<E>& v,
                                               int32_t* out) {
  if (l.s0 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int i = tj_index(l, 4 * q);
      const int4 k = *reinterpret_cast<const int4*>(keys + i);
      *reinterpret_cast<int4*>(out + i) =
          make_int4(wrap_add(k.x, v.pay[4 * q]), wrap_add(k.y, v.pay[4 * q + 1]),
                    wrap_add(k.z, v.pay[4 * q + 2]),
                    wrap_add(k.w, v.pay[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      out[tj_index(l, e)] = wrap_add(keys[tj_index(l, e)], v.pay[e]);
    }
  }
}

// What the CTA's threads wrote to `staged` (shared memory) out to `dst` in
// device memory by one bulk store.
__device__ __forceinline__ void send_out(int32_t* dst, const int32_t* staged,
                                         int count) {
  fence_for_copy();
  __syncthreads();
  if (threadIdx.x == 0) bulk_store(dst, staged, count * 4);
}

template <Ladder P>
__global__ void __launch_bounds__(Geometry<P>::kThreads)
ladder_kernel(const int32_t* __restrict__ meta, const int32_t* __restrict__ a,
              const int32_t* __restrict__ b, int32_t* __restrict__ o,
              int rows) {
  using G = Geometry<P>;
  constexpr LadderSpec s = G::kSpec;
  constexpr int C = G::C;
  constexpr int E = G::kPairs;
  constexpr int h = G::kN / 2;
  extern __shared__ __align__(128) int2 pairs[];
  __shared__ __align__(8) uint64_t loaded;        // the staged operands
  // a cross stage's barriers, then the keys'
  __shared__ __align__(8) uint64_t received[G::kCross + 1];
  int2* exchange = pairs;
  int32_t* staged = reinterpret_cast<int32_t*>(pairs);
  int32_t* keys = reinterpret_cast<int32_t*>(pairs) + G::kSmem / 4 -
                  (s.halves_out ? G::kHeld : 0);
  const int rank = blockIdx.x % C;
  const int problem = blockIdx.x / C;
  // where a problem's operands lie and its output goes; min_dma_compute's
  // tile reads its two windows and output row from its column of meta
  // [7, problems] and zeroes the rows no tile writes
  const int32_t* in_a = a + static_cast<int64_t>(problem) * (s.halves_in ? h : G::kN);
  const int32_t* in_b = b + static_cast<int64_t>(problem) * (s.halves_in ? h : G::kN);
  int32_t* out = o + static_cast<int64_t>(problem) * (s.halves_out ? h : G::kN);
  int a_lo = 0, a_hi = 0, b_wlo = 0, b_whi = 0;
  if constexpr (s.windows) {
    constexpr int n = s.problems;
    const int a_row = meta[0 * n + problem];
    const int b_row = meta[1 * n + problem];
    a_lo = meta[2 * n + problem];
    a_hi = meta[3 * n + problem];
    b_wlo = meta[4 * n + problem];
    b_whi = meta[5 * n + problem];
    const int out_row = meta[6 * n + problem];
    if (a_row < 0 || a_row > rows - kWindowRows || b_row < 0 ||
        b_row > rows - kWindowRows || out_row < 0 ||
        out_row > rows - kWindowRows) {
      __trap();
    }
    in_a = a + static_cast<int64_t>(a_row) * kLanes;
    in_b = a + static_cast<int64_t>(b_row) * kLanes;
    out = o + static_cast<int64_t>(out_row) * kLanes;
  }
  if (threadIdx.x == 0) {
    barrier_init(&loaded);
    if constexpr (G::kCluster) {
      // the barriers the partners' copies complete on, initialised before
      // any CTA of the cluster passes cluster_wait
      for (int k = 0; k <= G::kCross; ++k) barrier_init(&received[k]);
    }
  }
  if constexpr (G::kCluster) cluster_arrive_relaxed();
  __syncthreads();   // `loaded` is initialised before anyone waits on it

  for (int pass = 0; pass < G::kPasses; ++pass) {
    const int first = rank * G::kSlice + pass * G::kHeld;
    const int local_hi = G::kAfterLoad < G::kLogSlice ? G::kAfterLoad
                                                      : G::kLogSlice - 1;
    // the operands' slices by TMA onto `loaded`, one bulk copy each (split
    // into 4 or 8 copies from as many threads they measured slower): the
    // windows' (and, for the halves, a's and b's) at the places i = g mod h
    // the CTA holds, else a's and b's at g, and at g ^ h where those lie
    // in another slice
    const int at = s.halves_in ? (first & (h - 1)) : first;
    if (pass > 0) {   // the last pass's readers are done with the staging
      fence_for_copy();
      __syncthreads();
    }
    constexpr int len = G::kStagedLen;
    if (threadIdx.x == 0 && G::kStaged > 0) {
      constexpr uint32_t kBytes = len * 4;
      barrier_expect(&loaded, G::kStaged * kBytes);
      bulk_load(staged, in_a + at, kBytes, &loaded);
      bulk_load(staged + len, in_b + at, kBytes, &loaded);
      if constexpr (G::kStaged == 4) {
        bulk_load(staged + 2 * len, in_a + (first ^ h), kBytes, &loaded);
        bulk_load(staged + 3 * len, in_b + (first ^ h), kBytes, &loaded);
      }
    }
    if constexpr (s.windows) zero_outside(o, rows, meta + 6 * s.problems, s.problems, 1);
    if constexpr (G::kStaged > 0) barrier_wait(&loaded, pass & 1);

    TjLayout l = first_layout<E>(local_hi);
    TjRegs<E> v;
    const int32_t* sa = staged;
    const int32_t* sb = staged + len;
    if constexpr (G::kTopOnLoad || s.windows) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int li = tj_index(l, e);
        const int g = first + li;
        if constexpr (s.windows) {
          // _mask_windows (merge_pallas.py:297) on the way in, then the
          // stage at distance 8192, A[g] against B[g], whose lower element
          // this CTA keeps
          const int32_t a_raw = sa[li];
          const int32_t b_raw = sb[li];
          int32_t x = g < a_lo ? INT_MIN : a_raw;
          x = g >= a_hi ? INT_MAX : x;
          int32_t y = g < b_wlo ? INT_MAX : ~b_raw;   // stored -> working
          y = g >= b_whi ? INT_MIN : y;
          const bool swap = y < x;
          v.key[e] = swap ? y : x;
          v.pay[e] = swap ? b_raw : a_raw;
        } else {
          // the stage at distance h, element g against g ^ h; its direction
          // (row parity) is bit 7, which both share
          const bool upper = (g & h) != 0;
          const bool desc = s.row_mask && ((g >> 7) & 1);
          if constexpr (s.halves_in) {
            // (x, y) at i against (y, x) at i + h
            const int32_t x = sa[li & (len - 1)];
            const int32_t y = sb[li & (len - 1)];
            const bool swap = (y < x) != desc;
            const bool keeps_x = swap == upper;
            v.key[e] = keeps_x ? x : y;
            v.pay[e] = keeps_x ? y : x;
          } else {
            const int other = G::kStaged == 4 ? li : li ^ h;
            const int32_t* oa = G::kStaged == 4 ? staged + 2 * len : sa;
            const int32_t* ob = G::kStaged == 4 ? staged + 3 * len : sb;
            const int32_t k0 = sa[li];
            const int32_t p0 = sb[li];
            const int32_t k1 = oa[other];
            const int32_t p1 = ob[other];
            const bool swap = ((upper ? k0 : k1) < (upper ? k1 : k0)) != desc;
            v.key[e] = swap ? k1 : k0;
            v.pay[e] = swap ? p1 : p0;
          }
        }
      }
    } else {
      tj_load_block(v, l, in_a + first, in_b + first,
                    [](int i) { return static_cast<int64_t>(i); });
    }
    __syncthreads();   // the staging is read before anything is written over it

    if constexpr (G::kCluster) cluster_wait();
    if constexpr (G::kCross > 0) {
      // slice r against slice r ^ (1 << (j - log slice)): each CTA writes
      // its pairs to its send buffer (swizzled, as a trip writes them) and
      // pushes the buffer whole into its partner's receive buffer, then
      // reads the partner's pairs at the places of its own: both CTAs hold
      // the same layout. Every buffer serves one stage, so no copy waits
      // for a reader. One push a stage: the exchange is bound by the rate
      // of the network between SMs, and pushing a round of stages to all
      // partners at once (3 pushes for 2 stages) measured slower (PERF.md).
      const int place = tj_swizzle<E>(l.tpart);
#pragma unroll
      for (int k = 0; k < G::kCross; ++k) {
        const int j = G::kAfterLoad - k;
        const int mask = 1 << (j - G::kLogSlice);
        int2* send = pairs + G::kHeld * (1 + k);
        int2* receive = pairs + G::kHeld * (1 + G::kCross + k);
        tj_regs_to_shared(v, l, send);
        fence_for_copy();
        __syncthreads();
        if (threadIdx.x == 0) {
          barrier_expect(&received[k], G::kHeld * 8);
          bulk_push(receive, send, G::kHeld * 8, &received[k], rank ^ mask);
        }
        barrier_wait(&received[k]);
        const bool is_hi = (rank & mask) != 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int2 q = receive[place ^ tj_slot_place<E>(l, e)];
          const bool desc = s.row_mask && ((tj_index(l, e) >> 7) & 1);
          const bool take = TjSwapLess::take(v.key[e], q.x, is_hi, desc);
          v.key[e] = take ? q.x : v.key[e];
          v.pay[e] = take ? q.y : v.pay[e];
        }
      }
      // every copy into this CTA has landed: the partners may leave once
      // their own have (the wait is the kernel's last step)
      if constexpr (!s.halves_out) cluster_arrive();
    }
    local_stages(v, l, local_hi, s.lo, s.row_mask, exchange);
    __syncthreads();   // the last trip's readers are done with `exchange`

    if constexpr (!s.halves_out) {
      store_values<E>(l, staged,
                   [&](int e) { return wrap_add(v.key[e], v.pay[e]); });
      send_out(out + first, staged, G::kHeld);
    } else if constexpr (C == 1) {
      // pass 0 holds the lower half, whose keys it keeps; pass 1 the upper
      // half, whose payloads it adds at the same places
      if (pass == 0) {
        store_values<E>(l, keys, [&](int e) { return v.key[e]; });
      } else {
        store_key_sums(l, keys, v, staged);
        send_out(out, staged, G::kHeld);
      }
    } else if (rank < C / 2) {
      // the lower CTAs push their keys, in index order, to the upper CTAs
      store_values<E>(l, staged, [&](int e) { return v.key[e]; });
      fence_for_copy();
      __syncthreads();
      if (threadIdx.x == 0) {
        bulk_push(keys, staged, G::kHeld * 4, &received[G::kCross],
                  rank + C / 2);
      }
      cluster_arrive();
    } else {
      if (threadIdx.x == 0) barrier_expect(&received[G::kCross], G::kHeld * 4);
      barrier_wait(&received[G::kCross]);
      cluster_arrive();
      store_key_sums(l, keys, v, staged);
      send_out(out + (rank - C / 2) * G::kSlice, staged, G::kHeld);
    }
  }
  // no CTA leaves while a copy out of its shared memory may be running
  if constexpr (G::kCluster) cluster_wait();
}

// Nothing: what a launch costs, the floor under every probe's time.
__global__ void __launch_bounds__(1024) empty_kernel(int32_t* o) { (void)o; }

// ---- the launcher -----------------------------------------------------------------

// Launch `kernel` on `stream`, as a cluster of `cluster` CTAs when that is
// more than 1, and return the launch's CUDA error. `prepared` is the kernel's
// one-time setting of its dynamic shared memory (above 48 KB it has to be
// asked for), made by the caller once per kernel. A refused launch (a
// cluster that cannot be placed, too much shared memory) is returned, never
// retried in another form.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), cudaError_t prepared, int blocks,
           int threads, int smem, int cluster, void* stream, Args... args) {
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return bytes > (48 << 10) ? cudaFuncSetAttribute(
                                  kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes)
                            : cudaSuccess;
}

template <Ladder P>
int launch_ladder(const void* a, const void* b, void* o, void* stream,
                  const void* meta = nullptr, int rows = 0) {
  using G = Geometry<P>;
  static const cudaError_t prepared = allow_smem(ladder_kernel<P>, G::kSmem);
  return launch(ladder_kernel<P>, prepared, G::kSpec.problems * G::C,
                G::kThreads, G::kSmem, G::kCluster ? G::C : 1, stream,
                static_cast<const int32_t*>(meta),
                static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
                static_cast<int32_t*>(o), rows);
}

// A ladder's form: its CTAs a problem, its cluster's size (1: none) and, for
// a cluster, cudaOccupancyMaxActiveClusters (else 0). Returns the CUDA error.
template <Ladder P>
int form_of(int* ctas, int* cluster, int* clusters) {
  using G = Geometry<P>;
  *ctas = G::C;
  *cluster = G::kCluster ? G::C : 1;
  *clusters = 0;
  if (!G::kCluster) return 0;
  static const cudaError_t prepared = allow_smem(ladder_kernel<P>, G::kSmem);
  if (prepared != cudaSuccess) return static_cast<int>(prepared);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(G::kSpec.problems * G::C);
  config.blockDim = dim3(G::kThreads);
  config.dynamicSmemBytes = G::kSmem;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = G::C;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, ladder_kernel<P>, &config));
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* out(void* p) { return static_cast<int32_t*>(p); }

int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace

// Every probe entry point has one signature: (meta, a, b, o, arg, stream),
// with null pointers and 0 where a probe takes no such operand. All launch on
// `stream`, do not synchronise, and return the CUDA error of the launch
// (cudaErrorInvalidValue for an argument the probe does not take). Shapes
// are the probes' own, and every array 16-byte aligned; the Python wrappers
// check both.

// meta int32 [2, 2], a = x int32 [arg, 128] -> o int32 [arg, 128], every row
// written: the windows' rows copied, the rest zero.
extern "C" int tj_probe_min_dma(const void* meta, const void* a, const void* b,
                                void* o, int64_t arg, void* stream) {
  (void)b;
  if (arg < kWindowRows || arg > INT32_MAX / kLanes) return invalid();
  const int rows = static_cast<int>(arg);
  const int vecs = rows * (kLanes / 4);
  const int blocks = std::max(2 * kDmaParts,
                              std::min(264, (vecs + 4 * kCopyThreads - 1) /
                                                (4 * kCopyThreads)));
  return launch(min_dma_kernel, cudaSuccess, blocks, kCopyThreads, 0, 1,
                stream, in(meta), in(a), out(o), rows);
}

// meta int32 [7, 2], a = x int32 [arg, 128] -> o int32 [arg, 128], every row
// written: the tiles' output rows, the rest zero.
extern "C" int tj_probe_min_dma_compute(const void* meta, const void* a,
                                        const void* b, void* o, int64_t arg,
                                        void* stream) {
  (void)b;
  if (arg < kWindowRows || arg > INT32_MAX / kLanes) return invalid();
  return launch_ladder<kMasked>(a, nullptr, o, stream, meta,
                                static_cast<int>(arg));
}

// a, b int32 [64, 128] -> o int32 [128, 128].
extern "C" int tj_probe_concat_only(const void* meta, const void* a,
                                    const void* b, void* o, int64_t arg,
                                    void* stream) {
  (void)meta; (void)arg;
  return launch(concat_registers_kernel, cudaSuccess,
                kBlock / 4 / kConcatThreads, kConcatThreads, 0, 1, stream,
                in(a), in(b), out(o));
}

// a, b int32 [128, 128] -> o int32 [256, 128].
extern "C" int tj_probe_concat_merge(const void* meta, const void* a,
                                     const void* b, void* o, int64_t arg,
                                     void* stream) {
  (void)meta; (void)arg;
  return launch_ladder<kConcatMerge>(a, b, o, stream);
}

// a, b int32 [128, 128] -> o int32 [128, 128]; arg = the distance, a power of
// two in [1, 2^13].
extern "C" int tj_probe_stage(const void* meta, const void* a, const void* b,
                              void* o, int64_t arg, void* stream) {
  (void)meta;
  if (arg < 1 || arg > kBlock / 2 || (arg & (arg - 1)) != 0) return invalid();
  const int threads = arg >= 4 ? kBlock / 8 : kBlock / 4;
  return launch(stage_kernel, cudaSuccess, threads / kStageThreads,
                kStageThreads, 0, 1, stream, in(a), in(b), out(o),
                static_cast<int>(arg), false);
}

// The remaining probes: a, b int32 [128, 128] -> o int32 [128, 128]
// (transpose_only takes a alone).
extern "C" int tj_probe_sublane_ladder(const void* meta, const void* a,
                                       const void* b, void* o, int64_t arg,
                                       void* stream) {
  (void)meta; (void)arg;
  return launch_ladder<kSublane>(a, b, o, stream);
}

extern "C" int tj_probe_dirmask_stage(const void* meta, const void* a,
                                      const void* b, void* o, int64_t arg,
                                      void* stream) {
  (void)meta; (void)arg;
  return launch(stage_kernel, cudaSuccess, kBlock / 8 / kStageThreads,
                kStageThreads, 0, 1, stream, in(a), in(b), out(o), kLanes,
                true);
}

extern "C" int tj_probe_transpose_only(const void* meta, const void* a,
                                       const void* b, void* o, int64_t arg,
                                       void* stream) {
  (void)meta; (void)b; (void)arg;
  return launch(transpose_only_kernel, cudaSuccess, kBlock / (kSub * kSub),
                kSubThreads, 0, 1, stream, in(a), out(o));
}

extern "C" int tj_probe_lane_ladder_T(const void* meta, const void* a,
                                      const void* b, void* o, int64_t arg,
                                      void* stream) {
  (void)meta; (void)arg;
  return launch_ladder<kLaneT>(a, b, o, stream);
}

extern "C" int tj_probe_full_merge_T(const void* meta, const void* a,
                                     const void* b, void* o, int64_t arg,
                                     void* stream) {
  (void)meta; (void)arg;
  return launch_ladder<kFullMerge>(a, b, o, stream);
}

extern "C" int tj_probe_merge_T_dm(const void* meta, const void* a,
                                   const void* b, void* o, int64_t arg,
                                   void* stream) {
  (void)meta; (void)arg;
  return launch_ladder<kMergeDm>(a, b, o, stream);
}

// No operand is read and o is not written: one block of 1024 threads with
// 128 KB of dynamic shared memory that returns at once, through the same
// launcher, so that its time is the part of any probe's time that is the
// launch.
extern "C" int tj_probe_empty(const void* meta, const void* a, const void* b,
                              void* o, int64_t arg, void* stream) {
  (void)meta; (void)a; (void)b; (void)arg;
  constexpr int kBytes = 2 * kBlock * 4;
  static const cudaError_t prepared = allow_smem(empty_kernel, kBytes);
  return launch(empty_kernel, prepared, 1, 1024, kBytes, 1, stream, out(o));
}

// The form of a probe that runs on the ladders' kernel (its name): its CTAs
// a problem into *ctas, its cluster's size (1: none) into *cluster and, for
// a cluster, cudaOccupancyMaxActiveClusters into *clusters (else 0). Returns
// the CUDA error, cudaErrorInvalidValue for another name.
extern "C" int tj_probe_form(const char* probe, int* ctas, int* cluster,
                             int* clusters) {
  if (std::strcmp(probe, "sublane_ladder") == 0) return form_of<kSublane>(ctas, cluster, clusters);
  if (std::strcmp(probe, "lane_ladder_T") == 0) return form_of<kLaneT>(ctas, cluster, clusters);
  if (std::strcmp(probe, "concat_merge") == 0) return form_of<kConcatMerge>(ctas, cluster, clusters);
  if (std::strcmp(probe, "full_merge_T") == 0) return form_of<kFullMerge>(ctas, cluster, clusters);
  if (std::strcmp(probe, "merge_T_dm") == 0) return form_of<kMergeDm>(ctas, cluster, clusters);
  if (std::strcmp(probe, "min_dma_compute") == 0) return form_of<kMasked>(ctas, cluster, clusters);
  return invalid();
}
