// merge.cu: the kernels of the merge-tree sort of (sortval, payload) pairs,
// for Hopper (sm_90a), with a plain C interface loaded through ctypes. All
// arrays are int32; n, run lengths and windows are powers of two.
//
// Run encoding (ops/merge.py): run r is stored sorted ascending by
// stored = actual ^ -(r & 1), so an odd run's actual keys descend in position
// and two neighbouring runs are one bitonic sequence.
//
//   tj_merge_levels      replaces merge_levels_vmem
//       (icde2019_gpu_join_tpu/ops/merge_pallas.py:206, kernel _vmem_kernel
//       :182): `levels` bitonic merge levels, runs of run_len -> runs of
//       run_len << levels, same encoding.
//   tj_merge_level_plan  replaces the planner of merge_level_hbm
//       (_merge_path_splits :240 and the meta table built at :470-528): per
//       output tile the exact merge-path split at its first and at its last
//       row, as the int32 [7, ntiles] table of ops/merge.py, merge_level_meta.
//   tj_merge_level_hbm   replaces merge_level_hbm (:442; kernels _hbm_kernel
//       :313 and _hbm_kernel_db :356): one merge-path level. Per output tile
//       the plan's column names two 128-aligned windows, one of each run of a
//       pair; the rows off the tile's diagonal are masked to -inf / +inf, the
//       2 * window elements merge in one bitonic merge, and the tile's rows
//       of the output run are written.
//
// tj_merge_levels. What it computes does not depend on the TPU's tile: every
// compared pair lies inside one output run and the parities come from the
// global row. What bounds it: 16 bytes moved per element (0.64 ms at n = 2^27
// at 3.35 TB/s) against SUM log2 stages of n / 2 exchanges (27 at run_len
// 4096, levels 2). With the block's pairs held in shared memory every stage
// was a full trip through it with a barrier (four loads and up to four stores
// an exchange), and that traffic, not the integer work, was what the time
// followed. So a block keeps its pairs in registers (bitonic.cuh, the second
// half): kLevelsPairs a thread, 2^14 pairs in a block of 1024 threads when
// the output run is that long. Shared memory is only the swizzled exchange
// buffer between two register layouts, 8 bytes a pair. The pairs arrive in
// the layout that runs the first level's first stages (a group layout: 4-byte
// loads, a warp on 128 neighbouring bytes; for runs of at most 256 the
// contiguous layout, 16-byte loads), decoded on the way (stored ^ -(input-run
// parity)). Each level is one tj_block_stages call: the stages on a layout's
// register bits run in registers, at most kLevelsShuffles of those on lane
// bits in shuffles, and one trip through the buffer changes layout: five
// trips at run_len 4096, levels 2 (group 9 -> group 5 -> contiguous; ->
// group 10 -> group 6 -> contiguous), 24 stages in registers and 3 in
// shuffles, where there were 27 trips. A shuffle stage costs more
// operations than a trip (two shuffles, three integer operations and two
// selects an element), so a level leaves only its last one or two lane bits
// to shuffles; all five, with one trip less, was 2.7% slower (same card).
// A level's direction bit, log2 of its output run, is an index bit of the
// block (a register, lane or thread bit of the layout) while the output run
// is shorter than the block, and the block's own parity at the last level of
// a block that is one output run. Every level ends in the contiguous layout,
// from which the pairs are re-encoded and stored in 16-byte vectors. An
// output run shorter than 2^12 does not fill a block's warps at 16 pairs a
// thread, so a block always takes 2^12 pairs or one output run, whichever is
// longer: several output runs side by side then, whose stages never meet (no
// stage runs on a bit at or above the run's length). n is a multiple of the
// output run, not of the block: the rows past n of the last block are
// neither loaded nor stored (whole runs, so the junk in their registers
// meets no real pair). What the time follows now: the trips and shuffles,
// the integer work (five operations an exchange in registers) and a block's
// loads and stores, which nothing overlaps, since one block of 2^14 pairs
// fills a multiprocessor's registers (1024 threads x 64). Measured beside it
// on an NVIDIA H100 80GB HBM3 at 700.00 W and deleted (PERF.md, section 6):
// 32 pairs a thread in 512 threads (one trip less, 2% slower), and blocks of
// 2^13 pairs, two a multiprocessor, in clusters of two that exchange the last
// level's first stage through distributed shared memory (3.15 ms beside 2.05:
// the remote reads cost more than the overlap gains).
//
// tj_merge_level_plan. On the TPU the planner is traced array code around the
// kernel; written as torch calls it is some fifteen small launches in each
// of up to 28 search rounds, milliseconds of host time a level with the card
// idle. Here one thread takes one output tile and runs the same upper-bound
// search at the tile's diagonal and at the next one's (the pair's end for a
// pair's last tile), all tiles side by side: one launch, a few reads of
// sorted data a thread, nothing read back by the host.
//
// tj_merge_level_hbm. What bounds it: 16 bytes per element (0.64 ms at 2^27)
// against log2(2 * window) stages over the 2 * window masked elements of
// every tile; held in shared memory, each stage is a full trip through it
// with a barrier, and that traffic was what the time followed. So a block
// keeps its tile in registers (bitonic.cuh), 512 threads at the two widest
// windows: 32 pairs a thread at window 8192, 16 at 4096 and below. The first
// stages fold into the load: a thread loads 16-byte vectors of both windows,
// masks them to the sentinels and exchanges A[i] with B[i] (d = window) and
// the next distances before anything is stored. The middle stages run in a
// group layout, the last ten (nine at 16 pairs a thread) in the contiguous
// layout on shuffles and registers: two trips through shared memory between
// the three layouts and one to line the valid rows up for the store, in
// place of fourteen. Shared memory is only that exchange buffer (2 * window
// pairs of 8 bytes, swizzled, no padding). The TPU grid runs in order: there
// every tile writes window - 128 rows, junk included, and a pair's last
// tile, which runs later, overwrites the +inf tail of the tile before it.
// Blocks run in no order, so a block writes only its valid rows,
// (a_hi - a_lo) + (b_whi - b_wlo) of them: window - 128 for every tile but
// the second to last of a pair. Then no two blocks write the same row and
// the output is the TPU's. One block a tile: the overlap of a tile's copies
// with another's stages comes from blocks that share a multiprocessor (two at
// window 4096; at 8192 the registers allow one). A resident grid whose blocks
// walk the tiles and prefetch the next tile's windows into L2 was measured
// beside it and came out 7-8% slower over the 13 levels of a 2^27 cascade at
// window 8192 and about 20% slower at 4096 (PERF.md); a second staging buffer
// for cp.async does not fit beside the exchange buffer at window 8192
// (2 * 128 KB).

#include <climits>
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kMaxBlockElems = 1 << 14;   // pairs a block holds: 128 KB

// ---- the in-block levels ---------------------------------------------------

constexpr int kLevelsPairs = 16;          // pairs a thread holds
constexpr int kLogMinLevelsBlock = 12;    // pairs a block holds at the least
constexpr int kLevelsShuffles = 2;        // stages a level runs in shuffles at the most

// `levels` merge levels over one block of 1 << log_block pairs: one output
// run, or several when they are shorter than a block.
template <int E>
__global__ void __launch_bounds__(kMaxBlockElems / E)
merge_levels_kernel(const int32_t* __restrict__ sv,
                    const int32_t* __restrict__ pv, int32_t* __restrict__ osv,
                    int32_t* __restrict__ opv, int64_t n, int log_run,
                    int levels, int log_block) {
  constexpr int B = TjLog2<E>::value;
  extern __shared__ __align__(16) int2 exchange[];
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) << log_block;

  // Load in the layout of the first level's first stages (tj_block_stages
  // then starts without a trip), stored -> actual by the input run's parity.
  // The block starts on an output run, so the parity is the index's own bit.
  TjLayout l = tj_layout_group<E>(
      t, log_run > B - 1 + kLevelsShuffles ? log_run - B + 1 : 0);
  TjRegs<E> v;
  if (l.s0 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int i = tj_index(l, 4 * q);
      int4 kk = make_int4(0, 0, 0, 0);
      int4 pp = kk;
      if (base + i < n) {   // n is a multiple of 256: a vector is in or out
        kk = *reinterpret_cast<const int4*>(sv + base + i);
        pp = *reinterpret_cast<const int4*>(pv + base + i);
      }
      const int32_t odd = -static_cast<int32_t>((i >> log_run) & 1);
      v.key[4 * q] = kk.x ^ odd; v.key[4 * q + 1] = kk.y ^ odd;
      v.key[4 * q + 2] = kk.z ^ odd; v.key[4 * q + 3] = kk.w ^ odd;
      v.pay[4 * q] = pp.x; v.pay[4 * q + 1] = pp.y;
      v.pay[4 * q + 2] = pp.z; v.pay[4 * q + 3] = pp.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = tj_index(l, e);
      const bool inside = base + i < n;
      const int32_t odd = -static_cast<int32_t>((i >> log_run) & 1);
      v.key[e] = (inside ? sv[base + i] : 0) ^ odd;
      v.pay[e] = inside ? pv[base + i] : 0;
    }
  }

  // Level by level: output runs of 1 << log_out, descending where bit
  // log_out of the global row is set. Inside the block that is an index bit;
  // at a level whose output run is the block it is the block's parity.
  for (int lv = 0; lv < levels; ++lv) {
    const int log_out = log_run + lv + 1;
    const int flat = static_cast<int>(base & (int64_t{1} << log_out));
    tj_block_stages<E, TjSwapLess, true, kLevelsShuffles>(
        v, l, log_out - 1, 0, flat, log_out, exchange);
  }

  // Every level ends in the contiguous layout: a thread's E neighbours lie
  // in one output run. actual -> stored by that run's parity.
  const int log_span = log_run + levels;
  const int span_bit = static_cast<int>(base & (int64_t{1} << log_span));
  const int32_t odd =
      -static_cast<int32_t>(((span_bit | l.tpart) >> log_span) & 1);
#pragma unroll
  for (int e = 0; e < E; ++e) v.key[e] ^= odd;
  if (base + l.tpart < n) {
    tj_store_block(v, l, osv, opv, [base](int i) { return base + i; });
  }
}

// ---- the merge-path plan ---------------------------------------------------

// The split of pair-local output offset o: the largest a in
// [max(0, o - run_len), min(o, run_len)] with A[a - 1] <= Bv[o - a], where
// A[i] = sv[abase + i] ascends and Bv[i] = ~sv[bbase + run_len - 1 - i] is
// the ascending view of the descending run (ops/merge.py,
// _merge_path_splits, one diagonal at a time).
__device__ __forceinline__ int64_t plan_split(const int32_t* __restrict__ sv,
                                              int64_t abase, int64_t bbase,
                                              int64_t run_len, int64_t o) {
  int64_t lo = o - run_len > 0 ? o - run_len : 0;
  int64_t hi = o < run_len ? o : run_len;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    const int32_t a_prev = mid >= 1 ? sv[abase + mid - 1] : INT32_MIN;
    const int64_t bj = o - mid;
    const int32_t b_at =
        bj < run_len ? ~sv[bbase + run_len - 1 - bj] : INT32_MAX;
    if (a_prev <= b_at) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ void merge_level_plan_kernel(const int32_t* __restrict__ sv,
                                        int32_t* __restrict__ meta,
                                        int64_t ntiles, int64_t run_len,
                                        int64_t window,
                                        int64_t tiles_per_pair) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= ntiles) return;
  const int64_t pair = 2 * run_len;
  const int64_t tile_out = window - 128;
  const int64_t p = t / tiles_per_pair;
  const int64_t j = t % tiles_per_pair;
  // ragged tail: a pair's last tile re-covers rows, so that every tile ends
  // tile_out rows after its start
  const int64_t last = pair - tile_out;
  const int64_t o = j * tile_out < last ? j * tile_out : last;
  const int64_t par = p & 1;
  const int64_t abase = p * pair + par * run_len;
  const int64_t bbase = p * pair + (1 - par) * run_len;
  const int64_t a = plan_split(sv, abase, bbase, run_len, o);
  const int64_t b = o - a;
  // exact ends: the split at the next tile's start; the runs' ends for the
  // last tile of a pair
  int64_t a_end = run_len;
  int64_t b_end = run_len;
  if (j + 1 < tiles_per_pair) {
    const int64_t o2 = (j + 1) * tile_out < last ? (j + 1) * tile_out : last;
    a_end = plan_split(sv, abase, bbase, run_len, o2);
    b_end = o2 - a_end;
  }
  const int64_t cap = run_len - window;
  const int64_t a0 = (a & ~int64_t{127}) < cap ? (a & ~int64_t{127}) : cap;
  const int64_t b0 = (b & ~int64_t{127}) < cap ? (b & ~int64_t{127}) : cap;
  meta[0 * ntiles + t] = static_cast<int32_t>((abase + a0) / 128);
  meta[1 * ntiles + t] =
      static_cast<int32_t>((bbase + run_len - b0 - window) / 128);
  meta[2 * ntiles + t] = static_cast<int32_t>(a - a0);
  meta[3 * ntiles + t] = static_cast<int32_t>(a_end - a0);
  meta[4 * ntiles + t] = static_cast<int32_t>(window - (b_end - b0));
  meta[5 * ntiles + t] = static_cast<int32_t>(window - (b - b0));
  meta[6 * ntiles + t] = static_cast<int32_t>((p * pair + o) / 128);
}

// ---- the merge-path level --------------------------------------------------

struct TilePlan {
  int64_t a0, b0, out0;
  int a_lo, a_hi, b_wlo, b_whi;
};

__device__ __forceinline__ TilePlan read_plan(const int32_t* __restrict__ meta,
                                              int64_t ntiles, int64_t t) {
  TilePlan c;
  c.a0 = static_cast<int64_t>(meta[0 * ntiles + t]) * 128;
  c.b0 = static_cast<int64_t>(meta[1 * ntiles + t]) * 128;
  c.a_lo = meta[2 * ntiles + t];
  c.a_hi = meta[3 * ntiles + t];
  c.b_wlo = meta[4 * ntiles + t];
  c.b_whi = meta[5 * ntiles + t];
  c.out0 = static_cast<int64_t>(meta[6 * ntiles + t]) * 128;
  return c;
}

// One output tile by one block of 2 * window / E threads; `buffer` is the
// exchange buffer, 2 * window pairs.
template <int E>
__device__ __forceinline__ void merge_tile(const TilePlan& c,
                                           const int32_t* __restrict__ sv,
                                           const int32_t* __restrict__ pv,
                                           int32_t* __restrict__ osv,
                                           int32_t* __restrict__ opv,
                                           int64_t n, int window, int log_m,
                                           int2* buffer) {
  constexpr int B = TjLog2<E>::value;
  const int t = threadIdx.x;
  // the merged -inf front, and the tile's valid rows after it
  const int front = c.a_lo + window - c.b_whi;
  const int count = (c.a_hi - c.a_lo) + (c.b_whi - c.b_wlo);
  // a plan that points outside the arrays is a fault of the planner: trap,
  // so that the next synchronisation raises, and never leave rows unwritten
  if (c.a0 < 0 || c.b0 < 0 || c.a0 + window > n || c.b0 + window > n ||
      front < 0 || count < 0 || front + count > 2 * window || c.out0 < 0 ||
      c.out0 + count > n) {
    __trap();
  }

  // Load, mask, and the stages on the top B - 2 bits (d = window first: A[i]
  // with B[i]). Element i < window is A[i], element window + i is B[i].
  TjRegs<E> v;
  TjLayout l = tj_layout_vec4<E>(t, log_m);
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    // the vectors' top register bit is the index's: the upper half is B
    const bool is_b = q >= E / 8;
    const int i = tj_index(l, 4 * q) & (window - 1);
    const int64_t o = (is_b ? c.b0 : c.a0) + i;
    const int4 kk = *reinterpret_cast<const int4*>(sv + o);
    const int4 pp = *reinterpret_cast<const int4*>(pv + o);
    const int32_t raw[4] = {kk.x, kk.y, kk.z, kk.w};
    const int32_t pay[4] = {pp.x, pp.y, pp.z, pp.w};
    // A ascends, stored == working. B is complement-encoded and descends in
    // working values: junk before its valid rows is larger, junk after them
    // smaller, so [A | B] stays bitonic
    const int first = is_b ? c.b_wlo : c.a_lo;
    const int end = is_b ? c.b_whi : c.a_hi;
    const int32_t before = is_b ? INT32_MAX : INT32_MIN;
    const int32_t after = is_b ? INT32_MIN : INT32_MAX;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int32_t key = is_b ? ~raw[u] : raw[u];
      if (i + u < first) key = before;
      if (i + u >= end) key = after;
      v.key[4 * q + u] = key;
      v.pay[4 * q + u] = pay[u];
    }
  }
  tj_stages_directed<E, TjSwapLess, false>(v, l, log_m - 1, log_m - B + 2,
                                           false, 0, 0);
  tj_block_stages<E, TjSwapLess, false>(v, l, log_m - B + 1, 0, 0, 0, buffer);

  // the valid rows, lined up through the exchange buffer
  __syncthreads();
  tj_regs_to_shared(v, l, buffer);
  __syncthreads();
  for (int i = t; i < count; i += blockDim.x) {
    const int2 pair = buffer[tj_swizzle<E>(front + i)];
    osv[c.out0 + i] = pair.x;
    opv[c.out0 + i] = pair.y;
  }
}

// One block a tile.
template <int E>
__global__ void __launch_bounds__(kMaxBlockElems / E)
merge_level_hbm_kernel(const int32_t* __restrict__ meta, int64_t ntiles,
                       const int32_t* __restrict__ sv,
                       const int32_t* __restrict__ pv,
                       int32_t* __restrict__ osv, int32_t* __restrict__ opv,
                       int64_t n, int window, int log_m) {
  extern __shared__ __align__(16) int2 exchange[];
  merge_tile<E>(read_plan(meta, ntiles, blockIdx.x), sv, pv, osv, opv, n,
                window, log_m, exchange);
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

template <int E>
int launch_tiles(const void* meta, const void* sv, const void* pv, void* osv,
                 void* opv, int64_t n, int64_t ntiles, int64_t window,
                 void* stream) {
  const auto kernel = merge_level_hbm_kernel<E>;
  const cudaError_t err = allow_block_memory(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(ntiles), static_cast<int>(2 * window / E),
           window * 4 * sizeof(int32_t), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(meta), ntiles,
      static_cast<const int32_t*>(sv), static_cast<const int32_t*>(pv),
      static_cast<int32_t*>(osv), static_cast<int32_t*>(opv), n,
      static_cast<int>(window), log2_of(2 * window));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All launch on `stream`, do not synchronise, and return the CUDA error of
// the launch (cudaErrorInvalidValue for shapes the kernel does not take).

// sv, pv -> osv, opv, int32 [n], 16-byte aligned: runs of run_len -> runs of
// run_len << levels (at most 2^14); n a multiple of the output run.
extern "C" int tj_merge_levels(const void* sv, const void* pv, void* osv,
                               void* opv, int64_t n, int64_t run_len,
                               int64_t levels, void* stream) {
  if (!is_pow2(run_len) || run_len < 128 || levels < 1 || levels > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t span = run_len << levels;
  if (span > kMaxBlockElems || n <= 0 || n % span != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const void* p : {sv, pv, static_cast<const void*>(osv),
                        static_cast<const void*>(opv)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int log_span = log2_of(span);
  const int log_block =
      log_span > kLogMinLevelsBlock ? log_span : kLogMinLevelsBlock;
  const int64_t blocks = (n + (int64_t{1} << log_block) - 1) >> log_block;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = merge_levels_kernel<kLevelsPairs>;
  const cudaError_t err = allow_block_memory(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned int>(blocks), (1 << log_block) / kLevelsPairs,
           (size_t{1} << log_block) * sizeof(int2),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sv), static_cast<const int32_t*>(pv),
      static_cast<int32_t*>(osv), static_cast<int32_t*>(opv), n,
      log2_of(run_len), static_cast<int>(levels), log_block);
  return static_cast<int>(cudaGetLastError());
}

// sv int32 [n] -> meta int32 [7, ntiles], ntiles = n / (2 * run_len) *
// ceil(2 * run_len / (window - 128)): the plan of one level.
extern "C" int tj_merge_level_plan(const void* sv, void* meta, int64_t n,
                                   int64_t run_len, int64_t window,
                                   int64_t ntiles, void* stream) {
  if (!is_pow2(run_len) || !is_pow2(window) || window < 256 ||
      run_len < window || n <= 0 || n % (2 * run_len) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tile_out = window - 128;
  const int64_t tiles_per_pair = (2 * run_len + tile_out - 1) / tile_out;
  if (ntiles != n / (2 * run_len) * tiles_per_pair || ntiles > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kPlanThreads = 128;
  merge_level_plan_kernel<<<
      static_cast<unsigned int>((ntiles + kPlanThreads - 1) / kPlanThreads),
      kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sv), static_cast<int32_t*>(meta), ntiles,
      run_len, window, tiles_per_pair);
  return static_cast<int>(cudaGetLastError());
}

// meta int32 [7, ntiles] (tj_merge_level_plan, or merge_level_meta of
// ops/merge.py); sv, pv -> osv, opv, int32 [n], 16-byte aligned; every tile's
// valid rows are written, nothing else.
extern "C" int tj_merge_level_hbm(const void* meta, const void* sv,
                                  const void* pv, void* osv, void* opv,
                                  int64_t n, int64_t ntiles, int64_t window,
                                  void* stream) {
  if (ntiles == 0) return 0;
  if (!is_pow2(window) || window < 256 || 2 * window > kMaxBlockElems ||
      n < 2 * window || ntiles < 0 || ntiles > INT32_MAX ||
      reinterpret_cast<uintptr_t>(sv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pv) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 512 threads a block at the two widest windows: 32 pairs a thread at
  // 8192, 16 below (at 4096 two blocks share a multiprocessor)
  if (window >= 8192) {
    return launch_tiles<32>(meta, sv, pv, osv, opv, n, ntiles, window,
                            stream);
  }
  return launch_tiles<16>(meta, sv, pv, osv, opv, n, ntiles, window, stream);
}
