// band_compare.cu: the banded probe's compare/select kernels, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Each replaces one TPU kernel of icde2019_gpu_join_tpu/ops/band_compare_pallas.py.
// The chunk entry points take one chunk of CH rows: S-side (or slot-side)
// arrays of [CH,128] int32 and R-side (window) arrays of [CH,WB] int32,
// row-major, contiguous. Sums are mod 2^32.
//
//   tj_banded_compare_sum     (banded_compare_sum, :69, kernel :44)
//       *out += SUM_{i,l,j} [sk[i,l] == rk[i,j]] * sp[i,l] * rp[i,j]
//   tj_banded_compare_per_s   (banded_compare_per_s, :115, kernel :93)
//       h[i,l] = #{j : sk[i,l] == rk[i,j]},  t[i,l] = SUM of those rp[i,j]
//   tj_banded_compare_first   (banded_compare_first, :162, kernel :138)
//       h[i,l] as above,  fm[i,l] = MIN of those gidx[i,j] (INT32_MAX if none)
//   tj_banded_interval_select (banded_interval_select, :213, kernel :185)
//       o_k[i,l] = SUM of p_k[i,j] over j with lo[i,j] <= pos[i,l] < hi[i,j]
//
// The windowed entry points run kernels 1, 2 and 3 on the sorted, 128-padded
// block views themselves ([S blocks,128], [R blocks,128]) and a round's S
// block ids, so the probe gathers nothing (TPU: ops/band_join.py gathered
// each chunk into VMEM-sized arrays first). Chunk row i is S block ids[i]
// against R blocks lo[ids[i]] + r*w + k, k < w; a block at or past
// hi[ids[i]] is masked as the gathering caller masks it:
//
//   tj_banded_window_sum    *out += the chunk's banded_compare_sum; masked
//                           columns add nothing (their rp is 0)
//   tj_banded_window_per_s  h[ids[i]] += and t[ids[i]] += the chunk's
//                           banded_compare_per_s, where a masked column has
//                           key _R_PAD_SV and rp 0; so S pad rows (sortval
//                           INT32_MAX) count them in h, as before
//   tj_banded_window_first  h[ids[i]] += and fm[ids[i]] = min with the
//                           chunk's banded_compare_first, where a masked
//                           column has key _R_PAD_SV and gidx = (its block
//                           clamped to [0, R blocks)) * 128 + lane; so S pad
//                           rows (sortval INT32_MAX) count them, as before
//
// Caller contract (as on the TPU): R columns outside an S block's window
// carry a key that matches nothing real and rp == 0.
//
// What bounds them on the card: CH*128*WB compared pairs against
// (CH*128*k + CH*WB*m)*4 bytes moved, i.e. 8 or more pairs per byte at
// W = 1: the operations a pair costs, not device memory.
//
// Kernels 1, 2 and 3, one design, one body each (window_sum_kernel,
// window_per_s_kernel, window_first_kernel), reached by both entry points
// (the chunk ones with identity ids and full windows):
//   * a warp takes one chunk row and each thread four of its S rows (lane
//     slot 32 s + t, coalesced), so every staged R column serves four
//     pairs; a block is kWinRows warps on kWinRows rows, each staging its
//     own row's R blocks into its own part of shared memory, so the warps
//     meet at no block barrier (__syncwarp only);
//   * a warp loads its own S block and R window: each R block row is 512
//     contiguous bytes, copied global -> shared by 16-byte cp.async, one
//     warp-wide copy a row, kStageBlocks blocks a pass, then read back as
//     16-byte broadcasts, four columns a load. Hopper's 1-D bulk copy
//     (cp.async.bulk, a row a copy from one lane, completing on the warp's
//     mbarrier) was built too and ran 0-6% slower at every shape (on an
//     H100: windowed kernel 1 0.0493 against 0.0490 ms at (32768, 1),
//     0.0139 against 0.0136 at (7812, 1); the chunk entry 0.0516 against
//     0.0485), so it went;
//   * kernel 1 is a compare and a predicated add a pair (two integer
//     operations), then t * sp, a warp reduction and one atomicAdd a row
//     (addition mod 2^32 commutes, so the order cannot change the sum);
//     kernel 2 a compare, a count and an add a pair (three); kernel 3 a
//     compare, a count and a min a pair (three), plus one add a column for
//     the windowed gidx (blk * 128 + j, not staged); masked blocks are never
//     staged: kernels 2 and 3 add them to the S rows whose key is the
//     sentinel in one step;
//   * the grid is ceil(CH / kWinRows) blocks, so a small chunk still
//     spreads over every SM: at (7812, 1) 1953 blocks, 12 of which fit an
//     SM by registers, 1.23 waves on 132 SMs.
// What the compiler made of it (nvcc 12.8, -O3, sm_90a; `-Xptxas -v`,
// `cuobjdump -sass`): 40 / 40 / 42 registers for the windowed kernels 1 /
// 2 / 3, 36 / 34 / 34 for their chunk entries, no spills, 8 KB of shared
// memory a block (4 KB for the windowed kernel 3). Kernel 1's loop is ISETP +
// @P IMAD.IADD a pair: the compare on the INT32 pipe, the add on the FMA
// pipe. Kernel 3's is ISETP + @P VIADD + @P VIMNMX a pair and a VIADD a
// column. So the note's bound is the issue rate, 128 integer operations an
// SM a clock (utils/timing.int_ops_per_s), not the INT32 pipe's 64: at
// (32768, 1) the pairs' 2 and 3 operations need 0.0321 and 0.0481 ms on an
// H100, which kernels 1, 2 and 3 reach at 65%, 65% (the chunk entry: 75%)
// and 60%. Kernel 2 took 0.1403 ms there with a block a row and one S key
// a thread, two staged words a pair, the load pipe its limit.
// Sums are uint32 (signed overflow is undefined in C++, unsigned wraps mod
// 2^32). The TPU kernels' in-VMEM transposes and sublane loops have no
// counterpart here. wgmma does not apply to integer equality.
//
// Kernel 4, the interval select, has a design of its own. With one slot a
// thread and five staged columns (lo, hi, p1, p2, p3) a pair cost more than
// four warp-wide shared-memory loads (the compiler fetched four lo at a time
// and predicated the payloads' loads, which a warp still makes when one lane
// hits), and a multiprocessor serves one such load a clock: the load pipe,
// not the integer work, set the time. Now:
//   * a warp takes one chunk row and a thread four of its slots, so one
//     staged load serves four pairs; a block is four warps on four rows, each
//     staging its own row into its own part of shared memory, so the warps
//     meet at no block barrier (__syncwarp only);
//   * the test is one subtraction and one unsigned compare,
//     (uint32)(pos - lo) < len with len = hi > lo ? hi - lo : 0 computed once
//     when the row is staged. For lo <= hi that is lo <= pos < hi for every
//     int32 pos, lo, hi, by arithmetic mod 2^32; an inverted interval
//     (hi < lo) holds nothing, hence len = 0. lo and len lie side by side,
//     and one 16-byte load brings two columns;
//   * the payloads are staged too, 16 bytes a column, but read only under
//     `if (hit)`: on the caller's inputs a slot lies in one interval of its
//     row, so a warp takes the branch in about a quarter of its columns.
//     Every hit still adds: overlapping intervals give the sum, as the TPU
//     kernel's where + sum does.

#include <cassert>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;   // S rows per chunk row

// ---- kernels 1, 2 and 3 -----------------------------------------------------

constexpr int kWinRows = 4;             // chunk rows a block, one warp each
constexpr int kSlots = kLanes / 32;     // S rows a thread: 4
constexpr int kStageBlocks = 2;         // R blocks a warp stages per pass
constexpr int32_t kPadSv = INT32_MAX;   // sortval of the R-pad key -1

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Where chunk row `row` reads: its S block, the R block of window column
// block 0 (before clamping) and how many window blocks lie before hi.
struct Row {
  int64_t s;
  int64_t r0;
  int valid;
};

template <bool kWindowed>
__device__ __forceinline__ Row plan_row(int64_t row, const int64_t* ids,
                                        const int32_t* lo, const int32_t* hi,
                                        int64_t nsb, int64_t r, int w) {
  if constexpr (kWindowed) {
    const int64_t id = ids[row];
    assert(id >= 0 && id < nsb);   // an id out of range is the caller's fault
    const int64_t base = lo[id] + r * w;
    const int64_t left = hi[id] - base;
    return {id, base, static_cast<int>(left < 0 ? 0 : (left > w ? w : left))};
  } else {
    return {row, row * w, w};   // identity ids, full windows
  }
}

__device__ __forceinline__ int64_t clamp_block(int64_t b, int64_t nrb) {
  return b < 0 ? 0 : (b >= nrb ? nrb - 1 : b);
}

// Stages block rows blk[0, nb) of each of the kArrays arrays in src into
// tile[x][b][0, 128), for every lane of the warp to read: each lane copies
// 16 bytes of each row. The caller has made every lane done with the
// tile's previous contents (__syncwarp).
template <int kArrays>
__device__ __forceinline__ void stage_blocks(
    int32_t (*tile)[kStageBlocks][kLanes], const int32_t* const (&src)[kArrays],
    const int64_t (&blk)[kStageBlocks], int nb, int lane) {
#pragma unroll
  for (int b = 0; b < kStageBlocks; ++b) {
    if (b < nb) {
#pragma unroll
      for (int x = 0; x < kArrays; ++x) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(smem_addr(tile[x][b] + 4 * lane)),
                        "l"(src[x] + blk[b] * kLanes + 4 * lane)
                     : "memory");
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// One staged column against a thread's four S keys: a compare, then the
// add (and the min) under its predicate. Written in PTX because the C++
// `t += eq ? rp : 0` compiles to ISETP + SEL + half an IADD3 a pair, all on
// the INT32 pipe; the predicated add compiles to ISETP + @P IMAD.IADD,
// whose add issues on the FMA pipe, and kernel 3's to ISETP + @P VIADD +
// @P VIMNMX.
__device__ __forceinline__ void sum_column(const int32_t (&key)[kSlots],
                                           int32_t rk, int32_t rp,
                                           uint32_t (&t)[kSlots]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    asm("{\n.reg .pred p;\nsetp.eq.s32 p, %1, %2;\n"
        "@p add.u32 %0, %0, %3;\n}\n"
        : "+r"(t[s]) : "r"(key[s]), "r"(rk), "r"(rp));
  }
}

__device__ __forceinline__ void first_column(const int32_t (&key)[kSlots],
                                             int32_t rk, int32_t g,
                                             int32_t (&h)[kSlots],
                                             int32_t (&fm)[kSlots]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    asm("{\n.reg .pred p;\nsetp.eq.s32 p, %2, %3;\n"
        "@p add.s32 %0, %0, 1;\n@p min.s32 %1, %1, %4;\n}\n"
        : "+r"(h[s]), "+r"(fm[s]) : "r"(key[s]), "r"(rk), "r"(g));
  }
}

template <bool kWindowed>
__global__ void __launch_bounds__(kWinRows * 32)
window_sum_kernel(const int32_t* __restrict__ sk,
                  const int32_t* __restrict__ sp,
                  const int32_t* __restrict__ rk,
                  const int32_t* __restrict__ rp,
                  const int64_t* __restrict__ ids,
                  const int32_t* __restrict__ lo,
                  const int32_t* __restrict__ hi, int64_t n, int64_t nsb,
                  int64_t nrb, int64_t r, int w, uint32_t* __restrict__ out) {
  __shared__ __align__(128) int32_t tile[kWinRows][2][kStageBlocks][kLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWinRows + warp;
  if (row >= n) return;   // the whole warp; no block barrier follows
  const Row q = plan_row<kWindowed>(row, ids, lo, hi, nsb, r, w);
  if (q.valid == 0) return;   // masked columns add nothing

  int32_t key[kSlots];
  uint32_t t[kSlots];   // SUM of the matched rp of each S row, mod 2^32
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    key[s] = sk[q.s * kLanes + 32 * s + lane];
    t[s] = 0;
  }
  const int32_t* const src[2] = {rk, rp};
  for (int kb = 0; kb < q.valid; kb += kStageBlocks) {
    const int nb = min(kStageBlocks, q.valid - kb);
    int64_t blk[kStageBlocks];
#pragma unroll
    for (int b = 0; b < kStageBlocks; ++b) {
      blk[b] = clamp_block(q.r0 + kb + b, nrb);
    }
    __syncwarp();   // every lane is done with the previous pass
    stage_blocks<2>(tile[warp], src, blk, nb, lane);
    const int4* k4 = reinterpret_cast<const int4*>(tile[warp][0][0]);
    const int4* p4 = reinterpret_cast<const int4*>(tile[warp][1][0]);
#pragma unroll 4
    for (int j = 0; j < nb * (kLanes / 4); ++j) {
      const int4 kk = k4[j];
      const int4 pp = p4[j];
      sum_column(key, kk.x, pp.x, t);
      sum_column(key, kk.y, pp.y, t);
      sum_column(key, kk.z, pp.z, t);
      sum_column(key, kk.w, pp.w, t);
    }
  }
  uint32_t v = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    v += t[s] * static_cast<uint32_t>(sp[q.s * kLanes + 32 * s + lane]);
  }
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) atomicAdd(out, v);
}

// gx: the chunk entry's gidx array; the windowed entry computes gidx.
template <bool kWindowed>
__global__ void __launch_bounds__(kWinRows * 32)
window_first_kernel(const int32_t* __restrict__ sk,
                    const int32_t* __restrict__ rk,
                    const int32_t* __restrict__ gx,
                    const int64_t* __restrict__ ids,
                    const int32_t* __restrict__ lo,
                    const int32_t* __restrict__ hi, int64_t n, int64_t nsb,
                    int64_t nrb, int64_t r, int w, int32_t* __restrict__ h_out,
                    int32_t* __restrict__ fm_out) {
  constexpr int kArrays = kWindowed ? 1 : 2;
  __shared__ __align__(128) int32_t
      tile[kWinRows][kArrays][kStageBlocks][kLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWinRows + warp;
  if (row >= n) return;   // the whole warp; no block barrier follows
  const Row q = plan_row<kWindowed>(row, ids, lo, hi, nsb, r, w);

  int32_t key[kSlots], h[kSlots], fm[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    key[s] = sk[q.s * kLanes + 32 * s + lane];
    h[s] = 0;
    fm[s] = INT32_MAX;
  }
  const int32_t* src[kArrays];
  src[0] = rk;
  if constexpr (!kWindowed) src[1] = gx;
  for (int kb = 0; kb < q.valid; kb += kStageBlocks) {
    const int nb = min(kStageBlocks, q.valid - kb);
    int64_t blk[kStageBlocks];
#pragma unroll
    for (int b = 0; b < kStageBlocks; ++b) {
      blk[b] = clamp_block(q.r0 + kb + b, nrb);
    }
    __syncwarp();   // every lane is done with the previous pass
    stage_blocks<kArrays>(tile[warp], src, blk, nb, lane);
    if constexpr (kWindowed) {
      for (int b = 0; b < nb; ++b) {
        const int4* k4 = reinterpret_cast<const int4*>(tile[warp][0][b]);
        const int32_t g0 = static_cast<int32_t>(blk[b] * kLanes);
#pragma unroll 4
        for (int j = 0; j < kLanes / 4; ++j) {
          const int4 kk = k4[j];
          const int32_t g = g0 + 4 * j;
          first_column(key, kk.x, g, h, fm);
          first_column(key, kk.y, g + 1, h, fm);
          first_column(key, kk.z, g + 2, h, fm);
          first_column(key, kk.w, g + 3, h, fm);
        }
      }
    } else {
      const int4* k4 = reinterpret_cast<const int4*>(tile[warp][0][0]);
      const int4* g4 = reinterpret_cast<const int4*>(tile[warp][1][0]);
#pragma unroll 4
      for (int j = 0; j < nb * (kLanes / 4); ++j) {
        const int4 kk = k4[j];
        const int4 gg = g4[j];
        first_column(key, kk.x, gg.x, h, fm);
        first_column(key, kk.y, gg.y, h, fm);
        first_column(key, kk.z, gg.z, h, fm);
        first_column(key, kk.w, gg.w, h, fm);
      }
    }
  }
  if constexpr (kWindowed) {
    // masked blocks: 128 sentinel columns each, the least gidx that of the
    // first of them (clamping keeps block indices non-decreasing)
    const int masked = w - q.valid;
    if (masked > 0) {
      const int32_t g =
          static_cast<int32_t>(clamp_block(q.r0 + q.valid, nrb) * kLanes);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (key[s] == kPadSv) {
          h[s] += kLanes * masked;
          fm[s] = min(fm[s], g);
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t i = q.s * kLanes + 32 * s + lane;
    if constexpr (kWindowed) {   // ids are unique within a round
      h_out[i] += h[s];
      fm_out[i] = min(fm_out[i], fm[s]);
    } else {
      h_out[i] = h[s];
      fm_out[i] = fm[s];
    }
  }
}

// ---- kernel 2 ----------------------------------------------------------------

// One staged column against a thread's four S keys: a compare, then the
// count and the payload add under its predicate (ISETP + two predicated
// adds a pair, not `eq ? rp : 0`).
__device__ __forceinline__ void per_s_column(const int32_t (&key)[kSlots],
                                             int32_t rk, int32_t rp,
                                             uint32_t (&h)[kSlots],
                                             uint32_t (&t)[kSlots]) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    asm("{\n.reg .pred p;\nsetp.eq.s32 p, %2, %3;\n"
        "@p add.u32 %0, %0, 1;\n@p add.u32 %1, %1, %4;\n}\n"
        : "+r"(h[s]), "+r"(t[s]) : "r"(key[s]), "r"(rk), "r"(rp));
  }
}

template <bool kWindowed>
__global__ void __launch_bounds__(kWinRows * 32)
window_per_s_kernel(const int32_t* __restrict__ sk,
                    const int32_t* __restrict__ rk,
                    const int32_t* __restrict__ rp,
                    const int64_t* __restrict__ ids,
                    const int32_t* __restrict__ lo,
                    const int32_t* __restrict__ hi, int64_t n, int64_t nsb,
                    int64_t nrb, int64_t r, int w, int32_t* __restrict__ h_out,
                    int32_t* __restrict__ t_out) {
  __shared__ __align__(128) int32_t tile[kWinRows][2][kStageBlocks][kLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWinRows + warp;
  if (row >= n) return;   // the whole warp; no block barrier follows
  const Row q = plan_row<kWindowed>(row, ids, lo, hi, nsb, r, w);

  int32_t key[kSlots];
  uint32_t h[kSlots], t[kSlots];   // counts and payload sums, mod 2^32
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    key[s] = sk[q.s * kLanes + 32 * s + lane];
    h[s] = t[s] = 0;
  }
  const int32_t* const src[2] = {rk, rp};
  for (int kb = 0; kb < q.valid; kb += kStageBlocks) {
    const int nb = min(kStageBlocks, q.valid - kb);
    int64_t blk[kStageBlocks];
#pragma unroll
    for (int b = 0; b < kStageBlocks; ++b) {
      blk[b] = clamp_block(q.r0 + kb + b, nrb);
    }
    __syncwarp();   // every lane is done with the previous pass
    stage_blocks<2>(tile[warp], src, blk, nb, lane);
    const int4* k4 = reinterpret_cast<const int4*>(tile[warp][0][0]);
    const int4* p4 = reinterpret_cast<const int4*>(tile[warp][1][0]);
#pragma unroll 4
    for (int j = 0; j < nb * (kLanes / 4); ++j) {
      const int4 kk = k4[j];
      const int4 pp = p4[j];
      per_s_column(key, kk.x, pp.x, h, t);
      per_s_column(key, kk.y, pp.y, h, t);
      per_s_column(key, kk.z, pp.z, h, t);
      per_s_column(key, kk.w, pp.w, h, t);
    }
  }
  if constexpr (kWindowed) {
    // masked blocks: 128 sentinel columns each, rp 0, never staged
    const int masked = w - q.valid;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (masked > 0 && key[s] == kPadSv) h[s] += kLanes * masked;
    }
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t i = q.s * kLanes + 32 * s + lane;
    if constexpr (kWindowed) {   // ids are unique within a round
      h_out[i] = static_cast<int32_t>(static_cast<uint32_t>(h_out[i]) + h[s]);
      t_out[i] = static_cast<int32_t>(static_cast<uint32_t>(t_out[i]) + t[s]);
    } else {
      h_out[i] = static_cast<int32_t>(h[s]);
      t_out[i] = static_cast<int32_t>(t[s]);
    }
  }
}

// ---- kernel 4 ----------------------------------------------------------------

constexpr int kSelRows = 4;     // chunk rows a block takes, one warp each
constexpr int kSelSlots = kLanes / 32;   // slots a thread holds: 4
constexpr int kSelTile = 256;   // window columns a warp stages per pass

// One staged column against a thread's slots: every slot the interval holds
// adds the column's payloads.
__device__ __forceinline__ void select_column(
    const int32_t (&p)[kSelSlots], int32_t lo, int32_t len, const int4* pay,
    uint32_t (&a)[kSelSlots], uint32_t (&b)[kSelSlots],
    uint32_t (&c)[kSelSlots]) {
  bool hit[kSelSlots];
  bool any = false;
#pragma unroll
  for (int s = 0; s < kSelSlots; ++s) {
    hit[s] = static_cast<uint32_t>(p[s]) - static_cast<uint32_t>(lo) <
             static_cast<uint32_t>(len);
    any |= hit[s];
  }
  if (any) {
    const int4 q = *pay;
#pragma unroll
    for (int s = 0; s < kSelSlots; ++s) {
      a[s] += hit[s] ? static_cast<uint32_t>(q.x) : 0u;
      b[s] += hit[s] ? static_cast<uint32_t>(q.y) : 0u;
      c[s] += hit[s] ? static_cast<uint32_t>(q.z) : 0u;
    }
  }
}

__global__ void __launch_bounds__(kSelRows * 32)
band_interval_select_kernel(const int32_t* __restrict__ pos,
                            const int32_t* __restrict__ lo,
                            const int32_t* __restrict__ hi,
                            const int32_t* __restrict__ p1,
                            const int32_t* __restrict__ p2,
                            const int32_t* __restrict__ p3, int64_t ch,
                            int64_t wb, int32_t* __restrict__ o1,
                            int32_t* __restrict__ o2,
                            int32_t* __restrict__ o3) {
  // per warp: (lo, len) of each staged column, and its three payloads
  __shared__ __align__(16) int2 span[kSelRows][kSelTile];
  __shared__ __align__(16) int4 pays[kSelRows][kSelTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kSelRows + warp;
  if (row >= ch) return;   // the whole warp; no block barrier follows
  int2* const my_span = span[warp];
  int4* const my_pays = pays[warp];

  // slot s of lane t is lane slot 32 s + t of the row: coalesced both ways
  int32_t p[kSelSlots];
  uint32_t a[kSelSlots], b[kSelSlots], c[kSelSlots];
#pragma unroll
  for (int s = 0; s < kSelSlots; ++s) {
    p[s] = pos[row * kLanes + 32 * s + lane];
    a[s] = b[s] = c[s] = 0;
  }

  const int64_t r = row * wb;
  for (int64_t base = 0; base < wb; base += kSelTile) {
    const int n = static_cast<int>(wb - base < kSelTile ? wb - base : kSelTile);
    const int n2 = (n + 1) & ~1;   // two columns a load: an odd tail is padded
    __syncwarp();   // every lane is done with the previous tile
    for (int j = lane; j < n2; j += 32) {
      if (j < n) {
        const int64_t g = r + base + j;
        const int32_t l = lo[g];
        const int32_t h = hi[g];
        const uint32_t len =
            h > l ? static_cast<uint32_t>(h) - static_cast<uint32_t>(l) : 0u;
        my_span[j] = make_int2(l, static_cast<int32_t>(len));
        my_pays[j] = make_int4(p1[g], p2[g], p3[g], 0);
      } else {
        my_span[j] = make_int2(0, 0);   // holds nothing
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < n2; j += 2) {
      const int4 two = *reinterpret_cast<const int4*>(my_span + j);
      select_column(p, two.x, two.y, my_pays + j, a, b, c);
      select_column(p, two.z, two.w, my_pays + j + 1, a, b, c);
    }
  }
#pragma unroll
  for (int s = 0; s < kSelSlots; ++s) {
    const int64_t i = row * kLanes + 32 * s + lane;
    o1[i] = static_cast<int32_t>(a[s]);
    o2[i] = static_cast<int32_t>(b[s]);
    o3[i] = static_cast<int32_t>(c[s]);
  }
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* out(void* p) { return static_cast<int32_t*>(p); }
cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }
unsigned int win_grid(int64_t n) {
  return static_cast<unsigned int>((n + kWinRows - 1) / kWinRows);
}

}  // namespace

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError(). ch is the number of chunk rows (one warp each), wb
// the width of the R-side arrays (kernels 1, 2 and 3: a multiple of 128, the
// wrappers check it). The caller checks dtypes, shapes and the 16-byte
// alignment of every [*, 128] array.

// Adds the chunk's sum to out[0] (a uint32 the caller zeroed).
extern "C" int tj_banded_compare_sum(const void* sk, const void* sp,
                                     const void* rk, const void* rp, void* sum,
                                     int64_t ch, int64_t wb, void* stream) {
  if (ch <= 0) return 0;
  window_sum_kernel<false><<<win_grid(ch), kWinRows * 32, 0,
                             as_stream(stream)>>>(
      in(sk), in(sp), in(rk), in(rp), nullptr, nullptr, nullptr, ch, ch,
      ch * (wb / kLanes), 0, static_cast<int>(wb / kLanes),
      static_cast<uint32_t*>(sum));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tj_banded_compare_per_s(const void* sk, const void* rk,
                                       const void* rp, void* h, void* t,
                                       int64_t ch, int64_t wb, void* stream) {
  if (ch <= 0) return 0;
  window_per_s_kernel<false><<<win_grid(ch), kWinRows * 32, 0,
                               as_stream(stream)>>>(
      in(sk), in(rk), in(rp), nullptr, nullptr, nullptr, ch, ch,
      ch * (wb / kLanes), 0, static_cast<int>(wb / kLanes), out(h), out(t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tj_banded_compare_first(const void* sk, const void* rk,
                                       const void* gidx, void* h, void* fm,
                                       int64_t ch, int64_t wb, void* stream) {
  if (ch <= 0) return 0;
  window_first_kernel<false><<<win_grid(ch), kWinRows * 32, 0,
                               as_stream(stream)>>>(
      in(sk), in(rk), in(gidx), nullptr, nullptr, nullptr, ch, ch,
      ch * (wb / kLanes), 0, static_cast<int>(wb / kLanes), out(h), out(fm));
  return static_cast<int>(cudaGetLastError());
}

// The windowed entry points: n chunk rows (ids[0, n), int64), nsb S blocks
// (s_* [nsb, 128], lo and hi [nsb] int32), nrb R blocks (r_* [nrb, 128]),
// round r, width w. The sum adds into sum[0] (a uint32 the caller zeroed
// once for all its rounds); "per_s" updates h and t, "first" h and fm
// ([nsb, 128]) at the ids, which must be unique within a call.
extern "C" int tj_banded_window_sum(const void* s_svb, const void* s_payb,
                                    const void* r_svb, const void* r_payb,
                                    const void* ids, const void* lo,
                                    const void* hi, void* sum, int64_t n,
                                    int64_t nsb, int64_t nrb, int64_t r,
                                    int64_t w, void* stream) {
  if (n <= 0) return 0;
  window_sum_kernel<true><<<win_grid(n), kWinRows * 32, 0,
                            as_stream(stream)>>>(
      in(s_svb), in(s_payb), in(r_svb), in(r_payb),
      static_cast<const int64_t*>(ids), in(lo), in(hi), n, nsb, nrb, r,
      static_cast<int>(w), static_cast<uint32_t*>(sum));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tj_banded_window_first(const void* s_svb, const void* r_svb,
                                      const void* ids, const void* lo,
                                      const void* hi, void* h, void* fm,
                                      int64_t n, int64_t nsb, int64_t nrb,
                                      int64_t r, int64_t w, void* stream) {
  if (n <= 0) return 0;
  window_first_kernel<true><<<win_grid(n), kWinRows * 32, 0,
                              as_stream(stream)>>>(
      in(s_svb), in(r_svb), nullptr, static_cast<const int64_t*>(ids), in(lo),
      in(hi), n, nsb, nrb, r, static_cast<int>(w), out(h), out(fm));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tj_banded_window_per_s(const void* s_svb, const void* r_svb,
                                      const void* r_payb, const void* ids,
                                      const void* lo, const void* hi, void* h,
                                      void* t, int64_t n, int64_t nsb,
                                      int64_t nrb, int64_t r, int64_t w,
                                      void* stream) {
  if (n <= 0) return 0;
  window_per_s_kernel<true><<<win_grid(n), kWinRows * 32, 0,
                              as_stream(stream)>>>(
      in(s_svb), in(r_svb), in(r_payb), static_cast<const int64_t*>(ids),
      in(lo), in(hi), n, nsb, nrb, r, static_cast<int>(w), out(h), out(t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tj_banded_interval_select(const void* pos, const void* lo,
                                         const void* hi, const void* p1,
                                         const void* p2, const void* p3,
                                         void* o1, void* o2, void* o3,
                                         int64_t ch, int64_t wb, void* stream) {
  if (ch <= 0) return 0;
  band_interval_select_kernel<<<
      static_cast<unsigned int>((ch + kSelRows - 1) / kSelRows), kSelRows * 32,
      0, as_stream(stream)>>>(in(pos), in(lo), in(hi), in(p1), in(p2), in(p3),
                              ch, wb, out(o1), out(o2), out(o3));
  return static_cast<int>(cudaGetLastError());
}
