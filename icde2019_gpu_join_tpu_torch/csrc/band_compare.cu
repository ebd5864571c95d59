// band_compare.cu: the banded probe's compare/select kernels, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
// Each replaces one TPU kernel of icde2019_gpu_join_tpu/ops/band_compare_pallas.py.
// All take one chunk of CH rows: S-side (or slot-side) arrays of [CH,128]
// int32 and R-side (window) arrays of [CH,WB] int32, row-major, contiguous.
// Sums are mod 2^32.
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
// Caller contract (as on the TPU): R columns outside an S block's window
// carry a key that matches nothing real and rp == 0.
//
// What bounds them on the card: CH*128*WB compared pairs against
// (CH*128*k + CH*WB*m)*4 bytes moved, i.e. 8 or more pairs per byte at
// W = 1: the operations a pair costs, not device memory.
//
// Kernels 1-3, one design: one thread block per chunk row i, one thread per S
// lane l holding its key in a register. The block stages the row's R-side
// columns through shared memory in tiles of kTile (for_each_r_tile), so any
// window width fits; every thread then reads each staged column as a
// broadcast: two shared-memory loads, a compare and one or two predicated
// operations a pair. Sums are uint32 (signed overflow is undefined in C++,
// unsigned wraps mod 2^32). Kernels 2 and 3 write one output per lane and
// need no reduction; kernel 1 reduces the block with warp shuffles and one
// atomicAdd (addition mod 2^32 commutes, so the order the atomics land in
// cannot change the sum). The TPU kernels' in-VMEM transposes and sublane
// loops have no counterpart here. wgmma does not apply to integer equality.
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

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;   // S rows per chunk row: one thread each
constexpr int kTile = 1024;   // R columns staged per pass: 4 KB per column

// Stages the kCols R-side columns cols[c][0, wb) of one chunk row through
// shared memory, kTile at a time, and after each tile calls visit(tile, n):
// every thread may then read tile[c][0, n) as broadcasts.
template <int kCols, typename Visit>
__device__ __forceinline__ void for_each_r_tile(
    const int32_t* const (&cols)[kCols], int64_t wb, Visit&& visit) {
  __shared__ __align__(16) int32_t tile[kCols][kTile];
  for (int64_t base = 0; base < wb; base += kTile) {
    const int n = static_cast<int>(wb - base < kTile ? wb - base : kTile);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = threadIdx.x; j < n; j += kLanes) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) tile[c][j] = cols[c][base + j];
    }
    __syncthreads();
    visit(tile, n);
  }
}

__global__ void __launch_bounds__(kLanes)
band_compare_sum_kernel(const int32_t* __restrict__ sk,
                        const int32_t* __restrict__ sp,
                        const int32_t* __restrict__ rk,
                        const int32_t* __restrict__ rp,
                        int64_t wb, uint32_t* __restrict__ out) {
  __shared__ uint32_t warp_sum[kLanes / 32];
  const int l = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int32_t key = sk[row * kLanes + l];
  const uint32_t pay = static_cast<uint32_t>(sp[row * kLanes + l]);
  const int32_t* const cols[2] = {rk + row * wb, rp + row * wb};

  uint32_t t = 0;  // SUM of the matched rp of this S lane, mod 2^32
  for_each_r_tile<2>(cols, wb, [&](const int32_t (*s)[kTile], int n) {
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      t += (s[0][j] == key) ? static_cast<uint32_t>(s[1][j]) : 0u;
    }
  });

  uint32_t v = t * pay;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if ((l & 31) == 0) warp_sum[l >> 5] = v;
  __syncthreads();
  if (l == 0) {
    uint32_t s = 0;
#pragma unroll
    for (int w = 0; w < kLanes / 32; ++w) s += warp_sum[w];
    atomicAdd(out, s);
  }
}

__global__ void __launch_bounds__(kLanes)
band_compare_per_s_kernel(const int32_t* __restrict__ sk,
                          const int32_t* __restrict__ rk,
                          const int32_t* __restrict__ rp, int64_t wb,
                          int32_t* __restrict__ h_out,
                          int32_t* __restrict__ t_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const int32_t key = sk[i];
  const int32_t* const cols[2] = {rk + blockIdx.x * wb, rp + blockIdx.x * wb};

  int32_t h = 0;
  uint32_t t = 0;
  for_each_r_tile<2>(cols, wb, [&](const int32_t (*s)[kTile], int n) {
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const bool eq = s[0][j] == key;
      h += eq;
      t += eq ? static_cast<uint32_t>(s[1][j]) : 0u;
    }
  });
  h_out[i] = h;
  t_out[i] = static_cast<int32_t>(t);
}

__global__ void __launch_bounds__(kLanes)
band_compare_first_kernel(const int32_t* __restrict__ sk,
                          const int32_t* __restrict__ rk,
                          const int32_t* __restrict__ gidx, int64_t wb,
                          int32_t* __restrict__ h_out,
                          int32_t* __restrict__ fm_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const int32_t key = sk[i];
  const int32_t* const cols[2] = {rk + blockIdx.x * wb, gidx + blockIdx.x * wb};

  int32_t h = 0;
  int32_t fm = INT32_MAX;
  for_each_r_tile<2>(cols, wb, [&](const int32_t (*s)[kTile], int n) {
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const bool eq = s[0][j] == key;
      h += eq;
      fm = eq ? min(fm, s[1][j]) : fm;
    }
  });
  h_out[i] = h;
  fm_out[i] = fm;
}

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

}  // namespace

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError(). ch is the number of chunk rows (one block each; the
// interval select one warp each), wb the width of the R-side arrays.

// Adds the chunk's sum to out[0] (a uint32 the caller zeroed).
extern "C" int tj_banded_compare_sum(const void* sk, const void* sp,
                                     const void* rk, const void* rp, void* sum,
                                     int64_t ch, int64_t wb, void* stream) {
  if (ch <= 0) return 0;
  band_compare_sum_kernel<<<static_cast<unsigned int>(ch), kLanes, 0,
                            as_stream(stream)>>>(
      in(sk), in(sp), in(rk), in(rp), wb, static_cast<uint32_t*>(sum));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tj_banded_compare_per_s(const void* sk, const void* rk,
                                       const void* rp, void* h, void* t,
                                       int64_t ch, int64_t wb, void* stream) {
  if (ch <= 0) return 0;
  band_compare_per_s_kernel<<<static_cast<unsigned int>(ch), kLanes, 0,
                              as_stream(stream)>>>(
      in(sk), in(rk), in(rp), wb, out(h), out(t));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tj_banded_compare_first(const void* sk, const void* rk,
                                       const void* gidx, void* h, void* fm,
                                       int64_t ch, int64_t wb, void* stream) {
  if (ch <= 0) return 0;
  band_compare_first_kernel<<<static_cast<unsigned int>(ch), kLanes, 0,
                              as_stream(stream)>>>(
      in(sk), in(rk), in(gidx), wb, out(h), out(fm));
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
