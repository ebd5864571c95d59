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
// What bounds them on the card: CH*128*WB compares against
// (CH*128*k + CH*WB*m)*4 bytes moved, i.e. 8 or more compares per byte at
// W = 1. Each compare costs a shared-memory broadcast load, a compare and a
// select-add, so the kernels are bound by integer issue, not device memory.
//
// Design, deliberately simple and shared by all four: one thread block per
// chunk row i, one thread per S lane l holding its key (or slot) in a
// register. The block stages the row's R-side columns through shared memory
// in tiles of kTile (for_each_r_tile), so any window width fits; every thread
// then reads each staged column as a broadcast. Sums are uint32 (signed
// overflow is undefined in C++, unsigned wraps mod 2^32). Kernels 2-4 write
// one output per lane and need no reduction; kernel 1 reduces the block with
// warp shuffles and one atomicAdd (addition mod 2^32 commutes, so the order
// the atomics land in cannot change the sum). The TPU kernels' in-VMEM
// transposes and sublane loops have no counterpart here. wgmma does not apply
// to integer equality; TMA staging, fusing the R-block gather and several
// rows per block are later work.

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

__global__ void __launch_bounds__(kLanes)
band_interval_select_kernel(const int32_t* __restrict__ pos,
                            const int32_t* __restrict__ lo,
                            const int32_t* __restrict__ hi,
                            const int32_t* __restrict__ p1,
                            const int32_t* __restrict__ p2,
                            const int32_t* __restrict__ p3, int64_t wb,
                            int32_t* __restrict__ o1,
                            int32_t* __restrict__ o2,
                            int32_t* __restrict__ o3) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kLanes + threadIdx.x;
  const int32_t p = pos[i];
  const int64_t r = blockIdx.x * wb;
  const int32_t* const cols[5] = {lo + r, hi + r, p1 + r, p2 + r, p3 + r};

  uint32_t a = 0, b = 0, c = 0;
  for_each_r_tile<5>(cols, wb, [&](const int32_t (*s)[kTile], int n) {
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const bool in = s[0][j] <= p && p < s[1][j];
      a += in ? static_cast<uint32_t>(s[2][j]) : 0u;
      b += in ? static_cast<uint32_t>(s[3][j]) : 0u;
      c += in ? static_cast<uint32_t>(s[4][j]) : 0u;
    }
  });
  o1[i] = static_cast<int32_t>(a);
  o2[i] = static_cast<int32_t>(b);
  o3[i] = static_cast<int32_t>(c);
}

const int32_t* in(const void* p) { return static_cast<const int32_t*>(p); }
int32_t* out(void* p) { return static_cast<int32_t*>(p); }
cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError(). ch is the number of chunk rows (one block each), wb the
// width of the R-side arrays.

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
  band_interval_select_kernel<<<static_cast<unsigned int>(ch), kLanes, 0,
                                as_stream(stream)>>>(
      in(pos), in(lo), in(hi), in(p1), in(p2), in(p3), wb, out(o1), out(o2),
      out(o3));
  return static_cast<int>(cudaGetLastError());
}
