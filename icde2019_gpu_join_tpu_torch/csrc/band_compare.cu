// band_compare.cu: the banded probe's fused compare x multiply x sum, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// Replaces the TPU kernel _compare_sum_kernel
// (icde2019_gpu_join_tpu/ops/band_compare_pallas.py:44, launched by
// banded_compare_sum at :69). For one chunk of CH S blocks it adds to *out
//
//     SUM_{i,l,j} [sk[i,l] == rk[i,j]] * sp[i,l] * rp[i,j]     (mod 2^32)
//
// with sk, sp [CH,128] and rk, rp [CH,WB] int32, WB = window_blocks * 128,
// all row-major and contiguous. Caller contract (as on the TPU): R columns
// outside an S block's window carry rp == 0, and pad rows carry a sentinel
// key with payload 0, so neither adds anything.
//
// What bounds it on the card: CH*128*WB compares against
// (CH*128*2 + CH*WB*2)*4 bytes read, i.e. 8 compares per byte at W = 1 and
// more for wider windows. Each compare costs a shared-memory broadcast load,
// a compare and a select-add, so the kernel is bound by integer issue, not
// by device memory.
//
// Design, deliberately simple: one thread block per chunk row i, one thread
// per S lane l holding sk[i,l] and sp[i,l] in registers. The block stages
// rk[i,:] and rp[i,:] through shared memory in tiles of kTile columns, so any
// window width fits; every thread then reads each staged column as a
// broadcast. Sums are uint32 (signed overflow is undefined in C++, unsigned
// wraps mod 2^32 as the aggregate requires). A warp-shuffle and block
// reduction ends in one atomicAdd per block; addition mod 2^32 commutes, so
// the result does not depend on the order the atomics land in. The TPU
// kernel's in-VMEM transposes and sublane loop have no counterpart here.
// wgmma does not apply to integer equality; TMA staging and several rows per
// block are for later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;   // S rows per block row: one thread each
constexpr int kTile = 1024;   // R columns staged per pass: 8 KB of shared memory

__global__ void __launch_bounds__(kLanes)
band_compare_sum_kernel(const int32_t* __restrict__ sk,
                        const int32_t* __restrict__ sp,
                        const int32_t* __restrict__ rk,
                        const int32_t* __restrict__ rp,
                        int64_t wb, uint32_t* __restrict__ out) {
  __shared__ __align__(16) int32_t rk_s[kTile];
  __shared__ __align__(16) uint32_t rp_s[kTile];
  __shared__ uint32_t warp_sum[kLanes / 32];

  const int l = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int32_t key = sk[row * kLanes + l];
  const uint32_t pay = static_cast<uint32_t>(sp[row * kLanes + l]);
  const int32_t* rk_row = rk + row * wb;
  const int32_t* rp_row = rp + row * wb;

  uint32_t t = 0;  // SUM of the matched rp of this S lane, mod 2^32
  for (int64_t base = 0; base < wb; base += kTile) {
    const int n = static_cast<int>(wb - base < kTile ? wb - base : kTile);
    __syncthreads();  // every thread is done with the previous tile
    for (int j = l; j < n; j += kLanes) {
      rk_s[j] = rk_row[base + j];
      rp_s[j] = static_cast<uint32_t>(rp_row[base + j]);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < n; ++j) t += (rk_s[j] == key) ? rp_s[j] : 0u;
  }

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

}  // namespace

// Adds the chunk's sum to out[0] (a uint32 the caller zeroed). Launches on
// `stream` and does not synchronise. Returns cudaGetLastError().
extern "C" int tj_band_compare_sum(const void* sk, const void* sp,
                                   const void* rk, const void* rp, void* out,
                                   int64_t ch, int64_t wb, void* stream) {
  if (ch <= 0) return 0;
  band_compare_sum_kernel<<<static_cast<unsigned int>(ch), kLanes, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sk), static_cast<const int32_t*>(sp),
      static_cast<const int32_t*>(rk), static_cast<const int32_t*>(rp), wb,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
