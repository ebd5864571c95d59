// row_colsums.cu: a late aggregate's column sums, for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (ops/row_colsums.py).
//
//   out[i] = sum over j < c of cols[id(rowid[i])][j], mod 2^32
//
// where id() is JAX's index rule: a negative id counts from the end (id + n),
// then every id is clamped into [0, n - 1].
//
// Replaces no TPU kernel. The JAX package computes the sums with library
// operations, jnp.sum(cols.astype(uint32), axis=1)[payload]; the port's first
// form was their torch counterpart, eight operations through int64
// temporaries (the ids widened, offset and clamped; the columns widened,
// summed over rows of c as an int64 reduction, masked and narrowed; a
// gather), which moved several times the bytes the sums need.
//
// What bounds it: memory. An output row reads its id (4 bytes) and the c
// int32 columns of the row at that id (4c bytes) and writes one int32: 24
// bytes a row for c = 4, 16 for c = 2, against a clamp and c - 1 adds. The
// design moves those bytes once, in one pass:
//
//   * a block of kThreads threads takes kThreads * kItems consecutive
//     outputs, and thread t of it outputs t, t + kThreads, ...: a warp's
//     loads of ids and stores of sums are 128 contiguous bytes each, and for
//     ids in table order its row loads are 32 contiguous rows;
//   * each thread loads its kItems ids, then the rows at all of them, every
//     load in flight before the first add, then adds and stores;
//   * a row is read in vectors of V int32 (16 bytes for V = 4, 8 for V = 2)
//     where the column count, the row stride and the base address allow it,
//     else one int32 at a time at any column stride;
//   * every id is read and its row loaded whatever the ids are: no shortcut
//     for ids in table order;
//   * sums are uint32, so they wrap mod 2^32 as the int32 answer does.
//
// Measured on an H100 (PERF.md, section 6): at 2^27 rows with ids in order
// 1.055 ms for c = 4 and 0.714 ms for c = 2, 91% and 90% of the bytes'
// bound (38 and 32 registers, no spills); with shuffled ids each row is a
// random 16- or 8-byte read of a 32-byte sector, 4.80 and 4.78 ms.
//
// The wrapper allocates the output and launches on the caller's stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                     // outputs a thread
constexpr int kRows = kThreads * kItems;      // outputs a block

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = int;
  static __device__ __forceinline__ uint32_t sum(T v) {
    return static_cast<uint32_t>(v);
  }
};
template <>
struct Vec<2> {
  using T = int2;
  static __device__ __forceinline__ uint32_t sum(T v) {
    return static_cast<uint32_t>(v.x) + static_cast<uint32_t>(v.y);
  }
};
template <>
struct Vec<4> {
  using T = int4;
  static __device__ __forceinline__ uint32_t sum(T v) {
    return static_cast<uint32_t>(v.x) + static_cast<uint32_t>(v.y) +
           static_cast<uint32_t>(v.z) + static_cast<uint32_t>(v.w);
  }
};

// cols: n rows of c int32 at row_stride and col_stride elements (col_stride
// 1 where V > 1); rowid: m int32 at id_stride; out: m int32, contiguous.
template <int V>
__global__ void __launch_bounds__(kThreads)
row_colsums_kernel(const int* __restrict__ cols, const int* __restrict__ rowid,
                   int* __restrict__ out, int64_t n, int64_t m, int c,
                   int64_t row_stride, int64_t col_stride, int64_t id_stride) {
  using T = typename Vec<V>::T;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x;
  int64_t at[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = first + k * kThreads;
    int64_t id = i < m ? static_cast<int64_t>(__ldcs(rowid + i * id_stride)) : 0;
    if (id < 0) id += n;
    id = id < 0 ? 0 : (id >= n ? n - 1 : id);
    at[k] = id * row_stride;
  }
  uint32_t sum[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) sum[k] = 0;
  for (int j = 0; j < c; j += V) {
    T v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (first + k * kThreads < m) {
        v[k] = __ldcs(reinterpret_cast<const T*>(cols + at[k] + j * col_stride));
      } else {
        v[k] = T{};
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) sum[k] += Vec<V>::sum(v[k]);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = first + k * kThreads;
    if (i < m) __stcs(out + i, static_cast<int>(sum[k]));
  }
}

template <int V>
cudaError_t launch(int64_t blocks, cudaStream_t stream, const int* cols,
                   const int* rowid, int* out, int64_t n, int64_t m, int c,
                   int64_t row_stride, int64_t col_stride, int64_t id_stride) {
  row_colsums_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          stream>>>(cols, rowid, out, n, m, c, row_stride,
                                    col_stride, id_stride);
  return cudaGetLastError();
}

// The widest vector a row's columns take: V divides c, the columns are
// adjacent, and every row starts on a 4V-byte boundary.
int vector_width(const void* cols, int64_t n, int64_t c, int64_t row_stride,
                 int64_t col_stride) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(cols);
  if (col_stride != 1 && c > 1) return 1;
  for (int v = 4; v > 1; v /= 2) {
    if (c % v == 0 && base % (4 * v) == 0 && (n == 1 || row_stride % v == 0)) {
      return v;
    }
  }
  return 1;
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError(): cudaErrorInvalidValue for n < 1, c < 1, m < 0, a
// negative stride, or more than 2^31 - 1 blocks. cols holds n rows of c
// int32 (element (r, j) at r * row_stride + j * col_stride), rowid m int32
// at id_stride, out m int32.
extern "C" int tj_row_colsums(const void* cols, const void* rowid, void* out,
                              int64_t n, int64_t m, int64_t c,
                              int64_t row_stride, int64_t col_stride,
                              int64_t id_stride, void* stream) {
  const int64_t blocks = (m + kRows - 1) / kRows;
  if (n < 1 || c < 1 || c > INT32_MAX || m < 0 || row_stride < 0 ||
      col_stride < 0 || id_stride < 0 || blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const int v = vector_width(cols, n, c, row_stride, col_stride);
  auto run = v == 4 ? launch<4> : v == 2 ? launch<2> : launch<1>;
  return static_cast<int>(run(
      blocks, static_cast<cudaStream_t>(stream), static_cast<const int*>(cols),
      static_cast<const int*>(rowid), static_cast<int*>(out), n, m,
      static_cast<int>(c), row_stride, v == 1 ? col_stride : 1, id_stride));
}
