// extract_pairs.cu: materialize's extraction, for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (ops/extract_pairs.py).
//
// Both relations are sorted by key, so S row i's matches are the sorted-R
// rows [fm[i], fm[i] + h[i]), and off, the exclusive sum of h, is where they
// begin in the S-sorted stream of matches. The output keeps `capacity`
// slots:
//
//   lap = wrap && total > capacity;
//   the matches kept are m in [m_lo, m_lo + count), m_lo = lap ? total -
//   capacity : 0, count = min(total, capacity); match m goes to slot
//   m mod capacity (with a lap the last lap wins: the slot path's
//   m = pos + capacity * floor((total - 1 - pos) / capacity));
//   match m's owner is the last S row i with off[i] <= m, and it writes
//   out_r = r_p[fm[i] + m - off[i]], out_s = s_p[i], the row and the R
//   position clamped into range as the slot path clamps them;
//   slots [count, capacity) hold (0, 0).
//
// Replaces no TPU kernel. The TPU cannot gather, so the JAX package extracts
// by block windows (band_join._extract_blocked: 4 S blocks and 6 R blocks
// copied for each 128-slot block, kernel 4's interval select over 512
// candidates, kernel 2's equality select over 768) behind a span check that
// the host reads, and by a searchsorted slot path where the check fails.
// On the card that design took 65.6 ms of a 2^27 materialize (PERF.md).
//
// What bounds it: memory. A live slot reads its owner's off, fm and s_p
// (12 bytes where owners and slots pair up one to one), one r_p (4) and
// writes a pair (8): 24 bytes a slot, 0.96 ms at 2^27 slots at 3.35 TB/s.
// The design moves those bytes once:
//
//   * moderngpu's load-balancing search. The kept matches and the S rows
//     are merged, a row before a match where off <= m, and each block takes
//     kTile items of that merge. A block's work is bounded by its slots plus
//     its rows, so an S row with more matches than a tile, or a long run of
//     rows without a match, cannot unbalance the grid;
//   * one warp finds the block's first split and another its last, each by
//     a 32-way search over off (one round where matches and rows keep one
//     proportion, as in a PK-FK join; 7 at most at 2^28 items), no pass
//     before;
//   * the block stages its rows' off in shared memory, relative to its first
//     match; each thread finds its own split of the block's kItems-wide
//     diagonal there and walks its items in order, writing each slot's owner
//     into shared memory;
//   * then the block writes its slots in aligned groups of four, a thread a
//     group: the owner's fm and s_p and the R payload at fm + m - off, read
//     in slot order (for in-order matches one run of addresses), and two
//     16-byte streaming stores; a group that a block or the ring's end cuts
//     is written a slot at a time. Every slot is written once, so nothing
//     fills the output first. Blocks past the merge write the dead slots.
//
// 64-bit indices throughout: capacity, n_s + count and the positions of the
// merge may pass 2^31.
//
// Measured on an H100 (PERF.md, section 6): at 2^27 slots with one match a
// row in order, the mat cell's shape, 1.244 ms alone, 77% of the bytes'
// bound (48 registers, no spills, 15 KB of shared memory); 1.262 ms in
// situ. Tiles of 128 x 15 beat 256 x 15 (1.284), 128 x 23 (1.241 / 2.510 on
// a skewed shape against 2.432) and smaller tiles (256 x 7: 2.080);
// staging fm and s_p in shared memory beside off was slower (1.495). The
// proportional first round of the split search took 1.595 to 1.284 ms at
// 256 x 15.
//
// The wrapper allocates the two outputs and launches on the caller's stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// merged items a thread: odd, so that the threads' walks through shared
// memory, about kItems / 2 rows and matches apart, fall on distinct banks
constexpr int kItems = 15;
constexpr int kTile = kThreads * kItems;      // merged items a block

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Plan {
  int64_t n_s, n_r, capacity;
  int64_t m_lo;           // the first match kept
  int64_t count;          // matches kept: the live slots
  int64_t slot0;          // the slot of match m_lo
  int64_t merge_blocks;   // blocks over the merge; the rest write dead slots
};

// The number of matches among the first `diag` items of the merge of the
// matches m_lo + x (x < count) and the rows' offsets off[i] (i < n_s), rows
// first on ties: the first x with m_lo + x >= off[diag - 1 - x], or the
// range's end. A warp's search, every lane in it: each round tests 32 x and
// keeps the stretch between the last test that holds and the first that
// does not. The first round tests the 32 x around the split that matches
// and rows in proportion would give, so where every row has as many matches
// one round finds it; each later round tests 32 evenly spaced x.
__device__ int64_t merge_split(const int* __restrict__ off, const Plan& p,
                               int64_t diag) {
  const int lane = threadIdx.x & 31;
  int64_t lo = diag > p.n_s ? diag - p.n_s : 0;
  int64_t hi = diag < p.count ? diag : p.count;
  int64_t x0 = static_cast<int64_t>(static_cast<double>(diag) * p.count /
                                    (p.count + p.n_s)) - 16;
  x0 = x0 > hi - 32 ? hi - 32 : x0;
  x0 = x0 < lo ? lo : x0;
  int64_t step = 1;
  while (lo < hi) {
    const int64_t x = x0 + lane * step;
    const bool before =
        x < hi && p.m_lo + x < static_cast<int64_t>(__ldg(off + (diag - 1 - x)));
    const int held = __popc(__ballot_sync(0xffffffffu, before));
    if (held == 0) {
      hi = x0;
    } else {
      lo = x0 + (held - 1) * step + 1;
      if (held < 32) hi = min64(hi, x0 + held * step);
    }
    step = (hi - lo + 31) / 32;
    x0 = lo;
  }
  return lo;
}

// The pair of local match x of a block: its owner is rel's entry own[x],
// the row b0 - 1 + own[x], whose off lies rel[own[x]] after the block's
// first match.
struct Pairs {
  const int* __restrict__ fm;
  const int* __restrict__ s_p;
  const int* __restrict__ r_p;
  const int* rel;
  const int* own;
  int64_t b0, n_s, n_r;
  int64_t first;          // the slot of local match 0, before the ring wraps

  __device__ __forceinline__ void at(int64_t slot, int& r, int& s) const {
    const int x = static_cast<int>(slot - first);
    const int o = own[x];
    int64_t row = b0 - 1 + o;
    row = row < 0 ? 0 : (row >= n_s ? n_s - 1 : row);
    int64_t r_pos = static_cast<int64_t>(__ldg(fm + row)) + x - rel[o];
    r_pos = r_pos < 0 ? 0 : (r_pos >= n_r ? n_r - 1 : r_pos);
    r = __ldg(r_p + r_pos);
    s = __ldg(s_p + row);
  }
};

struct Zeros {
  __device__ __forceinline__ void at(int64_t, int& r, int& s) const {
    r = 0;
    s = 0;
  }
};

// Slots [sa, sb) of both outputs, from src, in groups of four aligned slots,
// a thread a group: a whole group in one 16-byte store to each output, a cut
// one a slot at a time.
template <class Src>
__device__ void store(int* __restrict__ out_r, int* __restrict__ out_s,
                      int64_t sa, int64_t sb, const Src& src) {
  for (int64_t g = (sa >> 2) + threadIdx.x; g < (sb + 3) >> 2; g += kThreads) {
    const int64_t s0 = g * 4;
    int r[4], s[4];
    if (s0 >= sa && s0 + 4 <= sb) {
#pragma unroll
      for (int q = 0; q < 4; ++q) src.at(s0 + q, r[q], s[q]);
      __stcs(reinterpret_cast<int4*>(out_r) + g, make_int4(r[0], r[1], r[2], r[3]));
      __stcs(reinterpret_cast<int4*>(out_s) + g, make_int4(s[0], s[1], s[2], s[3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t slot = s0 + q;
        if (slot >= sa && slot < sb) {
          src.at(slot, r[q], s[q]);
          __stcs(out_r + slot, r[q]);
          __stcs(out_s + slot, s[q]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
extract_pairs_kernel(const int* __restrict__ off, const int* __restrict__ fm,
                     const int* __restrict__ s_p, const int* __restrict__ r_p,
                     int* __restrict__ out_r, int* __restrict__ out_s, Plan p) {
  // rel[k]: off of row b0 - 1 + k less the block's first match
  __shared__ int rel[kTile + 1];
  // own[x]: local match x's owner, an index into rel
  __shared__ int own[kTile];
  __shared__ int64_t split[2];

  if (blockIdx.x >= p.merge_blocks) {
    const int64_t sa = p.count + (blockIdx.x - p.merge_blocks) * int64_t{kTile};
    store(out_r, out_s, sa, min64(sa + kTile, p.capacity), Zeros{});
    return;
  }
  const int64_t diag0 = blockIdx.x * int64_t{kTile};
  const int64_t diag1 = min64(diag0 + kTile, p.count + p.n_s);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t a = merge_split(off, p, warp == 0 ? diag0 : diag1);
    if ((threadIdx.x & 31) == 0) split[warp] = a;
  }
  __syncthreads();
  const int64_t a0 = split[0];
  const int na = static_cast<int>(split[1] - a0);
  if (na == 0) return;   // rows only: no match of this block is kept
  const int64_t b0 = diag0 - a0;
  const int nb = static_cast<int>(diag1 - split[1] - b0);
  const int64_t m0 = p.m_lo + a0;

  for (int k = threadIdx.x; k <= nb; k += kThreads) {
    const int64_t row = b0 - 1 + k;
    rel[k] = row < 0 ? 0 : static_cast<int>(__ldcs(off + row) - m0);
  }
  __syncthreads();

  // this thread's items of the block's merge: its split by binary search,
  // then kItems steps in order, a row where its off is at or before the
  // match, as merge_split ranks them
  const int d = threadIdx.x * kItems;
  if (d < na + nb) {
    int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (mid < rel[d - mid]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int x = lo, y = d - lo;
    const int end = min(d + kItems, na + nb);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (x + y < end) {
        if (y < nb && (x >= na || rel[y + 1] <= x)) {
          ++y;
        } else {
          own[x++] = y;
        }
      }
    }
  }
  __syncthreads();

  // local matches [0, na) are slots slot0 + a0 + x, wrapping at capacity
  int64_t first = p.slot0 + a0;
  if (first >= p.capacity) first -= p.capacity;
  const int64_t before_wrap = min64(na, p.capacity - first);
  Pairs src{fm, s_p, r_p, rel, own, b0, p.n_s, p.n_r, first};
  store(out_r, out_s, first, first + before_wrap, src);
  if (before_wrap < na) {
    src.first = first - p.capacity;
    store(out_r, out_s, 0, na - before_wrap, src);
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError(): cudaErrorInvalidValue for a negative size, outputs not
// on 16-byte boundaries, a kept match with no S or R row, or more than
// 2^31 - 1 blocks. off, fm and s_p hold n_s int32, r_p n_r; out_r and out_s
// capacity int32 each; a total at or below 0 keeps no match; wrap is 0 or 1.
extern "C" int tj_extract_pairs(const void* off, const void* fm,
                                const void* s_p, const void* r_p, void* out_r,
                                void* out_s, int64_t n_s, int64_t n_r,
                                int64_t capacity, int64_t total, int64_t wrap,
                                void* stream) {
  if (n_s < 0 || n_r < 0 || capacity < 0 ||
      reinterpret_cast<uintptr_t>(out_r) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out_s) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (capacity == 0) return 0;
  Plan p{};
  p.n_s = n_s;
  p.n_r = n_r;
  p.capacity = capacity;
  const int64_t kept = total > 0 ? total : 0;
  p.count = kept < capacity ? kept : capacity;
  p.m_lo = wrap != 0 && kept > capacity ? kept - capacity : 0;
  p.slot0 = p.m_lo % capacity;
  if (p.count > 0 && (n_s < 1 || n_r < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.merge_blocks = p.count > 0 ? (p.count + n_s + kTile - 1) / kTile : 0;
  const int64_t blocks = p.merge_blocks + (capacity - p.count + kTile - 1) / kTile;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  extract_pairs_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(off), static_cast<const int*>(fm),
      static_cast<const int*>(s_p), static_cast<const int*>(r_p),
      static_cast<int*>(out_r), static_cast<int*>(out_s), p);
  return static_cast<int>(cudaGetLastError());
}
