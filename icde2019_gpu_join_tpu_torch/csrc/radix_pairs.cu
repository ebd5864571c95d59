// radix_pairs.cu: a least-significant-digit radix sort of (int32 sortval,
// int32 payload) pairs, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (ops/radix_pairs.py).
//
// Replaces no TPU kernel. The JAX package sorts its pairs with lax.sort, a
// library sort that no Pallas kernel ever replaced; the port's first form was
// its counterpart torch.sort, which on the card is CUB's onesweep over the
// 4-byte key and an int64 index (24 bytes a row a pass, the index filled
// first), followed by a gather of the payloads through that index. This is
// the redesign for the card that ROADMAP R1 names: the payload rides with its
// key through every pass, and no index array exists.
//
// What bounds it: memory. Every row read once and written once is 16 bytes a
// row (0.64 ms for 2^27 rows at 3.35 TB/s); an LSD sort of 8-bit digits
// moves 4 bytes a row for the histograms and 16 bytes a row in each of its
// four passes, 68 bytes a row. The design meets that with one read of the
// sortvals for all four histograms and one read and one write of each pair a
// pass, in the shape of Onesweep (Adinets and Merrill, 2022):
//
//   * tj_radix_histogram: one launch counts all four digits of every sortval
//     into per-block shared-memory histograms (shared atomics, four rows in
//     flight a thread) and adds them into hist[4][256] with global atomics.
//     The sign bit is flipped at digit extraction, so the stored values stay
//     as they are and signed int32 order is kept.
//   * tj_radix_pass, once a digit: a block of 512 threads takes the next tile
//     of kTile = 8192 rows from an atomic counter (so every tile it waits
//     for belongs to a block that is already running: the look-back cannot
//     deadlock). Each warp copies its 512 neighbouring rows into shared
//     memory, sortvals and payloads, 16 bytes a `cp.async` and all in flight
//     together, where both arrays start on 16-byte boundaries and the tile is
//     whole (else 4 bytes a row); then it reads its sortvals warp-striped
//     into registers, and the payloads wait in shared memory until the
//     staging. Two blocks an SM (84 KB of shared memory and at most 64
//     registers a thread each). Measured on an H100 (PERF.md, section 6): 256
//     threads with 4096-row tiles and the payloads in registers took 5.52
//     ms at 2^27 against 4.75; 12 rows a thread 6.01; 4-byte loads 5.78;
//     384 or 256 threads at three or four blocks an SM 5.27-5.55.
//   * Ranking: round i of a warp holds rows i * 32 + lane of its segment, so
//     rounds and lanes go in row order and the sort is stable, which LSD
//     passes need. The lanes of one digit find each other with eight ballots
//     (one a digit bit: cheaper than match.any), the highest of them adds the
//     group to the warp's shared counter of the digit, and each lane's rank
//     is that counter's old value plus its lower peers. A hot digit (the Zipf
//     cell's most frequent key is about 7.5% of S) is one group and one
//     shared update a round, not one a row. Rows past n (a last tile's) are
//     ranked as the key whose digits are all 255, so they take the tile's
//     last places and need no validity ballot.
//   * A thread a digit sums the warps' counters into the tile's count, turns
//     them into the warps' offsets, and publishes the count for the tiles
//     after it (decoupled look-back); the block scans the counts and
//     hist[pass] into the tile's first row of each digit and each digit's
//     bucket. Then each thread walks back over earlier tiles' published
//     counts until an inclusive prefix, and publishes its own. (Reading 8
//     earlier tiles' words at once was slower: the wait is for the tile just
//     before to publish, not the walk.)
//   * The block stages its sortvals in shared memory in digit order, its
//     payloads after them (each thread holds its payloads in registers
//     across one barrier), and writes them out as contiguous runs a digit,
//     sortvals and payloads to two arrays: consecutive threads on
//     consecutive rows of a run.
//   * Look-back words are 64 bits: the pass and the word's kind (aggregate or
//     inclusive) above a 32-bit count, so any n < 2^31 fits, and one zeroed
//     array of tiles x 256 words serves all four passes (a word of the pass
//     before reads as not yet published).
//
// The wrapper allocates outputs, one scratch pair and the zeroed state per
// call and launches on the caller's stream: pass 0 reads the inputs into the
// scratch pair, pass 1 writes the outputs, pass 2 the scratch, pass 3 the
// outputs. The inputs are never written.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBits = 8;
constexpr int kDigits = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitWarps = kDigits / 32;     // the warps of the digit work
constexpr int kItems = 16;                    // rows a thread
constexpr int kTile = kThreads * kItems;      // rows a tile
constexpr int kWarpRows = 32 * kItems;        // a warp's segment of the tile
constexpr int kMinBlocks = 2;
constexpr int kHistThreads = 256;
constexpr int kHistInFlight = 4;
constexpr int kHistMaxBlocks = 1024;
constexpr uint32_t kSign = 0x80000000u;
constexpr uint32_t kAll = 0xFFFFFFFFu;
constexpr uint32_t kPastN = 0x7FFFFFFFu;      // every digit 255: rows past n

static_assert(kThreads >= kDigits, "the digit work takes one thread a digit");
static_assert(kItems % 4 == 0, "16-byte loads take four rows a thread");

// Look-back word kinds; 0 is "not published in this pass".
constexpr uint32_t kAggregate = 1;
constexpr uint32_t kInclusive = 2;

__device__ __forceinline__ uint32_t digit_of(uint32_t key, int pass) {
  return ((key ^ kSign) >> (pass * kBits)) & (kDigits - 1);
}

__device__ __forceinline__ uint64_t status_word(int pass, uint32_t kind,
                                                uint32_t count) {
  return (static_cast<uint64_t>((static_cast<uint32_t>(pass) << 2) | kind)
          << 32) | count;
}

__device__ __forceinline__ uint32_t kind_of(uint64_t word, int pass) {
  const uint32_t hi = static_cast<uint32_t>(word >> 32);
  return (hi >> 2) == static_cast<uint32_t>(pass) ? (hi & 3u) : 0u;
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// The lanes of the warp whose d equals this lane's, by one ballot a bit.
__device__ __forceinline__ uint32_t peers_of(uint32_t d) {
  uint32_t peers = kAll;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const bool bit = (d >> b) & 1u;
    const uint32_t set = __ballot_sync(kAll, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

__device__ __forceinline__ void count_digits(uint32_t* s_hist, uint32_t key) {
  const uint32_t u = key ^ kSign;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    atomicAdd(&s_hist[p * kDigits + ((u >> (p * kBits)) & (kDigits - 1))], 1u);
  }
}

__global__ void __launch_bounds__(kHistThreads)
radix_histogram_kernel(const uint32_t* __restrict__ keys, uint32_t n,
                       uint32_t* __restrict__ hist) {
  __shared__ uint32_t s_hist[kPasses * kDigits];
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kHistThreads) {
    s_hist[i] = 0;
  }
  __syncthreads();
  const uint32_t stride = gridDim.x * kHistThreads;
  uint32_t i = blockIdx.x * kHistThreads + threadIdx.x;
  // n < 2^31 and stride <= 2^18, so i + kHistInFlight * stride cannot wrap
  for (; i + (kHistInFlight - 1) * stride < n; i += kHistInFlight * stride) {
    uint32_t k[kHistInFlight];
#pragma unroll
    for (int j = 0; j < kHistInFlight; ++j) k[j] = __ldg(keys + i + j * stride);
#pragma unroll
    for (int j = 0; j < kHistInFlight; ++j) count_digits(s_hist, k[j]);
  }
  for (; i < n; i += stride) count_digits(s_hist, __ldg(keys + i));
  __syncthreads();
  for (int j = threadIdx.x; j < kPasses * kDigits; j += kHistThreads) {
    const uint32_t c = s_hist[j];
    if (c) atomicAdd(&hist[j], c);
  }
}

// The pass kernel's shared memory, dynamic (above the 48 KB a static array
// may take).
struct PassSmem {
  uint32_t keys[kTile];            // the tile in row order, then digit order
  uint32_t vals[kTile];
  uint32_t warp[kWarps][kDigits];  // the warps' counts, then their offsets
  uint32_t first[kDigits];         // the tile's first row of each digit
  uint32_t dest[kDigits];          // output row of tile row p, less p
  uint32_t sums[kDigitWarps][2];
  uint32_t tile;
};

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(s),
               "l"(gmem) : "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
radix_pass_kernel(const uint32_t* __restrict__ keys_in,
                  const uint32_t* __restrict__ vals_in,
                  uint32_t* __restrict__ keys_out,
                  uint32_t* __restrict__ vals_out,
                  const uint32_t* __restrict__ hist, uint64_t* status,
                  uint32_t* tile_counter, uint32_t n, int pass) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassSmem& sm = *reinterpret_cast<PassSmem*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) sm.tile = atomicAdd(tile_counter, 1u);
  for (int i = tid; i < kWarps * kDigits; i += kThreads) (&sm.warp[0][0])[i] = 0;
  __syncthreads();
  const uint32_t tile = sm.tile;
  const uint32_t base = tile * kTile;
  const uint32_t rows = min(static_cast<uint32_t>(kTile), n - base);
  const uint32_t wrow = warp * kWarpRows;

  // A warp's segment, rows wrow .. wrow + kWarpRows - 1, into shared memory
  // in row order: its keys, then its payloads, in flight together; then
  // its keys into registers warp-striped, row wrow + i * 32 + lane in key[i].
  uint32_t key[kItems];
  if (kVec && rows == kTile) {
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      const int r = wrow + (j * 32 + lane) * 4;
      copy16(sm.keys + r, keys_in + base + r);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
#pragma unroll
    for (int j = 0; j < kItems / 4; ++j) {
      const int r = wrow + (j * 32 + lane) * 4;
      copy16(sm.vals + r, vals_in + base + r);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kItems; ++i) key[i] = sm.keys[wrow + i * 32 + lane];
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const uint32_t r = wrow + i * 32 + lane;
      key[i] = r < rows ? __ldg(keys_in + base + r) : kPastN;
      if (r < rows) sm.vals[r] = __ldg(vals_in + base + r);
    }
  }

  // each row's rank among the rows of its digit before it in its warp (the
  // rows past n of a last tile, all digits 255 and last in row order, rank
  // last in the tile and are never written)
  const uint32_t lower = (1u << lane) - 1u;
  uint32_t* wcount = sm.warp[warp];
  uint32_t rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t d = digit_of(key[i], pass);
    const uint32_t peers = peers_of(d);
    const int leader = 31 - __clz(peers);
    uint32_t before = 0;
    if (lane == leader) {
      before = wcount[d];
      wcount[d] = before + __popc(peers);
    }
    rank[i] = __shfl_sync(kAll, before, leader) + __popc(peers & lower);
    __syncwarp();
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // thread d < 256: the tile's count of digit d, the warps' offsets in it,
  // and the count published for the tiles after this one; then exclusive
  // scans over the digits: the tile's first row of digit d, and the first
  // output row of digit d's bucket
  const uint32_t d = tid;
  uint64_t* my_status = status + static_cast<size_t>(tile) * kDigits + d;
  uint32_t count = 0, bucket = 0, c_inc = 0, b_inc = 0;
  if (tid < kDigits) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = sm.warp[w][d];
      sm.warp[w][d] = count;
      count += c;
    }
    if (d == kDigits - 1) count -= kTile - rows;   // the rows past n
    store_status(my_status,
                 status_word(pass, tile ? kAggregate : kInclusive, count));
    bucket = __ldg(hist + d);
    c_inc = count;
    b_inc = bucket;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t c = __shfl_up_sync(kAll, c_inc, o);
      const uint32_t b = __shfl_up_sync(kAll, b_inc, o);
      if (lane >= o) {
        c_inc += c;
        b_inc += b;
      }
    }
    if (lane == 31) {
      sm.sums[warp][0] = c_inc;
      sm.sums[warp][1] = b_inc;
    }
  }
  __syncthreads();
  uint32_t first = c_inc - count, bucket_start = b_inc - bucket;
  if (tid < kDigits) {
    for (int w = 0; w < warp; ++w) {
      first += sm.sums[w][0];
      bucket_start += sm.sums[w][1];
    }
    sm.first[d] = first;
  }
  __syncthreads();

  // the keys into digit order (every thread holds its keys in registers
  // since the barrier); each row's payload from row order into registers,
  // then into digit order
  uint32_t val[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t dig = digit_of(key[i], pass);
    rank[i] += sm.first[dig] + sm.warp[warp][dig];
    sm.keys[rank[i]] = key[i];
    val[i] = sm.vals[wrow + i * 32 + lane];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) sm.vals[rank[i]] = val[i];

  // look back: rows of digit d in the tiles before this one
  if (tid < kDigits) {
    uint32_t prefix = 0;
    if (tile) {
      const uint64_t* p = my_status - kDigits;
      for (;;) {
        uint64_t word;
        uint32_t kind;
        do {
          word = load_status(p);
          kind = kind_of(word, pass);
        } while (kind == 0);
        prefix += static_cast<uint32_t>(word);
        if (kind == kInclusive) break;
        p -= kDigits;
      }
      store_status(my_status, status_word(pass, kInclusive, prefix + count));
    }
    sm.dest[d] = bucket_start + prefix - first;   // mod 2^32; + p is < n
  }
  __syncthreads();

  // write the staged rows: runs of one digit to consecutive output rows
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t p = i * kThreads + tid;
    if (p < rows) {
      const uint32_t k = sm.keys[p];
      const uint32_t o = sm.dest[digit_of(k, pass)] + p;
      keys_out[o] = k;
      vals_out[o] = sm.vals[p];
    }
  }
}

template <bool kVec>
cudaError_t allow_pass_smem() {
  return cudaFuncSetAttribute(radix_pass_kernel<kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(PassSmem)));
}

template <bool kVec>
cudaError_t launch_pass(unsigned int tiles, cudaStream_t stream,
                        const uint32_t* keys_in, const uint32_t* vals_in,
                        uint32_t* keys_out, uint32_t* vals_out,
                        const uint32_t* hist, uint64_t* status,
                        uint32_t* tile_counter, uint32_t n, int pass) {
  radix_pass_kernel<kVec><<<tiles, kThreads, sizeof(PassSmem), stream>>>(
      keys_in, vals_in, keys_out, vals_out, hist, status, tile_counter, n,
      pass);
  return cudaGetLastError();
}

}  // namespace

// tj_radix_configure lets the pass kernels take their shared memory on the
// current device: once a device, before its first tj_radix_pass.
extern "C" int tj_radix_configure() {
  cudaError_t err = allow_pass_smem<true>();
  if (err == cudaSuccess) err = allow_pass_smem<false>();
  return static_cast<int>(err);
}

// Both launch on `stream`, do not synchronise, and return cudaGetLastError()
// (cudaErrorInvalidValue for n outside [0, 2^31) or a pass outside [0, 4)).
//
// tj_radix_histogram adds the four digit histograms of keys[0, n) to
// hist[4][256] (uint32, zeroed by the caller).
extern "C" int tj_radix_histogram(const void* keys, void* hist, int64_t n,
                                  void* stream) {
  if (n < 0 || n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t want = (n + kHistThreads * kHistInFlight - 1) /
                       (kHistThreads * kHistInFlight);
  const int blocks = static_cast<int>(want < kHistMaxBlocks ? want
                                                            : kHistMaxBlocks);
  radix_histogram_kernel<<<blocks, kHistThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<uint32_t>(n),
      static_cast<uint32_t*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// tj_radix_pass scatters (keys_in, vals_in)[0, n) stably by digit `pass`
// into (keys_out, vals_out). hist is the pass's 256 counts; status holds
// ceil(n / 8192) * 256 64-bit words and tile_counter one uint32, both zeroed
// by the caller before pass 0 (a pass leaves its counter at the tile count,
// so each pass has its own).
extern "C" int tj_radix_pass(const void* keys_in, const void* vals_in,
                             void* keys_out, void* vals_out, const void* hist,
                             void* status, void* tile_counter, int64_t n,
                             int64_t pass, void* stream) {
  if (n < 0 || n > INT32_MAX || pass < 0 || pass >= kPasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const unsigned int tiles = static_cast<unsigned int>((n + kTile - 1) / kTile);
  const bool aligned = ((reinterpret_cast<uintptr_t>(keys_in) |
                         reinterpret_cast<uintptr_t>(vals_in)) & 15) == 0;
  auto launch = aligned ? launch_pass<true> : launch_pass<false>;
  return static_cast<int>(launch(
      tiles, static_cast<cudaStream_t>(stream),
      static_cast<const uint32_t*>(keys_in),
      static_cast<const uint32_t*>(vals_in), static_cast<uint32_t*>(keys_out),
      static_cast<uint32_t*>(vals_out), static_cast<const uint32_t*>(hist),
      static_cast<uint64_t*>(status), static_cast<uint32_t*>(tile_counter),
      static_cast<uint32_t>(n), static_cast<int>(pass)));
}
