// bitonic.cuh: the compare-exchange network on (key, payload) pairs, shared
// by the kernels that merge or sort inside a block: first with the pairs held
// in shared memory (kernels 6, 9 and 10), then, in the second half, with the
// pairs held in registers (kernels 7 and 8).
//
// A stage at distance d (a power of two) over m elements is m / 2
// independent exchanges: exchange i compares element lo = tj_stage_lo(i, d)
// with element lo + d. The exchange is
//
//     swap = (key[hi] < key[lo]) ^ descending
//
// with a strict <, as the TPU kernels' `_cx` has it
// (icde2019_gpu_join_tpu/ops/merge_pallas.py:91): equal keys stay put in an
// ascending group and trade places in a descending one. That fixes where the
// payloads of equal keys land, so a level equals the reference's element for
// element.

#pragma once

#include <cstdint>

// The lower element of exchange i in a stage at distance d: the exchanges of
// one 2d-aligned group are its first d elements.
__device__ __forceinline__ int tj_stage_lo(int i, int d) {
  return ((i & ~(d - 1)) << 1) | (i & (d - 1));
}

__device__ __forceinline__ void tj_compare_exchange(int32_t* key, int32_t* pay,
                                                    int lo, int hi,
                                                    bool descending) {
  const int32_t a = key[lo];
  const int32_t b = key[hi];
  if ((b < a) != descending) {
    key[lo] = b;
    key[hi] = a;
    const int32_t p = pay[lo];
    pay[lo] = pay[hi];
    pay[hi] = p;
  }
}

// One stage at distance d over the block's m elements, all ascending, by all
// the block's threads; the caller synchronises between stages.
__device__ __forceinline__ void tj_stage_ascending(int32_t* key, int32_t* pay,
                                                   int m, int d) {
  for (int i = threadIdx.x; i < m / 2; i += blockDim.x) {
    const int lo = tj_stage_lo(i, d);
    tj_compare_exchange(key, pay, lo, lo + d, false);
  }
}

// One stage at distance d = 1 << j of a full bitonic sort, over the block's m
// elements: the direction of a group comes from bit k of an element's flat
// index (ascending iff the bit is 0), flat = base + the element's place in
// the block; k > j, so both elements of an exchange read the same bit.
//
// The exchange is element-wise, as the TPU tile sort has it
// (benchmarks/experimental_sort_pallas.py:70-75): each element on its own
// takes its partner's key and payload iff (partner < own) == keep_small,
// where the lower element keeps the small key in an ascending group. On
// distinct keys that is a swap. On equal keys the element that keeps the
// large key takes its partner's payload while the partner keeps its own, so
// one payload is written twice and the other is lost: the reference's
// behaviour, kept so that kernel and reference agree on every input.
__device__ __forceinline__ void tj_exchange_elementwise(int32_t* key,
                                                        int32_t* pay, int lo,
                                                        int hi,
                                                        bool lo_keeps_small) {
  const int32_t a = key[lo];
  const int32_t b = key[hi];
  const int32_t pa = pay[lo];
  const int32_t pb = pay[hi];
  if ((b < a) == lo_keeps_small) {
    key[lo] = b;
    pay[lo] = pb;
  }
  if ((a < b) != lo_keeps_small) {
    key[hi] = a;
    pay[hi] = pa;
  }
}

__device__ __forceinline__ void tj_stage_index_bit(int32_t* key, int32_t* pay,
                                                   int m, int j, int k,
                                                   int64_t base) {
  const int d = 1 << j;
  for (int i = threadIdx.x; i < m / 2; i += blockDim.x) {
    const int lo = tj_stage_lo(i, d);
    const bool ascending = (((base + lo) >> k) & 1) == 0;
    tj_exchange_elementwise(key, pay, lo, lo + d, ascending);
  }
}

// One stage at distance d over the block's m elements, read as rows of 128:
// with row_mask the direction flips (descending) where the lower element's
// row is odd, the per-row direction mask `dm` of the TPU kernels' `_cx`
// (merge_pallas.py:106-107, 118-119); without it every group ascends. `at`
// maps an element's flat place to its place in shared memory, so that the
// same stage runs out of a padded or a transposed layout.
template <typename At>
__device__ __forceinline__ void tj_stage_row_mask(int32_t* key, int32_t* pay,
                                                  int m, int d, bool row_mask,
                                                  At at) {
  for (int i = threadIdx.x; i < m / 2; i += blockDim.x) {
    const int lo = tj_stage_lo(i, d);
    const bool descending = row_mask && ((lo >> 7) & 1);
    tj_compare_exchange(key, pay, at(lo), at(lo + d), descending);
  }
}

// The identity layout: element i at place i.
struct TjFlat {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};

// ---------------------------------------------------------------------------
// The same network with a block's elements in registers (kernels 7 and 8).
//
// A block of T threads holds m = T * E (key, payload) pairs, E = 2^B a
// thread, and never keeps them in shared memory between stages. Which E
// elements a thread owns is a layout; a stage at distance 2^bit needs no
// memory at all when `bit` is one of the layout's register bits (both
// elements of every exchange sit in one thread), and two warp shuffles an
// element when it is one of its lane bits. Shared memory is only the
// exchange buffer between two layouts (tj_relayout), so log2(E) or more
// stages run per trip through it instead of one.
//
// A layout gives slot e of thread t the element
//
//     index(e) = tpart | (e & 3) << s0 | (e >> 2) << s1
//
//   tj_layout_group(t, g):  register bits are index bits g .. g+B-1, the
//       thread's low g bits are index bits 0 .. g-1. g = 0 is the contiguous
//       layout: a thread owns E neighbours (16 bytes a load), its lane is
//       index bits B .. B+4, so bits B+4 .. 0 run in shuffles and registers:
//       the last B + 5 stages of any merge. g >= 5 keeps a warp on 32
//       neighbours (coalesced 4-byte accesses, no bank conflict).
//   tj_layout_vec4(t, log_m): register bits 0, 1 and the top B - 2: thread t
//       owns the 16-byte vectors t, t + T, t + 2T, ... of the block, so a
//       block's elements arrive in coalesced 16-byte loads and the stages on
//       the top B - 2 bits, the first of a merge, run on what was loaded.
//
// The exchanges are those above, on registers, branch-free: TjSwapLess is
// tj_compare_exchange (strict <, a direction bit), TjElementwise is
// tj_exchange_elementwise (each side decides from both keys, so on equal
// keys a payload is written twice and one is lost, as the reference does).
// `desc` says that the exchange's group descends; both of its elements always
// agree on it.

template <int E>
struct TjRegs {
  int32_t key[E];
  int32_t pay[E];
};

template <int E>
struct TjLog2 {
  static constexpr int value = 1 + TjLog2<E / 2>::value;
};
template <>
struct TjLog2<1> {
  static constexpr int value = 0;
};

struct TjLayout {
  int tpart;
  int s0;
  int s1;
};

template <int E>
__device__ __forceinline__ TjLayout tj_layout_group(int t, int g) {
  TjLayout l;
  l.tpart = (t & ((1 << g) - 1)) | ((t >> g) << (g + TjLog2<E>::value));
  l.s0 = g;
  l.s1 = g + 2;
  return l;
}

template <int E>
__device__ __forceinline__ TjLayout tj_layout_vec4(int t, int log_m) {
  TjLayout l;
  l.tpart = t << 2;
  l.s0 = 0;
  l.s1 = log_m - TjLog2<E>::value + 2;
  return l;
}

__device__ __forceinline__ int tj_index(const TjLayout& l, int e) {
  return l.tpart | ((e & 3) << l.s0) | ((e >> 2) << l.s1);
}

__device__ __forceinline__ bool tj_is_group(const TjLayout& l, int g) {
  return l.s0 == g && l.s1 == g + 2;
}

struct TjSwapLess {
  static __device__ __forceinline__ void regs(int32_t& ka, int32_t& pa,
                                              int32_t& kb, int32_t& pb,
                                              bool desc) {
    const bool swap = (kb < ka) != desc;
    const int32_t k = swap ? kb : ka;
    const int32_t p = swap ? pb : pa;
    kb = swap ? ka : kb;
    pb = swap ? pa : pb;
    ka = k;
    pa = p;
  }
  // Whether a thread replaces its element by its partner's, which a shuffle
  // brought; is_hi: this thread holds the upper element of the exchange.
  static __device__ __forceinline__ bool take(int32_t mine, int32_t other,
                                              bool is_hi, bool desc) {
    return (is_hi ? (mine < other) : (other < mine)) != desc;
  }
};

struct TjElementwise {
  static __device__ __forceinline__ void regs(int32_t& ka, int32_t& pa,
                                              int32_t& kb, int32_t& pb,
                                              bool desc) {
    const bool take_lo = (kb < ka) != desc;   // the lower keeps the small key
    const bool take_hi = (ka < kb) == desc;   // the upper keeps the large key
    const int32_t k = take_lo ? kb : ka;
    const int32_t p = take_lo ? pb : pa;
    kb = take_hi ? ka : kb;
    pb = take_hi ? pa : pb;
    ka = k;
    pa = p;
  }
  static __device__ __forceinline__ bool take(int32_t mine, int32_t other,
                                              bool is_hi, bool desc) {
    return (other < mine) == (is_hi == desc);
  }
};

// Which groups descend, as the stages read it: per slot (the direction bit
// is a register bit of the layout), one flag a thread, or all ascending,
// which the compiler folds away.
struct TjDirSlots {
  uint32_t mask;
  __device__ __forceinline__ bool operator()(int e) const {
    return (mask >> e) & 1u;
  }
};
struct TjDirThread {
  bool desc;
  __device__ __forceinline__ bool operator()(int) const { return desc; }
};
struct TjDirAscending {
  __device__ __forceinline__ bool operator()(int) const { return false; }
};

// One stage on register bit R: slot e with slot e | 1 << R.
template <int E, int R, typename X, typename Dir>
__device__ __forceinline__ void tj_stage_regs(TjRegs<E>& v, Dir dir) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if ((e & (1 << R)) == 0) {
      X::regs(v.key[e], v.pay[e], v.key[e | (1 << R)], v.pay[e | (1 << R)],
              dir(e));
    }
  }
}

// The stages on a layout's register bits whose index bits lie in [lo, hi],
// in falling order of the index bit.
template <int E, int R, typename X, typename Dir>
struct TjRegStages {
  static __device__ __forceinline__ void run(TjRegs<E>& v, const TjLayout& l,
                                             int hi, int lo, Dir dir) {
    const int bit = R < 2 ? l.s0 + R : l.s1 + R - 2;
    if (bit <= hi && bit >= lo) tj_stage_regs<E, R, X>(v, dir);
    if constexpr (R > 0) TjRegStages<E, R - 1, X, Dir>::run(v, l, hi, lo, dir);
  }
};

// One stage across lanes: the partner's slot e comes from lane ^ lane_xor.
// Every thread of the warp must call it.
template <int E, typename X, typename Dir>
__device__ __forceinline__ void tj_stage_shuffle(TjRegs<E>& v, int lane_xor,
                                                 bool is_hi, Dir dir) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int32_t ok = __shfl_xor_sync(0xffffffffu, v.key[e], lane_xor);
    const int32_t op = __shfl_xor_sync(0xffffffffu, v.pay[e], lane_xor);
    const bool take = X::take(v.key[e], ok, is_hi, dir(e));
    v.key[e] = take ? ok : v.key[e];
    v.pay[e] = take ? op : v.pay[e];
  }
}

// The stages at index bits hi .. lo that a layout runs where it stands: with
// `lanes` (the contiguous layout) first those on its lane bits, bits
// B + 4 .. B, then those on its register bits.
template <int E, typename X, typename Dir>
__device__ __forceinline__ void tj_stages_here(TjRegs<E>& v, const TjLayout& l,
                                               int hi, int lo, bool lanes,
                                               Dir dir) {
  constexpr int B = TjLog2<E>::value;
  if (lanes) {
    const int t = threadIdx.x;
    for (int bit = hi; bit >= B && bit >= lo; --bit) {
      tj_stage_shuffle<E, X>(v, 1 << (bit - B), (t >> (bit - B)) & 1, dir);
    }
  }
  TjRegStages<E, B - 1, X, Dir>::run(v, l, hi, lo, dir);
}

// The slots whose bit r is set: the direction mask when the direction bit is
// register bit r of the layout.
__device__ __forceinline__ uint32_t tj_slot_bit_mask(int r) {
  return r == 0 ? 0xAAAAAAAAu
       : r == 1 ? 0xCCCCCCCCu
       : r == 2 ? 0xF0F0F0F0u
       : r == 3 ? 0xFF00FF00u
                : 0xFFFF0000u;
}

// The same with the directions of merge k of a full sort: an element
// descends iff bit k of (flat | index) is set, flat the block's first index
// within its tile (a multiple of the block's size); k lies above hi. When
// bit k is not a register bit of the layout a thread's slots share one
// direction. kDirected false: every group ascends, flat and k are not read.
// A caller whose directions are uniform passes flat = desc << k with k above
// every index bit of the block.
template <int E, typename X, bool kDirected>
__device__ __forceinline__ void tj_stages_directed(TjRegs<E>& v,
                                                   const TjLayout& l, int hi,
                                                   int lo, bool lanes,
                                                   int flat, int k) {
  constexpr int B = TjLog2<E>::value;
  if constexpr (!kDirected) {
    tj_stages_here<E, X>(v, l, hi, lo, lanes, TjDirAscending{});
  } else if (k >= l.s0 && k < l.s0 + 2) {
    tj_stages_here<E, X>(v, l, hi, lo, lanes,
                         TjDirSlots{tj_slot_bit_mask(k - l.s0)});
  } else if (k >= l.s1 && k < l.s1 + B - 2) {
    tj_stages_here<E, X>(v, l, hi, lo, lanes,
                         TjDirSlots{tj_slot_bit_mask(k - l.s1 + 2)});
  } else {
    tj_stages_here<E, X>(v, l, hi, lo, lanes,
                         TjDirThread{(((flat | l.tpart) >> k) & 1) != 0});
  }
}

// Where element i lies in the exchange buffer, which holds a (key, payload)
// pair in 8 bytes so that a pair moves in one access: its low four bits xor
// bits B .. B+3. A 64-bit access is served half a warp at a time, and with
// this map the 16 lanes of a half fall on 16 different places mod 16 (all 32
// banks) in every layout above, but for a two-way conflict on the vec4
// layout at E = 32. No padding: m elements take m pairs. The map is linear
// over xor, and a slot's bits and the thread's are disjoint, so a slot's
// place is the thread's swizzled part xor the slot's, which does not depend
// on the thread.
template <int E>
__device__ __forceinline__ int tj_swizzle(int i) {
  return i ^ ((i >> TjLog2<E>::value) & 15);
}

template <int E>
__device__ __forceinline__ int tj_slot_place(const TjLayout& l, int e) {
  return tj_swizzle<E>(((e & 3) << l.s0) | ((e >> 2) << l.s1));
}

template <int E>
__device__ __forceinline__ void tj_regs_to_shared(const TjRegs<E>& v,
                                                  const TjLayout& l,
                                                  int2* buffer) {
  const int base = tj_swizzle<E>(l.tpart);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    buffer[base ^ tj_slot_place<E>(l, e)] = make_int2(v.key[e], v.pay[e]);
  }
}

template <int E>
__device__ __forceinline__ void tj_shared_to_regs(TjRegs<E>& v,
                                                  const TjLayout& l,
                                                  const int2* buffer) {
  const int base = tj_swizzle<E>(l.tpart);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int2 pair = buffer[base ^ tj_slot_place<E>(l, e)];
    v.key[e] = pair.x;
    v.pay[e] = pair.y;
  }
}

// One trip through shared memory: from layout `from` to layout `to`. The
// first barrier protects what an earlier trip's readers still read.
template <int E>
__device__ __forceinline__ void tj_relayout(TjRegs<E>& v, const TjLayout& from,
                                            const TjLayout& to, int2* buffer) {
  __syncthreads();
  tj_regs_to_shared(v, from, buffer);
  __syncthreads();
  tj_shared_to_regs(v, to, buffer);
}

// The stages at index bits hi .. lo (falling) of one merge over a block of
// elements that arrive in layout `l`; `l` is the layout they are left in.
// Bits above B + 4 run in groups of B on group layouts, one trip through
// shared memory each; the rest on the contiguous layout, in shuffles and
// registers. Directions as in tj_stages_directed.
template <int E, typename X, bool kDirected>
__device__ __forceinline__ void tj_block_stages(TjRegs<E>& v, TjLayout& l,
                                                int hi, int lo, int flat,
                                                int k, int2* buffer) {
  constexpr int B = TjLog2<E>::value;
  const int t = threadIdx.x;
  while (hi >= lo && hi > B + 4) {
    const int g = hi - B + 1;
    if (!tj_is_group(l, g)) {
      const TjLayout to = tj_layout_group<E>(t, g);
      tj_relayout(v, l, to, buffer);
      l = to;
    }
    tj_stages_directed<E, X, kDirected>(v, l, hi, lo, false, flat, k);
    hi = g - 1;
  }
  if (hi < lo) return;
  if (!tj_is_group(l, 0)) {
    const TjLayout to = tj_layout_group<E>(t, 0);
    tj_relayout(v, l, to, buffer);
    l = to;
  }
  tj_stages_directed<E, X, kDirected>(v, l, hi, lo, true, flat, k);
}

// A block's elements between device memory and registers. `at` maps an
// element's index within the block to its offset in the arrays; the four
// elements of a vector are neighbours there and the vector is 16-byte
// aligned. Layouts with s0 == 0 (contiguous, vec4) move 16 bytes a thread,
// the group layouts 4 bytes with a warp on 128 neighbouring bytes.
template <int E, typename At>
__device__ __forceinline__ void tj_load_block(TjRegs<E>& v, const TjLayout& l,
                                              const int32_t* key,
                                              const int32_t* pay, At at) {
  if (l.s0 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int64_t o = at(tj_index(l, 4 * q));
      const int4 kk = *reinterpret_cast<const int4*>(key + o);
      const int4 pp = *reinterpret_cast<const int4*>(pay + o);
      v.key[4 * q] = kk.x; v.key[4 * q + 1] = kk.y;
      v.key[4 * q + 2] = kk.z; v.key[4 * q + 3] = kk.w;
      v.pay[4 * q] = pp.x; v.pay[4 * q + 1] = pp.y;
      v.pay[4 * q + 2] = pp.z; v.pay[4 * q + 3] = pp.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t o = at(tj_index(l, e));
      v.key[e] = key[o];
      v.pay[e] = pay[o];
    }
  }
}

template <int E, typename At>
__device__ __forceinline__ void tj_store_block(const TjRegs<E>& v,
                                               const TjLayout& l, int32_t* key,
                                               int32_t* pay, At at) {
  if (l.s0 == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const int64_t o = at(tj_index(l, 4 * q));
      *reinterpret_cast<int4*>(key + o) = make_int4(
          v.key[4 * q], v.key[4 * q + 1], v.key[4 * q + 2], v.key[4 * q + 3]);
      *reinterpret_cast<int4*>(pay + o) = make_int4(
          v.pay[4 * q], v.pay[4 * q + 1], v.pay[4 * q + 2], v.pay[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t o = at(tj_index(l, e));
      key[o] = v.key[e];
      pay[o] = v.pay[e];
    }
  }
}
