"""Dataset generator, host oracle and host runtime: ctypes bindings over the
C++ host engine, with numpy fallbacks that match the same distributions (not
bit-identical; the checked-in oracle values under `data/` hold only for the
native generator).

The host runtime serves the out-of-memory regimes: the OpenMP radix
pre-partitioner (`host_partition`), the threaded staging copy
(`staging_copy`) and the knapsack batch scheduler (`knapsack_batches`)
(reference src/partition-primitives.cu:40-469 analogs).

The library is built from the JAX package's source,
`icde2019_gpu_join_tpu/datagen/native/host_engine.cpp`, read in place into
this package's build directory (`ops/_build.py`), so the datasets are
bit-identical to the JAX package's. It uses the same glibc rand()/nrand48()
primitives as the reference (src/generator_ETHZ.cu).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from icde2019_gpu_join_tpu_torch.ops import _build

_lib: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u64, i64, uint, cint = (ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint,
                            ctypes.c_int)
    for name, args, returns in (
            ("seed", (uint,), None),
            ("random_gen", (i32p, u64, i64), None),
            ("random_unique_gen", (i32p, u64, i64, uint), None),
            ("fk_from_pk", (i32p, u64, i32p, u64), None),
            ("gen_zipf", (i32p, u64, uint, ctypes.c_double), None),
            ("oracle_join_aggregate", (i32p, i32p, u64, i32p, i32p, u64),
             ctypes.c_int32),
            ("host_partition", (i32p, i32p, u64, cint, cint, cint, i32p, i32p,
                                u64p, u64p), None),
            ("staging_copy", (ctypes.c_void_p, ctypes.c_void_p, u64, cint),
             None),
            ("knapsack_batches", (ctypes.POINTER(ctypes.c_double), cint, cint,
                                  ctypes.POINTER(cint)), cint)):
        _build.entry(name, args=args, returns=returns, lib=lib)
    return lib


def native_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native host library; None if it cannot
    be built here (callers then fall back to numpy)."""
    global _lib
    if _lib is None:
        try:
            lib = _build.host_lib()
        except RuntimeError:
            return None
        _lib = _bind(lib)
    return _lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# --------------------------- generators -----------------------------------

def random_gen(n: int, maxid: int, seed: int = 12345) -> np.ndarray:
    """Uniform non-unique keys in [0, maxid) (reference random_gen,
    src/generator_ETHZ.cu:115-122)."""
    lib = native_lib()
    out = np.empty(n, dtype=np.int32)
    if lib is not None:
        lib.tj_seed(seed)
        lib.tj_random_gen(_i32p(out), n, maxid)
        return out
    rng = np.random.RandomState(seed)
    return rng.randint(0, maxid, size=n, dtype=np.int32)


def random_unique_gen(n: int, maxid: int, seed: int = 12345) -> np.ndarray:
    """Unique keys (a shuffled cycle 0, 1..maxid, 1..maxid, ...) (reference
    random_unique_gen, src/generator_ETHZ.cu:127-149)."""
    lib = native_lib()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        lib.tj_random_unique_gen(_i32p(out), n, maxid, seed)
        return out
    if n <= maxid + 1:
        base = np.arange(n, dtype=np.int32)
    else:
        base = np.empty(n, dtype=np.int32)
        base[: maxid + 1] = np.arange(maxid + 1, dtype=np.int32)
        rest = np.arange(n - (maxid + 1), dtype=np.int64) % maxid + 1
        base[maxid + 1:] = rest.astype(np.int32)
    rng = np.random.RandomState(seed)
    return base[rng.permutation(n)]


def fk_from_pk(n_fk: int, pk: np.ndarray, seed: int = 12345) -> np.ndarray:
    """FK relation: tile the PK relation then shuffle (reference
    create_relation_fk_from_pk, src/generator_ETHZ.cu:162-187)."""
    lib = native_lib()
    pk = np.ascontiguousarray(pk, dtype=np.int32)
    if lib is not None:
        out = np.empty(n_fk, dtype=np.int32)
        lib.tj_seed(seed)
        lib.tj_fk_from_pk(_i32p(out), n_fk, _i32p(pk), pk.shape[0])
        return out
    reps = -(-n_fk // pk.shape[0])
    tiled = np.tile(pk, reps)[:n_fk]
    rng = np.random.RandomState(seed)
    return tiled[rng.permutation(n_fk)]


def gen_zipf(n: int, alphabet_size: int, z: float, seed: int = 12345) -> np.ndarray:
    """Zipf keys over a shuffled alphabet {1..alphabet_size} (reference
    gen_zipf/gen_zipf_lut/gen_alphabet, src/generator_ETHZ.cu:236-348)."""
    lib = native_lib()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        lib.tj_seed(seed)
        lib.tj_gen_zipf(_i32p(out), n, alphabet_size, z)
        return out
    rng = np.random.RandomState(seed)
    alpha = rng.permutation(alphabet_size).astype(np.int32) + 1
    w = 1.0 / np.power(np.arange(1, alphabet_size + 1, dtype=np.float64), z)
    cdf = np.cumsum(w / w.sum())
    r = rng.random_sample(n)
    pos = np.searchsorted(cdf, r, side="left")
    return alpha[np.minimum(pos, alphabet_size - 1)]


# --------------------------- host oracle -----------------------------------

def oracle_join_aggregate(
    r_keys: np.ndarray, r_pay: np.ndarray,
    s_keys: np.ndarray, s_pay: np.ndarray,
) -> Optional[int]:
    """Native C++ oracle SUM(Pr*Ps) mod 2^32 (a partitioned hash join that
    shares nothing with the device path). None when the native library is
    unavailable."""
    lib = native_lib()
    if lib is None:
        return None
    rk = np.ascontiguousarray(r_keys, dtype=np.int32)
    rp = np.ascontiguousarray(r_pay, dtype=np.int32)
    sk = np.ascontiguousarray(s_keys, dtype=np.int32)
    sp = np.ascontiguousarray(s_pay, dtype=np.int32)
    if rk.shape != rp.shape or sk.shape != sp.shape:
        raise ValueError("keys and payloads must have equal lengths")
    return int(lib.tj_oracle_join_aggregate(
        _i32p(rk), _i32p(rp), rk.shape[0], _i32p(sk), _i32p(sp),
        sk.shape[0]))


def host_oracle_aggregate(
    r_keys: np.ndarray, r_pay: np.ndarray,
    s_keys: np.ndarray, s_pay: np.ndarray,
) -> int:
    """The host oracle with its fallback policy in one place: the native C++
    oracle when available, the (slow) numpy oracle otherwise."""
    got = oracle_join_aggregate(r_keys, r_pay, s_keys, s_pay)
    if got is None:
        from icde2019_gpu_join_tpu_torch.utils import oracle
        got = oracle.join_aggregate(r_keys, r_pay, s_keys, s_pay)
    return got


# --------------------------- host runtime ----------------------------------

def host_partition(
    keys: np.ndarray, pays: np.ndarray, bits: int, first_bit: int = 0,
    num_threads: int = 0, out: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Native OpenMP radix pre-partition into CSR layout. Returns
    (keys', pays', counts, offsets), counts and offsets int64. `out`, two
    int32 arrays of len(keys) that the caller owns (e.g. the `.numpy()`
    views of pinned host tensors), receives keys' and pays' in place of new
    arrays. Falls back to `utils.oracle.radix_partition` (which orders rows
    by key within a partition; the native scatter keeps arrival order per
    thread region)."""
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    pays = np.ascontiguousarray(pays, dtype=np.int32)
    if keys.shape != pays.shape:
        raise ValueError("keys and payloads must have equal lengths")
    if out is None:
        out = (np.empty_like(keys), np.empty_like(pays))
    ok, op = out
    for a in (ok, op):
        if a.dtype != np.int32 or a.shape != keys.shape \
                or not a.flags.c_contiguous:
            raise ValueError(f"out arrays must be contiguous int32 of shape "
                             f"{keys.shape}, got {a.dtype} {a.shape}")
    parts = 1 << bits
    lib = native_lib()
    if lib is None:
        from icde2019_gpu_join_tpu_torch.utils import oracle
        k, p, counts, offsets = oracle.radix_partition(keys, pays, bits,
                                                       first_bit)
        np.copyto(ok, k)
        np.copyto(op, p)
        return ok, op, counts, offsets
    counts = np.empty(parts, dtype=np.uint64)
    offsets = np.empty(parts + 1, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.tj_host_partition(
        _i32p(keys), _i32p(pays), keys.shape[0], bits, first_bit,
        num_threads, _i32p(ok), _i32p(op),
        counts.ctypes.data_as(u64p), offsets.ctypes.data_as(u64p))
    return ok, op, counts.astype(np.int64), offsets.astype(np.int64)


def staging_copy(dst: np.ndarray, src: np.ndarray, num_threads: int = 0):
    """Threaded streaming copy into a (pinned) staging buffer; `np.copyto`
    when the sizes differ or the native library is missing."""
    lib = native_lib()
    if lib is not None and dst.nbytes == src.nbytes \
            and dst.flags.c_contiguous and src.flags.c_contiguous:
        lib.tj_staging_copy(dst.ctypes.data_as(ctypes.c_void_p),
                            src.ctypes.data_as(ctypes.c_void_p),
                            dst.nbytes, num_threads)
    else:
        np.copyto(dst, src)


def knapsack_batches(gains: np.ndarray, capacity: int) -> np.ndarray:
    """Group items into batches by repeated 0/1 knapsack on gains (weight
    ceil(gain), at least 1, at most `capacity`). Returns the batch index of
    each item, int32. Items of gain 0 are never chosen and each ends in a
    batch of its own. The fallback is greedy first-fit decreasing."""
    gains = np.ascontiguousarray(gains, dtype=np.float64)
    n = gains.shape[0]
    lib = native_lib()
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        lib.tj_knapsack_batches(
            gains.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            capacity, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out
    order = np.argsort(-gains)
    batch_of = np.full(n, -1, dtype=np.int32)
    rooms: list = []
    weights = np.maximum(1, np.ceil(gains)).astype(np.int64)
    for i in order:
        for b, room in enumerate(rooms):
            if room >= weights[i]:
                rooms[b] -= weights[i]
                batch_of[i] = b
                break
        else:
            batch_of[i] = len(rooms)
            rooms.append(capacity - min(weights[i], capacity))
    return batch_of
