"""Dataset creation and the reference's .bin file cache.

The same file names (src/main.cu:118-159) and the same cache directory
(`TPU_JOIN_DATA_DIR`, default `./data`) as the JAX package's
`utils/datasets.py`; both packages generate bit-identical files, so they
share one cache.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np

from icde2019_gpu_join_tpu_torch import datagen


def cache_dir() -> str:
    d = os.environ.get("TPU_JOIN_DATA_DIR", os.path.join(os.getcwd(), "data"))
    os.makedirs(d, exist_ok=True)
    return d


def read_bin(path: str, n: int) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    arr = np.fromfile(path, dtype=np.int32, count=n)
    if arr.shape[0] != n:
        return None
    return arr


def write_bin(path: str, arr: np.ndarray):
    arr.astype(np.int32).tofile(path)


def unique_filename(n: int) -> str:
    return os.path.join(cache_dir(), f"unique_{n}.bin")


def zipf_filename(n: int, skew: float) -> str:
    # the reference's sprintf (src/main.cu:139) drops a field; this is the
    # intended scheme with both
    return os.path.join(cache_dir(), f"unique_skew{skew:.2f}_S{n}.bin")


def _cached(path: str, n: int, gen_fn: Callable[[], np.ndarray]) -> np.ndarray:
    arr = read_bin(path, n)
    if arr is not None:
        return arr
    arr = gen_fn()
    write_bin(path, arr)
    return arr


def create_relation_unique(n: int, maxid: Optional[int] = None, seed: int = 12345) -> np.ndarray:
    """Unique keys 0..maxid cycled then Knuth-shuffled
    (reference random_unique_gen, src/generator_ETHZ.cu:127-149)."""
    maxid = n if maxid is None else maxid
    # keys stay below 2^31 so the sentinel contract (keys >= 0) holds
    maxid = min(maxid, (1 << 31) - 2)
    return _cached(unique_filename(n), n, lambda: datagen.random_unique_gen(n, maxid, seed))


def create_relation_zipf(n: int, alphabet_size: int, z: float, seed: int = 12345) -> np.ndarray:
    return _cached(zipf_filename(n, z), n, lambda: datagen.gen_zipf(n, alphabet_size, z, seed))


def make_pk_fk(
    n_r: int, n_s: int, skew: float = 0.0, seed: int = 12345
) -> Tuple[np.ndarray, np.ndarray]:
    """The benchmark workload: unique R (PK), S foreign keys drawn from R's
    domain: uniform (unique_gen cycling 0..n_r) or Zipf over 1..n_r
    (reference main.cu:186-262)."""
    r = create_relation_unique(n_r, n_r, seed)
    if skew > 0:
        s = create_relation_zipf(n_s, n_r, skew, seed)
    else:
        s = _cached(
            os.path.join(cache_dir(), f"unique_S{n_s}_mod{n_r}.bin"),
            n_s,
            lambda: datagen.random_unique_gen(
                n_s, min(n_r, (1 << 31) - 2), seed + 1),
        )
    return r, s


def make_config3(n_r: int, n_s: int, groups: int = 64, seed: int = 42):
    """BASELINE.json config 3's inputs, as `benchmarks/run_configs.py`
    (`config3`) makes them: R keys a permutation of [0, n_r) with payloads in
    [1, 100), S keys drawn from R's, a filter column in [0, 1000) and group
    ids in [0, groups). numpy PCG64 from `seed`, so every package gets
    byte-identical inputs. Returns (rk, rp, sk, s_filter, s_gid), int32."""
    rng = np.random.default_rng(seed)
    rk = rng.permutation(n_r).astype(np.int32)
    rp = rng.integers(1, 100, n_r).astype(np.int32)
    sk = rk[rng.integers(0, n_r, n_s)].astype(np.int32)
    s_filter = rng.integers(0, 1000, n_s).astype(np.int32)
    s_gid = rng.integers(0, groups, n_s).astype(np.int32)
    return rk, rp, sk, s_filter, s_gid
