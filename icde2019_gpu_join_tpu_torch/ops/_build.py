"""Builds the port's native libraries at first use and loads them with ctypes.

* `libtpujoin_torch_kernels.so`: every `csrc/*.cu`, compiled by `nvcc` for
  `sm_90a` (one `nvcc -c` per source, all started together) and linked into
  a shared library with a plain C interface.
* `libtpujoin_host.so`: the JAX package's host engine
  (`icde2019_gpu_join_tpu/datagen/native/host_engine.cpp`, read in place and
  never imported), compiled by `g++`. The same source gives the same
  datasets and the same C++ oracle as the JAX package.

Both land in `icde2019_gpu_join_tpu_torch/_build/`. A library is rebuilt
when one of its sources is newer than it. A failed build raises with the
compiler's stderr. Nothing here runs at import time.

`entry` binds a C entry point `tj_<name>` to its argument types: the one
place that sets them for this package.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import platform
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
HOST_SRC = os.path.join(os.path.dirname(_PKG_DIR), "icde2019_gpu_join_tpu",
                        "datagen", "native", "host_engine.cpp")
KERNEL_LIB = os.path.join(BUILD_DIR, "libtpujoin_torch_kernels.so")
HOST_LIB = os.path.join(BUILD_DIR, "libtpujoin_host.so")

_loaded = {}
_load_lock = threading.Lock()   # one build at a time, whatever the thread


def _is_stale(out: str, sources: List[str]) -> bool:
    try:
        built = os.path.getmtime(out)
    except OSError:
        return True
    return any(os.path.getmtime(s) > built for s in sources)


def _compile(cmd: List[str], out: str, sources: List[str]) -> float:
    """Compile into a temporary file, then rename it over `out`, so that
    concurrent builders (test workers) never load a half-written library.
    Returns the seconds spent."""
    if shutil.which(cmd[0]) is None:
        raise RuntimeError(f"{cmd[0]} not found; cannot build {out}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "-o", tmp, *sources],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {os.path.basename(out)} failed:\n"
                           f"{' '.join(proc.args)}\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def kernel_sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_kernels() -> float:
    """Build the CUDA kernel library if it is missing or stale; returns the
    seconds spent (0.0 when it was up to date). Each source compiles in its
    own `nvcc -c`, all at once; then one link."""
    srcs = kernel_sources()
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    if not _is_stale(KERNEL_LIB, srcs + headers):
        return 0.0
    nvcc = _nvcc()
    if shutil.which(nvcc) is None:
        raise RuntimeError(f"{nvcc} not found; cannot build {KERNEL_LIB}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{os.getpid()}.o")
            for src in srcs]
    procs = [subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-c", "-o", obj, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(srcs, objs)]
    try:
        for proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"building {KERNEL_LIB} failed:\n"
                                   f"{' '.join(proc.args)}\n{err}")
        _compile([nvcc, "-shared"], KERNEL_LIB, objs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return time.perf_counter() - t0


def build_host() -> float:
    """Build the host engine library if it is missing or stale; returns the
    seconds spent (0.0 when it was up to date)."""
    if not _is_stale(HOST_LIB, [HOST_SRC]):
        return 0.0
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp"]
    if platform.machine() in ("x86_64", "AMD64"):
        cmd.append("-mavx2")
    return _compile(cmd, HOST_LIB, [HOST_SRC])


def _load(path: str, build) -> ctypes.CDLL:
    with _load_lock:
        lib: Optional[ctypes.CDLL] = _loaded.get(path)
        if lib is None:
            build()
            lib = _loaded[path] = ctypes.CDLL(path)
    return lib


def kernel_lib() -> ctypes.CDLL:
    """The CUDA kernel library, built on first use."""
    return _load(KERNEL_LIB, build_kernels)


def host_lib() -> ctypes.CDLL:
    """The host engine library, built on first use."""
    return _load(HOST_LIB, build_host)


@functools.lru_cache(maxsize=None)
def entry(name: str, pointers: int = 0, ints: int = 0, *,
          args: Optional[Sequence] = None, returns=ctypes.c_int,
          lib: Optional[ctypes.CDLL] = None):
    """The C entry point `tj_<name>`, bound once to its argument types.

    The common form, a kernel's launcher, takes `pointers` pointers, then
    `ints` int64 values, then a stream, and returns a CUDA error code;
    `args` spells out any other list (`returns` its result type). The entry
    comes from the kernel library, built on first use, unless `lib` is
    given."""
    fn = getattr(kernel_lib() if lib is None else lib, f"tj_{name}")
    if args is None:
        args = ([ctypes.c_void_p] * pointers + [ctypes.c_int64] * ints
                + [ctypes.c_void_p])
    fn.argtypes, fn.restype = list(args), returns
    return fn
