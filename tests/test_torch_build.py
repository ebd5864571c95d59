"""The port's kernel build (ops/_build.py) with a stand-in for nvcc: one
compile per source, then one link; stale checks; compiler errors raised."""

import os
import stat

import pytest

from icde2019_gpu_join_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
out=""
for a in "$@"; do
  case "$a" in *bad.cu) echo "error: bad source" >&2; exit 1;; esac
done
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo built > "$out"
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// kernel\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_build, "KERNEL_LIB", str(build / "lib.so"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return csrc, build, log


def test_each_source_compiles_apart_then_one_link(fake_tree):
    csrc, build, log = fake_tree
    assert _build.build_kernels() > 0
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == 2 and len(calls) == 3
    for name, call in zip(("a.cu", "b.cu"), sorted(compiles, key=lambda c: c[-4:])):
        assert call.endswith(str(csrc / name))
        assert "arch=compute_90a,code=sm_90a" in call
    link = calls[-1]
    assert link.startswith("-shared") and link.count(".o") == 2
    assert os.listdir(build) == ["lib.so"]          # objects removed
    assert _build.build_kernels() == 0.0             # up to date


def test_a_newer_source_rebuilds(fake_tree):
    csrc, _, log = fake_tree
    _build.build_kernels()
    later = os.path.getmtime(_build.KERNEL_LIB) + 10
    os.utime(csrc / "b.cu", (later, later))
    assert _build.build_kernels() > 0
    assert len(log.read_text().splitlines()) == 6


def test_a_failed_compile_raises_with_the_compiler_output(fake_tree):
    csrc, build, _ = fake_tree
    (csrc / "bad.cu").write_text("// broken\n")
    with pytest.raises(RuntimeError, match="error: bad source"):
        _build.build_kernels()
    assert not os.path.exists(_build.KERNEL_LIB)
    assert not [f for f in os.listdir(build) if f.endswith(".o")]
