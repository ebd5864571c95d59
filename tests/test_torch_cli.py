"""The port's CLI (icde2019_gpu_join_tpu_torch/cli.py) against the JAX
package's `cli.main` on the same arguments: the `N results` line of each
flag set, and the .bin datasets each package writes, byte for byte. Each
package writes its datasets into its own `tmp_path` directory through
TPU_JOIN_DATA_DIR (the cache is named by size alone, and tests/test_cli.py
shares `data/`)."""

import contextlib
import io
import json

import numpy as np
import pytest

from icde2019_gpu_join_tpu import cli as jcli
from icde2019_gpu_join_tpu_torch import cli as tcli
from icde2019_gpu_join_tpu_torch.config import EngineConfig
from icde2019_gpu_join_tpu_torch.models import joins
from icde2019_gpu_join_tpu_torch.utils import datasets, oracle

SIZES = ["-R", "4000", "-S", "16000", "--seed", "7"]


def _run(main, argv, data_dir, monkeypatch, **kw):
    monkeypatch.setenv("TPU_JOIN_DATA_DIR", str(data_dir))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    assert rc == 0
    return out.getvalue().splitlines()


def _result(lines):
    found = [line for line in lines if line.endswith(" results")]
    assert len(found) == 1, lines
    return found[0]


def _bins(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.suffix == ".bin"}


FLAG_SETS = {
    "b7": ["-b", "7", "-a", "HJC"],
    "b8": ["-b", "8"],
    "multipliers": ["-b", "7", "-x", "2", "-y", "3"],
    "multipliers_b8": ["-b", "8", "-x", "2", "-y", "2"],
    "full_range": ["-b", "7", "--full-range"],
    "non_unique": ["-b", "7", "--non-unique"],
    "zipf": ["-b", "7", "-s", "1.05"],
    "ignored_flags": ["-b", "7", "-t", "32", "-v", "2", "-m", "49152",
                      "-p", "4", "-w", "1"],
}


@pytest.mark.parametrize("name", FLAG_SETS)
def test_result_line_and_datasets_equal_jax(tmp_path, monkeypatch, name):
    argv = FLAG_SETS[name] + SIZES
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _run(jcli.main, argv, tmp_path / "jax", monkeypatch)
    got = _run(tcli.main, argv, tmp_path / "port", monkeypatch, device="cpu")
    assert _result(got) == _result(want)
    assert got[0] == want[0]                    # the INPUT line
    assert _bins(tmp_path / "port") == _bins(tmp_path / "jax")
    assert _bins(tmp_path / "port")


def test_full_range_keys_reach_2_to_31(tmp_path, monkeypatch):
    """--full-range draws PK keys from [0, 2^31 - 1): the result line holds
    for keys far past the unique range."""
    lines = _run(tcli.main, ["-b", "7", "--full-range"] + SIZES, tmp_path,
                 monkeypatch, device="cpu")
    rk = datasets.read_bin(str(tmp_path / "pk_R4000.bin"), 4000)
    sk = datasets.read_bin(str(tmp_path / "fk_S16000_pk_R4000.bin"), 16000)
    assert rk.max() > 2**30
    assert _result(lines) == f"{oracle.join_count(rk, sk)} results"


def test_materialize_line_is_the_match_count(tmp_path, monkeypatch):
    lines = _run(tcli.main, ["-b", "7", "--materialize"] + SIZES, tmp_path,
                 monkeypatch, device="cpu")
    rk, sk = datasets.make_pk_fk(4000, 16000, 0.0, 7)
    assert _result(lines) == f"{oracle.join_count(rk, sk)} results"


@pytest.mark.slow
def test_materialize_line_equals_jax(tmp_path, monkeypatch):
    """JAX's materialize into its default 2^24 slots takes half a minute on
    the CPU."""
    argv = ["-b", "7", "--materialize"] + SIZES
    want = _run(jcli.main, argv, tmp_path, monkeypatch)
    got = _run(tcli.main, argv, tmp_path, monkeypatch, device="cpu")
    assert _result(got) == _result(want)


def test_json_report(tmp_path, monkeypatch):
    lines = _run(tcli.main, ["-b", "7", "--json"] + SIZES, tmp_path,
                 monkeypatch, device="cpu")
    rep = json.loads(lines[-1])
    assert f"{rep['result']} results" == _result(lines)
    assert rep["elapsed_s"] > 0 and rep["phases"]["join"]["seconds"] > 0
    assert [line.split(" is ")[0] for line in lines[2:5]] == [
        "Partition throughput", "Join throughput", "Total throughput"]


def test_oversized_probe_side_streams_from_host_memory(tmp_path, monkeypatch):
    """With the resident limit under |S| the CLI hands host relations to
    the dispatcher, which streams S; the line is the in-memory one."""
    base = _run(tcli.main, ["-b", "7"] + SIZES, tmp_path, monkeypatch,
                device="cpu")
    seen = []
    real = joins.clustered_probe_join

    def spy(r, s, **kw):
        seen.append((r.device.type, s.device.type))
        return real(r, s, **kw)

    monkeypatch.setattr(joins, "EngineConfig",
                        lambda: EngineConfig(resident_limit_rows=8000))
    monkeypatch.setattr(tcli, "clustered_probe_join", spy)
    assert tcli.dispatch_regime(4000, 16000) == "streaming"
    lines = _run(tcli.main, ["-b", "7"] + SIZES, tmp_path, monkeypatch,
                 device="cpu")
    assert _result(lines) == _result(base)
    assert seen == [("cpu", "cpu")]          # one run, no warm-up


def test_unknown_benchmark_exits():
    with pytest.raises(SystemExit, match="only -b 7"):
        tcli.main(["-b", "3"], device="cpu")


def test_file_input(tmp_path, monkeypatch):
    rk = np.arange(100, dtype=np.int32)[::-1].copy()
    sk = np.repeat(np.arange(50, dtype=np.int32), 4)
    datasets.write_bin(str(tmp_path / "r.bin"), rk)
    datasets.write_bin(str(tmp_path / "s.bin"), sk)
    argv = ["-b", "7", "--file", "-k", str(tmp_path / "r.bin"), "-l",
            str(tmp_path / "s.bin"), "-R", "100", "-S", "200"]
    want = _run(jcli.main, argv, tmp_path, monkeypatch)
    got = _run(tcli.main, argv, tmp_path, monkeypatch, device="cpu")
    assert _result(got) == _result(want) == "200 results"


def test_parser_flags_equal_jax():
    ours = {a.dest: (a.option_strings, a.default)
            for a in tcli.build_parser()._actions}
    theirs = {a.dest: (a.option_strings, a.default)
              for a in jcli.build_parser()._actions}
    assert ours == theirs
