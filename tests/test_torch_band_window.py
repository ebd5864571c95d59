"""The windowed entry points of kernels 1, 2 and 3 (`banded_window_sum`,
`banded_window_per_s`, `banded_window_first` in the port's
ops/band_compare.py) against the
chunk-array plain versions after the gathers, and against the JAX Pallas
kernels on the same gathered arrays, run here in interpret mode as
tests/test_band_join.py runs them. Inputs are made from a seed with numpy.
Exact: sums mod 2^32, h and fm element for element, S pad rows included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icde2019_gpu_join_tpu.ops import band_compare_pallas as P
from icde2019_gpu_join_tpu.ops import band_join as J
from icde2019_gpu_join_tpu_torch.ops import band_compare as B
from icde2019_gpu_join_tpu_torch.ops import band_join as T

LANES = 128
PAD = 0x7FFFFFFF   # the R-pad sortval; S pad rows carry it too


def _full(rng, shape):
    """Full-range int32 payloads: sums wrap."""
    return rng.randint(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _gathered(s_sv, s_pay, r_sv, r_pay, ids, lo, hi, r, w):
    """The chunk arrays the windows stand for, gathered in numpy: sk, sp
    [n, 128]; rk (unmasked, as the aggregate gathers it), rk_masked (R_PAD_SV
    outside the windows), rp (0 outside), gidx [n, w*128]."""
    nrb = r_sv.shape[0]
    n = ids.size
    raw = lo[ids].astype(np.int64)[:, None] + r * w + np.arange(w)
    valid = raw < hi[ids].astype(np.int64)[:, None]
    bidx = np.clip(raw, 0, nrb - 1)
    vcol = np.repeat(valid, LANES, axis=1)
    rk = r_sv[bidx].reshape(n, w * LANES)
    gidx = (bidx[:, :, None] * LANES + np.arange(LANES)).reshape(
        n, w * LANES).astype(np.int32)
    return dict(sk=s_sv[ids], sp=s_pay[ids], rk=rk,
                rk_masked=np.where(vcol, rk, PAD).astype(np.int32),
                rp=np.where(vcol, r_pay[bidx].reshape(n, w * LANES),
                            0).astype(np.int32),
                gidx=gidx)


def _window_refs(s_sv, s_pay, r_sv, r_pay, ids, lo, hi, r, w):
    """The two windowed plain versions from fresh accumulators: (sum, h, fm)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    acc = torch.zeros(1, dtype=torch.int32)
    B.banded_window_sum_ref(t(s_sv), t(s_pay), t(r_sv), t(r_pay),
                            t(ids.astype(np.int64)), t(lo), t(hi), r, w, acc)
    h = torch.zeros(s_sv.shape, dtype=torch.int32)
    fm = torch.full(s_sv.shape, PAD, dtype=torch.int32)
    B.banded_window_first_ref(t(s_sv), t(r_sv), t(ids.astype(np.int64)),
                              t(lo), t(hi), r, w, h, fm)
    return int(acc[0]), h.numpy(), fm.numpy()


def _chunk_refs(g, ids, nsb):
    """The chunk-array plain versions on the gathered arrays, scattered at
    the ids as band_join scatters them: (sum, h, fm)."""
    t = torch.from_numpy
    got = int(B.banded_compare_sum_ref(t(g["sk"]), t(g["sp"]), t(g["rk"]),
                                       t(g["rp"])))
    hc, fc = B.banded_compare_first_ref(t(g["sk"]), t(g["rk_masked"]),
                                        t(g["gidx"]))
    h = np.zeros((nsb, LANES), np.int32)
    fm = np.full((nsb, LANES), PAD, np.int32)
    h[ids] += hc.numpy()
    fm[ids] = np.minimum(fm[ids], fc.numpy())
    return got, h, fm


def _jax_kernels(g, ids, nsb):
    """JAX's Pallas kernels (interpret mode) on the same gathered arrays."""
    a = lambda k: jnp.asarray(g[k])
    got = int(P.banded_compare_sum(a("sk"), a("sp"), a("rk"), a("rp"),
                                   interpret=True))
    hc, fc = P.banded_compare_first(a("sk"), a("rk_masked"), a("gidx"),
                                    interpret=True)
    h = np.zeros((nsb, LANES), np.int32)
    fm = np.full((nsb, LANES), PAD, np.int32)
    h[ids] += np.asarray(hc)
    fm[ids] = np.minimum(fm[ids], np.asarray(fc))
    return got, h, fm


def _kernel_model(s_sv, s_pay, r_sv, r_pay, ids, lo, hi, r, w):
    """The CUDA kernels' arithmetic (csrc/band_compare.cu, plan_row and the
    window kernels) in numpy: only blocks before hi are compared; kernel 1
    skips the rest, kernel 3 adds them to the S rows whose key is the
    sentinel in one step, with the least gidx the first masked block's."""
    nrb = r_sv.shape[0]
    total = 0
    h = np.zeros(s_sv.shape, np.int64)
    fm = np.full(s_sv.shape, PAD, np.int64)
    for i in ids:
        base = int(lo[i]) + r * w
        valid = min(max(int(hi[i]) - base, 0), w)
        key = s_sv[i].astype(np.int64)
        t = np.zeros(LANES, np.int64)
        for k in range(valid):
            blk = min(max(base + k, 0), nrb - 1)
            eq = key[:, None] == r_sv[blk].astype(np.int64)[None, :]
            t += (eq * r_pay[blk].astype(np.int64)).sum(1)
            h[i] += eq.sum(1)
            g = blk * LANES + np.arange(LANES)
            fm[i] = np.minimum(fm[i], np.where(eq, g, PAD).min(1))
        total += int(((t & 0xFFFFFFFF) * (s_pay[i].astype(np.int64)
                                          & 0xFFFFFFFF)).sum())
        if valid < w:
            pad = key == PAD
            h[i][pad] += LANES * (w - valid)
            g0 = min(max(base + valid, 0), nrb - 1) * LANES
            fm[i][pad] = np.minimum(fm[i][pad], g0)
    wrapped = np.array([total & 0xFFFFFFFF], np.uint32).view(np.int32)[0]
    return int(wrapped), h.astype(np.int32), fm.astype(np.int32)


# ---- engine-made windows: sorted Zipf / uniform relations, real rounds -------

def _sorted_blocks(rng, kind, n_r, n_s):
    """Sorted, 128-padded (sortval, payload) views of both sides, as the
    engine makes them; full-range payloads; n_s no multiple of 128, so the
    last S block holds pad rows."""
    if kind == "zipf":
        rk = rng.randint(0, 48, n_r).astype(np.int32)     # runs of R keys
        sk = np.minimum(rng.zipf(1.4, n_s) - 1, 60).astype(np.int32)
    else:
        rk = rng.permutation(4 * n_r)[:n_r].astype(np.int32)
        sk = rk[rng.randint(0, n_r, n_s)]
    r_sv, r_p = T.sort_by_key(torch.from_numpy(rk),
                              torch.from_numpy(_full(rng, n_r)))
    s_sv, s_p = T.sort_by_key(torch.from_numpy(sk),
                              torch.from_numpy(_full(rng, n_s)))
    return [x.view(-1, LANES).numpy() for x in (s_sv, s_p, r_sv, r_p)]


ENGINE_CASES = [("zipf", 1, 0), ("zipf", 2, 1), ("zipf", 6, 2),
                ("uniform", 1, 3), ("uniform", 2, 4), ("uniform", 6, 5)]


@pytest.mark.parametrize("kind,w,seed", ENGINE_CASES)
def test_windowed_plain_versions_on_the_engine_schedule(kind, w, seed,
                                                        monkeypatch):
    """Every chunk of the probe schedule (small chunks, so each round has
    several): windowed plain versions = chunk plain versions after the
    gathers = the kernel model; the first chunk of round 0 and of the last
    round also = JAX's kernels."""
    rng = np.random.RandomState(seed)
    s_sv, s_pay, r_sv, r_pay = _sorted_blocks(rng, kind, 1900, 2300)
    nsb = s_sv.shape[0]
    monkeypatch.setattr(T, "_CHUNK_BLOCKS", 5)
    lo, hi, chunks = T._probe_schedule(torch.from_numpy(r_sv).view(-1),
                                       torch.from_numpy(s_sv).view(-1), w)
    lo, hi = lo.numpy(), hi.numpy()
    chunks = [(r, ids.numpy()) for r, ids in chunks]
    rounds = max(r for r, _ in chunks)
    if kind == "zipf":
        assert rounds >= 1   # rounds r > 0 happen
    with_jax = {0: chunks[0], rounds: next(c for c in chunks if c[0] == rounds)}
    for r, ids in chunks:
        args = (s_sv, s_pay, r_sv, r_pay, ids, lo, hi, r, w)
        got = _window_refs(*args)
        g = _gathered(*args)
        for want in (_chunk_refs(g, ids, nsb), _kernel_model(*args)):
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
        if with_jax.get(r) is not None and with_jax[r][1] is ids:
            want = _jax_kernels(g, ids, nsb)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])


# ---- edge windows --------------------------------------------------------------

def _edge_inputs(rng, w, nsb=12, nrb=7, key_range=9):
    """Keys from a narrow range (dense matches), full-range payloads; S pad
    rows and R pad rows (the sentinel); windows that are empty (lo == hi),
    that end at the last R block, and whose rounds run past it (clamped)."""
    s_sv = rng.randint(0, key_range, (nsb, LANES)).astype(np.int32)
    s_sv[-1, 70:] = PAD                      # the last S block's pad rows
    s_sv[3, :5] = PAD
    r_sv = rng.randint(0, key_range, (nrb, LANES)).astype(np.int32)
    r_sv[-1, 100:] = PAD                     # R pad rows
    lo = rng.randint(0, nrb, nsb).astype(np.int32)
    hi = np.minimum(lo + rng.randint(0, 3 * w + 2, nsb), nrb).astype(np.int32)
    lo[0] = hi[0] = 2                        # empty
    lo[1], hi[1] = nrb - 1, nrb              # the last block: r > 0 clamps
    lo[2], hi[2] = 0, nrb                    # all of R
    lo[-1], hi[-1] = nrb - 1, nrb            # S pad rows against R pad rows
    return s_sv, _full(rng, (nsb, LANES)), r_sv, _full(rng, (nrb, LANES)), lo, hi


EDGE_CASES = [(w, r, seed) for w in (1, 2, 6) for r in (0, 1, 3)
              for seed in (0, 1)]


@pytest.mark.parametrize("w,r,seed", EDGE_CASES)
def test_windowed_plain_versions_on_edge_windows(w, r, seed):
    """Permuted ids over every S block: the three plain forms and the
    kernel model agree, and JAX's kernels on the gathered arrays too."""
    rng = np.random.RandomState(100 * w + 10 * r + seed)
    s_sv, s_pay, r_sv, r_pay, lo, hi = _edge_inputs(rng, w)
    nsb = s_sv.shape[0]
    ids = rng.permutation(nsb)
    args = (s_sv, s_pay, r_sv, r_pay, ids, lo, hi, r, w)
    got = _window_refs(*args)
    g = _gathered(*args)
    for want in (_chunk_refs(g, ids, nsb), _jax_kernels(g, ids, nsb),
                 _kernel_model(*args)):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    # the edges occurred: masked columns matched S pad rows, and a masked
    # block past the last R block was clamped
    raw = lo[1] + r * w + np.arange(w)
    assert (raw >= r_sv.shape[0]).any() or r == 0
    assert got[1][-1, 70:].max() > 0


def test_windowed_sums_wrap():
    """One key everywhere, full-range payloads: the sum wraps mod 2^32 and
    still equals JAX's."""
    rng = np.random.RandomState(7)
    s_sv = np.zeros((6, LANES), np.int32)
    r_sv = np.zeros((4, LANES), np.int32)
    s_pay, r_pay = _full(rng, (6, LANES)), _full(rng, (4, LANES))
    lo = np.zeros(6, np.int32)
    hi = np.full(6, 4, np.int32)
    ids = np.arange(6)
    args = (s_sv, s_pay, r_sv, r_pay, ids, lo, hi, 0, 4)
    got = _window_refs(*args)
    g = _gathered(*args)
    exact = int((g["sp"].astype(np.int64).sum(1)
                 * g["rp"].astype(np.int64).sum(1)).sum())
    assert abs(exact) >= 2**32
    assert got[0] == _jax_kernels(g, ids, 6)[0] == _kernel_model(*args)[0]


def test_empty_round_changes_nothing():
    rng = np.random.RandomState(3)
    s_sv, s_pay, r_sv, r_pay, lo, hi = _edge_inputs(rng, 2)
    t = torch.from_numpy
    acc = torch.tensor([12345], dtype=torch.int32)
    h = t(rng.randint(0, 9, s_sv.shape).astype(np.int32))
    fm = t(rng.randint(0, 99, s_sv.shape).astype(np.int32))
    h0, fm0 = h.clone(), fm.clone()
    ids = torch.zeros(0, dtype=torch.int64)
    before = dict(B.LAUNCHES)
    B.banded_window_sum(t(s_sv), t(s_pay), t(r_sv), t(r_pay), ids, t(lo),
                        t(hi), 1, 2, acc)
    B.banded_window_first(t(s_sv), t(r_sv), ids, t(lo), t(hi), 1, 2, h, fm)
    B.banded_window_per_s(t(s_sv), t(r_sv), t(r_pay), ids, t(lo), t(hi), 1, 2,
                          h, fm)
    assert int(acc[0]) == 12345
    assert torch.equal(h, h0) and torch.equal(fm, fm0)
    assert B.LAUNCHES == before


def test_first_accumulates_into_its_outputs():
    """h adds and fm takes the minimum with what the caller holds: two
    rounds over the same ids give the sum and the minimum of each."""
    rng = np.random.RandomState(11)
    s_sv, _, r_sv, _, lo, hi = _edge_inputs(rng, 1)
    t = torch.from_numpy
    ids = t(rng.permutation(s_sv.shape[0]).astype(np.int64))
    h = torch.zeros(s_sv.shape, dtype=torch.int32)
    fm = torch.full(s_sv.shape, PAD, dtype=torch.int32)
    parts = []
    for r in (0, 1):
        hr = torch.zeros_like(h)
        fr = torch.full_like(fm, PAD)
        B.banded_window_first(t(s_sv), t(r_sv), ids, t(lo), t(hi), r, 1, hr, fr)
        parts.append((hr, fr))
        B.banded_window_first(t(s_sv), t(r_sv), ids, t(lo), t(hi), r, 1, h, fm)
    assert torch.equal(h, parts[0][0] + parts[1][0])
    assert torch.equal(fm, torch.minimum(parts[0][1], parts[1][1]))


# ---- the probes through the windowed entry points ---------------------------

def _chunk_windows(r_sv, s_sv, w):
    """The probe schedule's chunks with their windows spelled out, as the
    probes gathered them before the windowed entry points: per chunk the S
    block ids, the R block indices [n, w] (clamped) and whether each lies
    inside its block's window."""
    nrb = r_sv.shape[0] // LANES
    lo, hi, chunks = T._probe_schedule(r_sv, s_sv, w)
    for r, ids in chunks:
        yield (ids, *B.window_plan(ids, lo, hi, r, w, nrb))


@pytest.mark.parametrize("kind,w,seed", ENGINE_CASES)
def test_probe_and_descriptors_equal_their_chunk_forms(kind, w, seed):
    """`banded_probe(..., "mul")` and `banded_match_descriptors` equal the
    chunk-array kernels' plain versions over `_probe_chunks`' gathers, the
    form they had before the windowed entry points."""
    rng = np.random.RandomState(seed)
    s_sv, s_pay, r_sv, r_pay = (torch.from_numpy(x).view(-1) for x in
                                _sorted_blocks(rng, kind, 1900, 2300))
    nsb = s_sv.shape[0] // LANES
    want_sum = 0
    want_h = torch.zeros((nsb, LANES), dtype=torch.int32)
    want_fm = torch.full((nsb, LANES), PAD, dtype=torch.int32)
    lane = torch.arange(LANES, dtype=torch.int32)
    for ids, bidx, valid in _chunk_windows(r_sv, s_sv, w):
        n = ids.numel()
        rp = B.gather_window(r_pay.view(-1, LANES), bidx, valid, 0)
        rk = r_sv.view(-1, LANES)[bidx.view(-1)].view(rp.shape)
        want_sum += int(B.banded_compare_sum_ref(
            s_sv.view(-1, LANES)[ids], s_pay.view(-1, LANES)[ids], rk, rp))
        gidx = (bidx.to(torch.int32)[:, :, None] * LANES + lane).view(n, -1)
        hc, fc = B.banded_compare_first_ref(
            s_sv.view(-1, LANES)[ids],
            B.gather_window(r_sv.view(-1, LANES), bidx, valid, PAD), gidx)
        want_h.index_add_(0, ids, hc)
        want_fm[ids] = torch.minimum(want_fm[ids], fc)
    got = T.banded_probe(r_sv, r_pay, s_sv, s_pay, w, "mul")
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(np.array([want_sum & 0xFFFFFFFF],
                                    np.uint32).view(np.int32)[0])
    h, fm = T.banded_match_descriptors(r_sv, s_sv, w)
    assert torch.equal(h, want_h.view(-1)) and torch.equal(fm, want_fm.view(-1))


@pytest.mark.parametrize("impl", ["lax", "merge", "packed"])
def test_sorted_inputs_start_on_16_byte_boundaries(impl):
    """Every path reaches the windowed kernels with the output of a sort:
    each sort gives fresh, aligned arrays, the block views included."""
    rng = np.random.RandomState(5)
    keys = torch.from_numpy(rng.randint(1, 1 << 20, 1 << 14).astype(np.int32))
    sv, pay = T.sort_by_key(keys, torch.from_numpy(_full(rng, 1 << 14)), impl)
    for x in (sv, pay, sv.view(-1, LANES), pay.view(-1, LANES)):
        assert x.data_ptr() % 16 == 0 and x.is_contiguous()


# ---- what the wrappers refuse ---------------------------------------------------

def _valid_args(rng=None):
    rng = rng or np.random.RandomState(2)
    s_sv, s_pay, r_sv, r_pay, lo, hi = _edge_inputs(rng, 2)
    t = torch.from_numpy
    return dict(s_svb=t(s_sv), s_payb=t(s_pay), r_svb=t(r_sv), r_payb=t(r_pay),
                ids=torch.arange(s_sv.shape[0], dtype=torch.int64), lo=t(lo),
                hi=t(hi), r=0, w=2, acc=torch.zeros(1, dtype=torch.int32),
                h=torch.zeros(s_sv.shape, dtype=torch.int32),
                t=torch.zeros(s_sv.shape, dtype=torch.int32),
                fm=torch.full(s_sv.shape, PAD, dtype=torch.int32))


_SUM_KEYS = ("s_svb", "s_payb", "r_svb", "r_payb", "ids", "lo", "hi", "r",
             "w", "acc")
_FIRST_KEYS = ("s_svb", "r_svb", "ids", "lo", "hi", "r", "w", "h", "fm")
_PER_S_KEYS = ("s_svb", "r_svb", "r_payb", "ids", "lo", "hi", "r", "w", "h",
               "t")


def _misaligned(x):
    """The same values one int32 into a larger buffer: contiguous, but 4
    bytes past a 16-byte boundary."""
    buf = torch.zeros(x.numel() + 1, dtype=x.dtype)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


def _non_contiguous(x):
    return x.t().contiguous().t() if x.dim() == 2 else x.repeat(2)[::2]


def _set(key, make):
    """A bad input: argument `key` replaced by make(args)."""
    return key, lambda a: a.update({key: make(a)})


def _poke(i, value):
    """A bad input: ids[i] set to value(args)."""
    return "ids", lambda a: a["ids"].__setitem__(i, value(a))


BAD = {
    "s_svb int64": _set("s_svb", lambda a: a["s_svb"].long()),
    "r_payb int64": _set("r_payb", lambda a: a["r_payb"].long()),
    "ids int32": _set("ids", lambda a: a["ids"].int()),
    "lo int64": _set("lo", lambda a: a["lo"].long()),
    "acc int64": _set("acc", lambda a: a["acc"].long()),
    "h int64": _set("h", lambda a: a["h"].long()),
    "t int64": _set("t", lambda a: a["t"].long()),
    "t misaligned": _set("t", lambda a: _misaligned(a["t"])),
    "t other rows": _set("t", lambda a: a["t"][:-1].clone()),
    "s_svb misaligned": _set("s_svb", lambda a: _misaligned(a["s_svb"])),
    "s_payb misaligned": _set("s_payb", lambda a: _misaligned(a["s_payb"])),
    "r_svb misaligned": _set("r_svb", lambda a: _misaligned(a["r_svb"])),
    "fm misaligned": _set("fm", lambda a: _misaligned(a["fm"])),
    "r_svb non-contiguous": _set("r_svb",
                                 lambda a: _non_contiguous(a["r_svb"])),
    "s_svb non-contiguous": _set("s_svb",
                                 lambda a: _non_contiguous(a["s_svb"])),
    "ids non-contiguous": _set("ids", lambda a: _non_contiguous(a["ids"])),
    "ids past the end": _poke(3, lambda a: a["s_svb"].shape[0]),
    "ids negative": _poke(0, lambda a: -1),
    "s_svb 64 wide": _set("s_svb", lambda a: a["s_svb"][:, :64].contiguous()),
    "r_payb other rows": _set("r_payb", lambda a: a["r_payb"][:-1].clone()),
    "lo short": _set("lo", lambda a: a["lo"][:-1].clone()),
    "h other rows": _set("h", lambda a: a["h"][:-1].clone()),
    "acc two words": _set("acc", lambda a: torch.zeros(2, dtype=torch.int32)),
    "no R block": _set("r_svb", lambda a: a["r_svb"][:0].clone()),
    "w 0": _set("w", lambda a: 0),
    "r negative": _set("r", lambda a: -1),
    "hi on meta": _set("hi", lambda a: a["hi"].to("meta")),
}
WRAPPERS = {"sum": (B.banded_window_sum, _SUM_KEYS),
            "per_s": (B.banded_window_per_s, _PER_S_KEYS),
            "first": (B.banded_window_first, _FIRST_KEYS)}


@pytest.mark.parametrize("which,bad", [
    (which, bad) for which, (_, keys) in WRAPPERS.items()
    for bad, (key, _) in sorted(BAD.items()) if key in keys])
def test_windowed_wrappers_reject_bad_inputs(which, bad):
    fn, keys = WRAPPERS[which]
    args = _valid_args()
    fn(*(args[k] for k in keys))    # the untouched arguments pass
    BAD[bad][1](args)
    with pytest.raises(ValueError):
        fn(*(args[k] for k in keys))


@pytest.mark.parametrize("name", ["sum", "first"])
@pytest.mark.parametrize("bad", ["width", "misaligned"])
def test_chunk_wrappers_of_kernels_1_and_3_take_whole_blocks(name, bad):
    """The chunk entry points run the windowed body on 128-column blocks:
    WB must be a multiple of 128 and every array on a 16-byte boundary."""
    rng = np.random.RandomState(4)
    t = torch.from_numpy
    sk = t(rng.randint(0, 9, (4, LANES)).astype(np.int32))
    wb = 200 if bad == "width" else 256
    rk = t(rng.randint(0, 9, (4, wb)).astype(np.int32))
    rx = t(_full(rng, (4, wb)))
    if bad == "misaligned":
        rk = _misaligned(rk)
    with pytest.raises(ValueError):
        if name == "sum":
            B.banded_compare_sum(sk, t(_full(rng, (4, LANES))), rk, rx)
        else:
            B.banded_compare_first(sk, rk, rx)


def test_cpu_tensors_add_no_launch():
    args = _valid_args()
    before = dict(B.LAUNCHES)
    B.banded_window_sum(*(args[k] for k in _SUM_KEYS))
    B.banded_window_per_s(*(args[k] for k in _PER_S_KEYS))
    B.banded_window_first(*(args[k] for k in _FIRST_KEYS))
    assert B.LAUNCHES == before
    assert {"banded_window_sum", "banded_window_per_s",
            "banded_window_first"} <= set(B.LAUNCHES)


# ---- kernel 2 windowed (`banded_window_per_s`) ---------------------------------

def _wrap32(x) -> np.ndarray:
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _per_s_window_ref(s_sv, r_sv, r_pay, ids, lo, hi, r, w):
    """The windowed plain version from zero accumulators: (h, t)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    h = torch.zeros(s_sv.shape, dtype=torch.int32)
    tt = torch.zeros_like(h)
    B.banded_window_per_s_ref(t(s_sv), t(r_sv), t(r_pay),
                              t(ids.astype(np.int64)), t(lo), t(hi), r, w, h,
                              tt)
    return h.numpy(), tt.numpy()


def _per_s_scattered(hc, tc, ids, nsb):
    h = np.zeros((nsb, LANES), np.int32)
    t = np.zeros((nsb, LANES), np.int32)
    h[ids], t[ids] = np.asarray(hc), np.asarray(tc)
    return h, t


def _per_s_chunk_ref(g, ids, nsb):
    """The chunk plain version on the gathered, masked arrays."""
    hc, tc = B.banded_compare_per_s_ref(torch.from_numpy(g["sk"]),
                                        torch.from_numpy(g["rk_masked"]),
                                        torch.from_numpy(g["rp"]))
    return _per_s_scattered(hc.numpy(), tc.numpy(), ids, nsb)


def _per_s_jax(g, ids, nsb):
    """JAX's Pallas kernel (interpret mode) on the same gathered arrays."""
    hc, tc = P.banded_compare_per_s(jnp.asarray(g["sk"]),
                                    jnp.asarray(g["rk_masked"]),
                                    jnp.asarray(g["rp"]), interpret=True)
    return _per_s_scattered(hc, tc, ids, nsb)


def _per_s_model(s_sv, r_sv, r_pay, ids, lo, hi, r, w):
    """The CUDA kernel's arithmetic (window_per_s_kernel): only blocks
    before hi are compared, a count and a payload add a match; the masked
    blocks add 128 each to the count of the S rows whose key is the
    sentinel, in one step, and nothing to t."""
    nrb = r_sv.shape[0]
    h = np.zeros(s_sv.shape, np.int64)
    t = np.zeros(s_sv.shape, np.int64)
    for i in ids:
        base = int(lo[i]) + r * w
        valid = min(max(int(hi[i]) - base, 0), w)
        key = s_sv[i].astype(np.int64)
        for k in range(valid):
            blk = min(max(base + k, 0), nrb - 1)
            eq = key[:, None] == r_sv[blk].astype(np.int64)[None, :]
            h[i] += eq.sum(1)
            t[i] += (eq * r_pay[blk].astype(np.int64)).sum(1)
        if valid < w:
            h[i][key == PAD] += LANES * (w - valid)
    return _wrap32(h), _wrap32(t)


def _equal_per_s(got, *wants):
    for want in wants:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kind,w,seed", ENGINE_CASES)
def test_windowed_per_s_on_the_engine_schedule(kind, w, seed, monkeypatch):
    """Every chunk of the probe schedule: the windowed plain version = the
    chunk plain version after the gathers = the kernel model; the first
    chunk of round 0 and of the last round also = JAX's kernel."""
    rng = np.random.RandomState(seed)
    s_sv, _, r_sv, r_pay = _sorted_blocks(rng, kind, 1900, 2300)
    nsb = s_sv.shape[0]
    monkeypatch.setattr(T, "_CHUNK_BLOCKS", 5)
    lo, hi, chunks = T._probe_schedule(torch.from_numpy(r_sv).view(-1),
                                       torch.from_numpy(s_sv).view(-1), w)
    lo, hi = lo.numpy(), hi.numpy()
    chunks = [(r, ids.numpy()) for r, ids in chunks]
    rounds = max(r for r, _ in chunks)
    jax_chunks = {0: chunks[0][1],
                  rounds: next(ids for r, ids in chunks if r == rounds)}
    for r, ids in chunks:
        args = (s_sv, r_sv, r_pay, ids, lo, hi, r, w)
        got = _per_s_window_ref(*args)
        g = _gathered(s_sv, s_sv, r_sv, r_pay, ids, lo, hi, r, w)
        _equal_per_s(got, _per_s_chunk_ref(g, ids, nsb), _per_s_model(*args))
        if jax_chunks.get(r) is ids:
            _equal_per_s(got, _per_s_jax(g, ids, nsb))


@pytest.mark.parametrize("w,r,seed", EDGE_CASES)
def test_windowed_per_s_on_edge_windows(w, r, seed):
    """Permuted ids over every S block, empty and clamped windows, S and R
    pad rows: the windowed and chunk plain versions, JAX's kernel and the
    kernel model agree, S pad rows included."""
    rng = np.random.RandomState(100 * w + 10 * r + seed + 7)
    s_sv, _, r_sv, r_pay, lo, hi = _edge_inputs(rng, w)
    nsb = s_sv.shape[0]
    ids = rng.permutation(nsb)
    args = (s_sv, r_sv, r_pay, ids, lo, hi, r, w)
    got = _per_s_window_ref(*args)
    g = _gathered(s_sv, s_sv, r_sv, r_pay, ids, lo, hi, r, w)
    _equal_per_s(got, _per_s_chunk_ref(g, ids, nsb), _per_s_jax(g, ids, nsb),
                 _per_s_model(*args))
    # masked columns and R pad rows matched the S pad rows
    assert got[0][-1, 70:].min() > 0


def test_windowed_per_s_sums_wrap():
    """One key everywhere, full-range payloads: t wraps mod 2^32 and still
    equals JAX's."""
    rng = np.random.RandomState(8)
    s_sv = np.zeros((6, LANES), np.int32)
    r_sv = np.zeros((4, LANES), np.int32)
    r_pay = _full(rng, (4, LANES))
    lo, hi, ids = np.zeros(6, np.int32), np.full(6, 4, np.int32), np.arange(6)
    args = (s_sv, r_sv, r_pay, ids, lo, hi, 0, 4)
    got = _per_s_window_ref(*args)
    g = _gathered(s_sv, s_sv, r_sv, r_pay, ids, lo, hi, 0, 4)
    assert abs(int(g["rp"][0].astype(np.int64).sum())) >= 2**31
    _equal_per_s(got, _per_s_jax(g, ids, 6), _per_s_model(*args))
    assert (got[0] == 4 * LANES).all()


def test_per_s_accumulates_into_its_outputs():
    """h and t add to what the caller holds: two rounds over the same ids
    give the sum of each."""
    rng = np.random.RandomState(12)
    s_sv, _, r_sv, r_pay, lo, hi = _edge_inputs(rng, 1)
    t = torch.from_numpy
    ids = t(rng.permutation(s_sv.shape[0]).astype(np.int64))
    h = t(rng.randint(0, 9, s_sv.shape).astype(np.int32))
    tt = t(_full(rng, s_sv.shape))
    start = (h.clone(), tt.clone())
    parts = []
    for r in (0, 1):
        hr, tr_ = torch.zeros_like(h), torch.zeros_like(h)
        B.banded_window_per_s(t(s_sv), t(r_sv), t(r_pay), ids, t(lo), t(hi), r,
                              1, hr, tr_)
        parts.append((hr, tr_))
        B.banded_window_per_s(t(s_sv), t(r_sv), t(r_pay), ids, t(lo), t(hi), r,
                              1, h, tt)
    for i, got in enumerate((h, tt)):
        want = start[i].long() + parts[0][i].long() + parts[1][i].long()
        np.testing.assert_array_equal(got.numpy(), _wrap32(want.numpy()))


def _engine_tables(rng, kind, n_r=1900, n_s=2300):
    """Raw relations as `_sorted_blocks` makes them: runs of R keys against
    a Zipf S, or PK-FK; full-range payloads."""
    if kind == "zipf":
        rk = rng.randint(0, 48, n_r).astype(np.int32)
        sk = np.minimum(rng.zipf(1.4, n_s) - 1, 60).astype(np.int32)
    else:
        rk = rng.permutation(4 * n_r)[:n_r].astype(np.int32)
        sk = rk[rng.randint(0, n_r, n_s)]
    return rk, _full(rng, n_r), sk, _full(rng, n_s)


@pytest.mark.parametrize("kind,w,seed", ENGINE_CASES)
def test_probe_per_s_and_add_equal_their_chunk_forms(kind, w, seed):
    """`banded_probe_per_s` and `banded_probe(..., "add")` equal the chunk
    plain version over the gathered chunks, the form they had before the
    windowed entry point, S pad rows included."""
    rng = np.random.RandomState(seed + 20)
    s_sv, s_pay, r_sv, r_pay = (torch.from_numpy(x).view(-1) for x in
                                _sorted_blocks(rng, kind, 1900, 2300))
    nsb = s_sv.shape[0] // LANES
    want_h = torch.zeros((nsb, LANES), dtype=torch.int32)
    want_t = torch.zeros_like(want_h)
    for ids, bidx, valid in _chunk_windows(r_sv, s_sv, w):
        hc, tc = B.banded_compare_per_s_ref(
            s_sv.view(-1, LANES)[ids],
            B.gather_window(r_sv.view(-1, LANES), bidx, valid, PAD),
            B.gather_window(r_pay.view(-1, LANES), bidx, valid, 0))
        want_h.index_add_(0, ids, hc)
        want_t.index_add_(0, ids, tc)
    h, t = T.banded_probe_per_s(r_sv, r_pay, s_sv, w)
    assert torch.equal(h, want_h.view(-1)) and torch.equal(t, want_t.view(-1))
    total = (want_t.view(-1).long().sum()
             + (want_h.view(-1).long() * s_pay.long()).sum())
    got = T.banded_probe(r_sv, r_pay, s_sv, s_pay, w, "add")
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(_wrap32([int(total) & 0xFFFFFFFF])[0])


@pytest.mark.parametrize("kind,w,seed", ENGINE_CASES)
def test_probe_per_s_matches_jax_with_pad_rows(kind, w, seed):
    """The port's per-S probe against JAX's on the same sorted inputs: t on
    every row and h on every real row bit for bit, the S pad rows of the
    last block included for t. A pad row's h counts the sentinel columns
    its block meets: the port's its own rounds', JAX's also those of the
    rounds its block sits out inside a chunk that still has active rows
    (all W blocks masked), so JAX's exceeds the port's by whole rounds."""
    rng = np.random.RandomState(seed + 30)
    s_sv, _, r_sv, r_pay = (x.reshape(-1) for x in
                            _sorted_blocks(rng, kind, 1900, 2300))
    jh, jt = J.banded_probe_per_s(jnp.asarray(r_sv), jnp.asarray(r_pay),
                                  jnp.asarray(s_sv), window_blocks=w)
    th, tt = T.banded_probe_per_s(*map(torch.from_numpy, (r_sv, r_pay, s_sv)),
                                  w)
    n = 2300
    assert (s_sv[n:] == PAD).all() and th[n:].min() > 0
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(th[:n].numpy(), np.asarray(jh)[:n])
    extra = np.asarray(jh)[n:].astype(np.int64) - th[n:].numpy()
    assert (extra >= 0).all() and (extra % (LANES * w) == 0).all()


@pytest.mark.parametrize("kind,w,seed", ENGINE_CASES)
def test_late_aggregate_matches_jax_on_engine_relations(kind, w, seed):
    rng = np.random.RandomState(seed + 40)
    rk, rp, sk, sp = _engine_tables(rng, kind)
    got = T.banded_join_late_aggregate(*map(torch.from_numpy, (rk, rp, sk, sp)),
                                       window_blocks=w)
    want = J.banded_join_late_aggregate(*map(jnp.asarray, (rk, rp, sk, sp)),
                                        window_blocks=w)
    assert int(got) == int(want)
