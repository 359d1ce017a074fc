"""The port's native distil library (peasoup_tpu_torch/native) against the
JAX package's (peasoup_tpu/native), entry point by entry point, bitwise,
on seeded inputs with exact S/N ties, empty segments and edge lists past
the first edge buffer; the port's distillers against the JAX package's
with both libraries on; the port's segmented per-DM distil against its
per-trial loop; and the build itself (two processes at once, and a
failed build raising).

Both libraries are built from the same source by the same g++, so
libstdc++'s std::sort arranges exact ties alike in both, and the sort
permutations must agree bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import peasoup_tpu.native as jax_native
from peasoup_tpu.core.candidates import Candidate as JaxCandidate
from peasoup_tpu.pipeline import distill as jax_distill
from peasoup_tpu_torch import native
from peasoup_tpu_torch.core.candidates import Candidate
from peasoup_tpu_torch.pipeline import distill, search

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    if not jax_native.available():
        pytest.skip("the JAX package's native library did not build")
    native.load()


def _snrs(rng, n, levels=6):
    """S/N values drawn from a few levels, so most of them tie exactly."""
    return (8.0 + rng.integers(0, levels, size=n)).astype(np.float32)


def _seg_off(rng, nseg, max_len):
    """Segment offsets with empty segments among the full ones."""
    lens = rng.integers(0, max_len + 1, size=nseg)
    lens[:: 3] = 0
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def _harmonic_freqs(rng, n):
    """Frequencies with harmonic relatives: fundamentals times small
    ratios, within the distil's tolerance or just outside it."""
    base = rng.uniform(1.0, 50.0, size=max(n // 6, 1))
    ratio = rng.choice([1.0, 2.0, 3.0, 0.5, 1.5, 4.0 / 3.0], size=n)
    jitter = 1.0 + rng.choice([0.0, 3e-5, -3e-5, 2e-4], size=n)
    return rng.choice(base, size=n) * ratio * jitter


@pytest.mark.parametrize("n", [0, 1, 16, 17, 100, 2000])
def test_snr_sort_perm(n):
    snrs = _snrs(np.random.default_rng(n), n)
    got = native.snr_sort_perm(snrs)
    np.testing.assert_array_equal(got, jax_native.snr_sort_perm(snrs))
    assert np.all(np.diff(snrs[got]) <= 0)


def test_snr_sort_perm_seg():
    rng = np.random.default_rng(3)
    seg_off = _seg_off(rng, 40, 60)
    snrs = _snrs(rng, int(seg_off[-1]))
    got = native.snr_sort_perm_seg(snrs, seg_off)
    np.testing.assert_array_equal(got, jax_native.snr_sort_perm_seg(snrs, seg_off))
    for b, e in zip(seg_off[:-1], seg_off[1:]):
        assert sorted(got[b:e]) == list(range(b, e))


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fractional", [True, False])
@pytest.mark.parametrize("keep_related", [True, False])
def test_harmonic_distill(fractional, keep_related):
    rng = np.random.default_rng(7)
    n = 300
    freqs = _harmonic_freqs(rng, n)
    nhs = rng.integers(0, 5, size=n).astype(np.int32)
    args = (freqs, nhs, 1e-4, 16, fractional, keep_related)
    got = native.harmonic_distill(*args)
    _assert_same(got, jax_native.harmonic_distill(*args))
    assert 0 < got[0].sum() < n


def test_harmonic_distill_grows_the_edge_buffer():
    # 100 candidates at one frequency, nh 4: every pair matches on 16
    # (jj, kk) pairs, 1,584 edges past the first buffer's 1,024
    n = 100
    freqs = np.full(n, 7.25)
    nhs = np.full(n, 4, dtype=np.int32)
    args = (freqs, nhs, 1e-4, 16, True, True)
    got = native.harmonic_distill(*args)
    assert len(got[1]) == 16 * (n - 1) > max(4 * n, 1024)
    _assert_same(got, jax_native.harmonic_distill(*args))


@pytest.mark.parametrize("fractional", [True, False])
def test_harmonic_distill_seg(fractional):
    rng = np.random.default_rng(11)
    seg_off = _seg_off(rng, 30, 50)
    n = int(seg_off[-1])
    freqs = _harmonic_freqs(rng, n)
    nhs = rng.integers(0, 5, size=n).astype(np.int32)
    args = (freqs, nhs, seg_off, 1e-4, 16, fractional)
    got = native.harmonic_distill_seg(*args)
    np.testing.assert_array_equal(got, jax_native.harmonic_distill_seg(*args))
    assert 0 < got.sum() < n


def _accel_rows(rng, n):
    freqs = _harmonic_freqs(rng, n)
    accs = rng.choice([-5.0, -2.5, 0.0, 2.5, 5.0], size=n)
    return freqs, accs


@pytest.mark.parametrize("keep_related", [True, False])
def test_accel_distill(keep_related):
    rng = np.random.default_rng(13)
    freqs, accs = _accel_rows(rng, 400)
    args = (freqs, accs, 600.0 / 299792458.0, 1e-4, keep_related)
    got = native.accel_distill(*args)
    _assert_same(got, jax_native.accel_distill(*args))
    assert 0 < got[0].sum() < len(freqs)


def test_accel_distill_seg():
    # empty segments among full ones, and one segment of 1,200 rows at one
    # frequency, all absorbed by its head: edges carry global row ids
    rng = np.random.default_rng(17)
    seg_off = np.array([0, 0, 40, 40, 1240, 1300, 1300], dtype=np.int64)
    freqs, accs = _accel_rows(rng, int(seg_off[-1]))
    freqs[40:1240] = 12.5
    args = (freqs, accs, seg_off, 600.0 / 299792458.0, 1e-4)
    got = native.accel_distill_seg(*args)
    _assert_same(got, jax_native.accel_distill_seg(*args))
    assert got[0][40] and not got[0][41:1240].any()
    assert set(range(41, 1240)) <= set(got[2][got[1] == 40].tolist())


@pytest.mark.parametrize("keep_related", [True, False])
def test_dm_distill(keep_related):
    rng = np.random.default_rng(19)
    freqs = _harmonic_freqs(rng, 500)
    got = native.dm_distill(freqs, 1e-4, keep_related)
    _assert_same(got, jax_native.dm_distill(freqs, 1e-4, keep_related))


def _cands(cls, rng, n):
    """Candidates with exact S/N ties across accel trials: each detection
    is repeated on two or three accel trials with the same frequency and
    S/N, as bitwise-equal spectra give them."""
    out = []
    while len(out) < n:
        f = float(_harmonic_freqs(rng, 1)[0])
        snr = float(_snrs(rng, 1)[0])
        nh = int(rng.integers(0, 5))
        dm_idx = int(rng.integers(0, 4))
        for acc in rng.choice([-5.0, 0.0, 5.0], size=int(rng.integers(1, 4)), replace=False):
            out.append(cls(dm=0.5 * dm_idx, dm_idx=dm_idx, acc=float(acc), nh=nh,
                           snr=snr, freq=f))
    return out[:n]


def _tree(c):
    return (c.dm_idx, c.acc, c.nh, c.snr, c.freq, [_tree(a) for a in c.assoc])


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.HarmonicDistiller(1e-4, 16, keep_related=False),
        lambda m: m.HarmonicDistiller(1e-4, 16, keep_related=True, fractional_harms=False),
        lambda m: m.AccelerationDistiller(600.0, 1e-4, keep_related=True),
        lambda m: m.DMDistiller(1e-4, keep_related=True),
    ],
    ids=["harmonic", "harmonic_related", "accel", "dm"],
)
def test_distillers_match_jax(make):
    rng = np.random.default_rng(23)
    got = make(distill).distill(_cands(Candidate, rng, 240))
    rng = np.random.default_rng(23)
    want = make(jax_distill).distill(_cands(JaxCandidate, rng, 240))
    assert [_tree(c) for c in got] == [_tree(c) for c in want]


def test_tie_heads_follow_std_sort(monkeypatch):
    # one detection on 40 accel trials, tied exactly: std::sort (past its
    # 16-element insertion sort) crowns another trial than the first, and
    # the port crowns the JAX package's
    cands = [Candidate(acc=float(a), snr=12.0, freq=3.0) for a in range(40)]
    jax_cands = [JaxCandidate(acc=float(a), snr=12.0, freq=3.0) for a in range(40)]
    got = distill.AccelerationDistiller(600.0, 1e-4, keep_related=True).distill(cands)
    want = jax_distill.AccelerationDistiller(600.0, 1e-4, keep_related=True).distill(jax_cands)
    assert [_tree(c) for c in got] == [_tree(c) for c in want]
    assert got[0].acc != 0.0
    monkeypatch.setenv("PEASOUP_NO_NATIVE", "1")
    cands = [Candidate(acc=float(a), snr=12.0, freq=3.0) for a in range(40)]
    stable = distill.AccelerationDistiller(600.0, 1e-4, keep_related=True).distill(cands)
    assert stable[0].acc == 0.0


def _cluster_streams(rng, nlev, accel_lists, padded=None, tie_free=True):
    """Each DM trial's (bins, snrs, counts (nlev, padded)) cluster stream,
    counts zero past each accel list; S/N values all distinct when
    ``tie_free``."""
    results = []
    for accs in accel_lists:
        width = padded or len(accs)
        cc = np.zeros((nlev, width), np.int32)
        cc[:, : len(accs)] = rng.integers(0, 5, size=(nlev, len(accs)))
        n = int(cc.sum())
        vi = rng.integers(10, 20000, size=n).astype(np.int32)
        if n:
            vi[::4] = vi[0]  # harmonic and accel relatives
        vs = (rng.permutation(n) * 0.01 + 6.0 if tie_free else _snrs(rng, n)).astype(np.float32)
        results.append((vi, vs, cc))
    return results


@pytest.mark.parametrize("padded", [None, 16])
def test_segmented_distil_matches_the_per_trial_loop(monkeypatch, padded):
    # no exact S/N ties: the segmented native distil and the Python loop
    # (stable sorts) crown the same members and build the same trees
    rng = np.random.default_rng(29)
    nlev = 5
    accel_lists = [np.linspace(-5, 5, k) for k in (3, 1, 7, 5, 4, 9)]
    plan = SimpleNamespace(
        nharms=nlev - 1, dm_list=np.linspace(0, 10, len(accel_lists)),
        factors=np.float32(0.0625) * (np.arange(nlev, dtype=np.float32) + 1),
    )
    results = _cluster_streams(rng, nlev, accel_lists, padded)
    results[3] = (results[3][0][:0], results[3][1][:0], np.zeros_like(results[3][2]))
    args = (
        distill.HarmonicDistiller(1e-4, 16, keep_related=False),
        distill.AccelerationDistiller(600.0, 1e-4, keep_related=True),
    )
    got = search._distill_segmented(plan, accel_lists, results, *args)
    monkeypatch.setenv("PEASOUP_NO_NATIVE", "1")
    want = search._distill_per_trial(plan, accel_lists, results, *args)
    assert len(got) > 10
    assert [_tree(c) for c in got] == [_tree(c) for c in want]


def test_segmented_distil_counts_its_native_calls():
    rng = np.random.default_rng(31)
    accel_lists = [np.array([0.0, 1.0])] * 3
    plan = SimpleNamespace(nharms=1, dm_list=np.arange(3.0),
                           factors=np.array([0.5, 0.25], np.float32))
    before = dict(native.calls)
    search._distill_segmented(
        plan, accel_lists, _cluster_streams(rng, 2, accel_lists, tie_free=False),
        distill.HarmonicDistiller(1e-4, 16, keep_related=False),
        distill.AccelerationDistiller(600.0, 1e-4, keep_related=True),
    )
    grew = {k for k in native.calls if native.calls[k] > before.get(k, 0)}
    assert grew == {"ps_snr_sort_perm_seg", "ps_harmonic_distill_seg", "ps_accel_distill_seg"}


_BUILD_AND_SORT = """
import sys
from pathlib import Path
import numpy as np
from peasoup_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
print(native.snr_sort_perm(np.array([1.0, 3.0, 2.0], np.float32)).tolist())
"""


def test_two_processes_build_at_once(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop("PEASOUP_NO_NATIVE", None)
    procs = [
        subprocess.Popen([sys.executable, "-c", _BUILD_AND_SORT, str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         cwd=ROOT, env=env)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[1, 2, 0]"
    assert [f.name for f in tmp_path.iterdir()] == [native.library_path().name]


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler not found"):
        native.build()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setenv("CXX", "g++")
    with pytest.raises(RuntimeError, match="build failed"):
        native.build()
    assert list(tmp_path.iterdir()) == [bad]


def test_no_native_selects_python(monkeypatch):
    assert native.enabled()
    monkeypatch.setenv("PEASOUP_NO_NATIVE", "1")
    assert not native.enabled()
    before = sum(native.calls.values())
    cands = [Candidate(snr=float(s), freq=1.0 + s) for s in range(5)]
    distill.DMDistiller(1e-4, keep_related=True).distill(cands)
    assert sum(native.calls.values()) == before
