"""The port's CUDA kernels against their plain versions on the card, at
small shapes with the edge cases (odd widths, birdies at block edges,
every dftspec factorisation, garbage padding, cluster overflow, rows out of order, offsets past 2^31,
boxcars past the trial's end, a tile shorter than the kernel's, -inf
blocks, flat stretches; boxcar on a reduced stream window, with widths
that are not multiples of 4, signed zeros and the widest bank that fits, more harmpeaks rows than SMs, dense crossing
runs; spchain with ties, signed zeros, a bank that is not powers of two,
nvalid inside a tile, more rows than the card's resident blocks and banks
wide enough (to 48,126 samples) that a window wraps round the ring;
peaks with crossings on mask-word edges, window edges, dense runs,
overflow, empty windows and more rows than the card's resident blocks; dedisperse on 1 to 4,096 channels with killed ones, ragged sample
and trial counts, sums past a 16-bit lane, the widest delay spread and
scales below 1; interbin from m = 2^10 to 2^20 on odd row counts and
the least pad) that the main path's inputs may not hold.
`chip_smoke.py` holds the kernels at the main path's shapes and the
card's search against the CPU's. Every test here needs an NVIDIA
card and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed (the tests' conftest.py imports JAX; skip it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
import torch_boxcar_cases as boxcar_cases

from peasoup_tpu_torch.ops import (
    dedisperse, dftspec, fft, harmonics, peaks, resample, singlepulse, spectrum,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("nshards", [2, 3, 8])
def test_dedisperse_sharded(dev, nshards):
    # one launch a shard of the card, each on its slice of the delays
    # (the last shard's padded with the last row): bitwise one launch
    from peasoup_tpu_torch.parallel.mesh import make_mesh
    from peasoup_tpu_torch.parallel.sharded_dedisperse import dedisperse_sharded

    rng = np.random.default_rng(nshards)
    c, d, t = 64, 77, 20011
    x = rng.integers(0, 4, size=(t, c), dtype=np.uint8)
    delays = np.sort(rng.integers(0, 330, size=(d, c)), axis=0).astype(np.int32)
    kill = np.ones(c, dtype=np.int32)
    out_n = t - int(delays.max())
    (xd,) = _on(dev, x)
    want = dedisperse.dedisperse(xd, delays, kill, out_n)
    mesh = make_mesh({"dm": nshards}, devices=[dev] * nshards)
    got = dedisperse_sharded(xd, delays, kill, out_n, mesh)
    assert len(got.parts) == nshards and got.per == -(-d // nshards)
    assert torch.equal(got.rows(0, d, dev), want)


@pytest.mark.parametrize(
    "c,d,t,spread,scale,full",
    [
        (16, 12, 8192, 40, 0.7, False),
        (1, 5, 3001, 30, 1.0, False),  # one channel, ragged T
        (64, 77, 20011, 330, 1.0, False),  # the big grid's channels and trials
        (300, 9, 5003, 120, 0.25, True),  # past one 16-bit lane, all 255
        (4096, 13, 4099, 900, 0.05, False),  # many chunks and flushes
        (16, 11, 27000, 20000, 1.0, False),  # the largest spread: 8-channel chunks
    ],
)
def test_dedisperse(dev, c, d, t, spread, scale, full):
    rng = np.random.default_rng(c + d)
    k = np.linspace(1.0, 0.0, c) ** 2
    dms = np.sort(rng.uniform(0, 1, d))
    dms[-1] = 1.0
    delays = np.rint(dms[:, None] * k * spread).astype(np.int32)
    fil = (np.full((t, c), 255) if full else rng.integers(0, 256, size=(t, c))).astype(np.uint8)
    kill = (rng.random(c) > 0.2).astype(np.int32)  # zeroed channels
    kill[0] = 1
    (x,) = _on(dev, fil)
    out_nsamps = t - int(delays.max())
    got = dedisperse.dedisperse(x, delays, kill, out_nsamps, scale=scale)
    want = dedisperse.dedisperse_block(x, delays, kill, out_nsamps=out_nsamps, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_resample(dev):
    rng = np.random.default_rng(4)
    d, n = 4, 100003  # odd N
    x = rng.normal(size=(d, n)).astype(np.float32)
    row_dm = np.asarray([2, 0, 3, 3, 1, 0, 2, 1], dtype=np.int32)
    # both signs, spans from none to ~40 samples, and |af|*N > 1 (clipped)
    afs = np.asarray([0.0, 1e-10, -1e-10, 1.6e-8, -1.6e-8, 2e-5, -2e-5, 3e-9],
                     dtype=np.float32)
    args = _on(dev, x, row_dm, afs)
    got = resample.resample_rows(*args)
    want = resample.resample_rows_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_resample_offsets_past_2_31(dev):
    # 1,100 rows of 2^21 samples: r*N passes 2^31 from row 1,024 on
    rows, n = 1100, 1 << 21
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, n)).astype(np.float32)
    row_dm = (np.arange(rows) % 3).astype(np.int32)
    afs = np.linspace(-2e-11, 2e-11, rows).astype(np.float32)
    xs, rd, af = _on(dev, x, row_dm, afs)
    got = resample.resample_rows(xs, rd, af)
    tail = slice(rows - 4, rows)
    want = resample.resample_rows_plain(xs, rd[tail], af[tail])
    torch.cuda.synchronize()
    assert torch.equal(got[tail], want)


def test_specchain(dev):
    rng = np.random.default_rng(1)
    rows, nbins = 7, 70001
    re, im = rng.normal(size=(2, rows, nbins)).astype(np.float32)
    med = (0.5 + rng.random((rows, nbins))).astype(np.float32)
    zap = np.zeros(nbins, dtype=bool)
    zap[[2, 511, 512, nbins - 1]] = True
    args = _on(dev, re, im, med, zap)
    got = spectrum.specchain(*args)
    want = spectrum.interp_deredden_zap(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(((got[2] - want[2]).abs() <= spectrum.s0_envelope(want[2])).all())


@pytest.mark.parametrize("rows,log_m", [(5, 13), (3, 10), (7, 11), (9, 16), (1, 20), (33, 20)])
def test_interbin(dev, rows, log_m):
    rng = np.random.default_rng(rows + log_m)
    n = 2 << log_m
    x = rng.normal(size=(rows, n)) + 3.0 * np.sin(2 * np.pi * np.arange(n) * 0.1317)
    mean = rng.normal(size=rows).astype(np.float32)
    std = (0.5 + rng.random(rows)).astype(np.float32)
    xs, mean, std = _on(dev, x.astype(np.float32), mean, std)
    z = fft.packed_dft_z(xs)
    npad = n // 2 + (2 if log_m % 2 else 4096)  # m + 2, the least even pad, or wide
    got = fft.untwist_interbin_normalise(z, mean, std, npad=npad)
    want = fft.untwist_interbin_normalise_plain(z, mean, std, npad=npad)
    torch.cuda.synchronize()
    body, ref = got[:, : n // 2 + 1], want[:, : n // 2 + 1]
    rms = torch.sqrt(torch.mean(ref * ref, dim=1, keepdim=True))
    assert bool(((body - ref).abs() <= 1e-5 * (ref.abs() + rms)).all())
    assert not bool(got[:, n // 2 + 1 :].any())


@pytest.mark.parametrize(
    "rows,n", [(5, 1 << 15), (9, 1 << 16), (3, 1 << 17), (2, 1 << 18)]
)
def test_dftspec(dev, rows, n):
    # m = 2^14 .. 2^17 (n1 x n2 = 128x128, 256x128... up to 256x512), held
    # to the JAX package's accuracy gate against the plain version (cuFFT)
    m = n // 2
    npad = -(-(m + 1) // 4096) * 4096
    x, _, _, mean, std = dftspec.oracle_data(n, r=rows, seed=rows)
    xs, ms, ss = _on(dev, x, mean, std)
    got = dftspec.dft_untwist_interbin(xs, ms, ss, npad=npad)
    want = dftspec.dft_untwist_interbin_plain(xs, ms, ss, npad=npad)
    torch.cuda.synchronize()
    assert got.shape == (rows, npad)
    assert not bool(got[:, m + 1 :].any())
    acc_max, q999 = dftspec.accuracy(got, want, ms, ss, m)
    assert acc_max <= dftspec.ACC_MAX_REL
    assert q999 <= dftspec.ACC_Q999_REL


def test_dftspec_allocates_no_scratch(dev):
    # one launch, T and Z kept on chip: the call allocates its output and
    # nothing the size of a (rows, m) complex array
    rows, n = 64, 1 << 17
    m = n // 2
    npad = m + 4096
    x, _, _, mean, std = dftspec.oracle_data(n, r=rows, seed=3)
    xs, ms, ss = _on(dev, x, mean, std)
    dftspec.dft_untwist_interbin(xs, ms, ss, npad=npad)  # the cached tables
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = dftspec.dft_untwist_interbin(xs, ms, ss, npad=npad)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    assert out.nbytes <= grew < out.nbytes + rows * m * 8


@pytest.mark.parametrize("nlev,mx", [(5, 64), (3, 4)])
def test_peaks(dev, nlev, mx):
    rng = np.random.default_rng(8)
    rows, nbins = 7, 20000
    npad = -(-nbins // 4096) * 4096
    levels = []
    for lv in range(nlev):
        s = np.abs(rng.normal(size=(rows, nbins))).astype(np.float32)
        s[::3, lv::61] += 30.0
        s[1, 9000 + lv : 9400 : 4] += 20.0
        levels.append(np.pad(s, ((0, 0), (0, npad - nbins)), constant_values=1e9))
    windows = np.tile(np.asarray([[nbins // 10, nbins + 500]], np.int32), (nlev, 1))
    kw = dict(threshold=9.0, max_peaks=mx, scales=harmonics.level_scales(nlev - 1),
              nbins=nbins)
    lv = _on(dev, *levels)
    got = peaks.find_cluster_peaks_multi(lv, windows, **kw)
    want = peaks.find_cluster_peaks_multi_plain(lv, windows, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3].max()) > (mx if mx == 4 else 0)


@pytest.mark.parametrize("nharms,mx", [(4, 16), (2, 2)])
def test_harmpeaks(dev, nharms, mx):
    rng = np.random.default_rng(3)
    rows, nbins = 7, 20000
    s = np.abs(rng.normal(size=(rows, nbins))).astype(np.float32)
    s[::3, ::61] += 30.0
    s[1, 9000:9400:4] += 20.0
    npad = -(-nbins // 4096) * 4096
    sp = np.pad(s, ((0, 0), (0, npad - nbins)), constant_values=1e9)
    windows = np.tile(np.asarray([[nbins // 10, nbins + 500]], np.int32), (nharms + 1, 1))
    kw = dict(nharms=nharms, threshold=9.0, max_peaks=mx,
              scales=harmonics.level_scales(nharms), nbins=nbins)
    (spec,) = _on(dev, sp)
    got = peaks.find_harmonic_cluster_peaks(spec, windows, **kw)
    want = peaks.find_harmonic_cluster_peaks_plain(spec, windows, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3].max()) > 0


@pytest.mark.parametrize(
    "rows,nbins,nharms,mx",
    [(300, 20000, 4, 16),   # more rows than the card has SMs
     (3, (1 << 20) + 1, 4, 64),  # a big-grid row
     (5, 50000, 5, 32)],  # nharms 5
)
def test_harmpeaks_whole_card(dev, rows, nbins, nharms, mx):
    rng = np.random.default_rng(rows)
    s = np.abs(rng.normal(size=(rows, nbins))).astype(np.float32)
    s[::3, ::61] += 30.0
    # dense runs of crossings across mask words and phase A's 1,024-bin
    # tiles, and crossings on bits 0 and 31 of mask words
    s[1, 1000:3100] += 15.0
    s[-1, 4000:9000:3] += 25.0
    s[:, [4096, 4127, 8191, 8192]] += 40.0
    npad = -(-nbins // 4096) * 4096
    sp = np.pad(s, ((0, 0), (0, npad - nbins)), constant_values=1e9)
    nlev = nharms + 1
    windows = np.tile(np.asarray([[nbins // 10, nbins + 500]], np.int32), (nlev, 1))
    windows[0] = [1000, nbins - 7]
    windows[1] = [4096, 8192]
    kw = dict(nharms=nharms, threshold=9.0, max_peaks=mx,
              scales=harmonics.level_scales(nharms), nbins=nbins)
    (spec,) = _on(dev, sp)
    got = peaks.find_harmonic_cluster_peaks(spec, windows, **kw)
    want = peaks.find_harmonic_cluster_peaks_plain(spec, windows, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3].max()) > 0


def _boxcar_inputs(dev, nsamps, n_widths, seed):
    """Prefix sums of normalised noise with a bright pulse, a flat stretch
    (ties between widths and samples) and a tail short of tpad."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(5, nsamps)).astype(np.float32)
    x[1, nsamps // 3 : nsamps // 3 + 40] += 8.0
    x[2, 100:900] = 0.0
    widths = singlepulse.default_widths(n_widths)
    tpad, _ = singlepulse.plan_pad(nsamps)
    norm = singlepulse.normalise_trials(torch.from_numpy(x).to(dev))
    csum = singlepulse.prefix_sum_padded(norm, tpad, singlepulse.width_extent(widths))
    return csum, widths, singlepulse.width_scales(widths), nsamps, tpad


@pytest.mark.parametrize(
    "case", ["20000x12", "5000x5", "70001x14", *boxcar_cases.CASES],
)
def test_boxcar(dev, case):
    if case[0].isdigit():  # nsamps x widths
        nsamps, n_widths = map(int, case.split("x"))
        args = _boxcar_inputs(dev, nsamps, n_widths, 6)
    else:  # the host emulation's edges (tests/test_torch_kernel_host.py)
        csum, *rest = boxcar_cases.boxcar_case(case)
        args = (*_on(dev, csum), *rest)
    nvalid = args[3]
    got = singlepulse.boxcar_best(*args)
    want = singlepulse.boxcar_best_plain(*args)
    torch.cuda.synchronize()
    # bit for bit, the sign of a zero S/N included
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])
    assert bool(torch.isneginf(got[0][:, nvalid:]).all())


@pytest.mark.parametrize("dec", [1, 8, 32, 64, 1024])
def test_spchain(dev, dec):
    args = _boxcar_inputs(dev, 30000, 12, 7)
    got = singlepulse.boxcar_dec_best(*args, dec)
    want = singlepulse.boxcar_dec_best_plain(*args, dec)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the blocks past the trial's end are all -inf: max -inf, argmax 0,
    # width 0; and the dec-fold of boxcar's output is spchain's
    tail = args[3] // dec + 1
    assert bool(torch.isneginf(got[0][:, tail:]).all())
    assert not bool(got[1][:, tail:].any()) and not bool(got[2][:, tail:].any())
    best, bw = singlepulse.boxcar_best(*args)
    for f, g in zip(singlepulse.dec_fold(best, bw, dec), got):
        assert torch.equal(f, g)


def _spchain_inputs(dev, case):
    """spchain's edges: prefix sums of noise with a pulse, and the case's
    ties, signed zeros, odd bank, mid-tile nvalid or long and many rows."""
    rng = np.random.default_rng(len(case))
    rows, nsamps = 5, 20000
    widths = singlepulse.default_widths(12)
    if case == "odd_bank":
        widths = (3, 1, 5, 6, 7, 2, 10, 13, 100, 4, 257, 1000, 1001, 1023)
    if case == "many_rows":  # more rows than the card's resident blocks
        rows, nsamps = 1500, 3000
    if case == "long_rows":
        rows, nsamps = 3, 300001
    if case == "wide_bank":  # spsearch --n_widths 16: widths to 32,768, a wrapping ring
        rows, nsamps, widths = 40, 300001, singlepulse.default_widths(16)
    if case == "widest_bank":  # the widest boxcar a 14-chunk ring holds a tile of
        rows, nsamps, widths = 7, 200001, (1, 2, 5, 4099, 48126)
    x = rng.normal(size=(rows, nsamps)).astype(np.float32)
    x[1, nsamps // 3 : nsamps // 3 + 40] += 8.0
    if case == "ties":
        x[:, 100:5000] = 0.0
        x[2, 6000:9000:64] = 3.0
        x[3] = np.round(x[3])
    norm = singlepulse.normalise_trials(torch.from_numpy(x).to(dev))
    if case == "ties":
        norm[:, 100:5000] = 0.0
    tpad, _ = singlepulse.plan_pad(nsamps)
    csum = singlepulse.prefix_sum_padded(norm, tpad, singlepulse.width_extent(widths))
    nvalid = nsamps
    if case == "signed_zeros":
        csum[:, 200:6000] = torch.from_numpy(
            np.where(np.arange(5800) % 3 == 0, -0.0, 0.0).astype(np.float32)).to(dev)
        csum[1, 7000:9000] = torch.from_numpy(
            np.where(np.arange(2000) % 2, -1e-45, 1e-45).astype(np.float32)).to(dev)
    if case == "nvalid_mid_tile":
        nvalid = nsamps - 1500
    if case == "all_neg_inf":
        nvalid = 0
    return csum, widths, singlepulse.width_scales(widths), nvalid, tpad


@pytest.mark.parametrize(
    "case,dec",
    [("ties", 32), ("ties", 256), ("ties", 2), ("signed_zeros", 32), ("signed_zeros", 1),
     ("signed_zeros", 512), ("odd_bank", 32), ("odd_bank", 4), ("nvalid_mid_tile", 32),
     ("nvalid_mid_tile", 1024), ("all_neg_inf", 32), ("many_rows", 32), ("long_rows", 32),
     ("long_rows", 64), ("wide_bank", 32), ("wide_bank", 1), ("wide_bank", 1024),
     ("widest_bank", 32), ("widest_bank", 4)],
)
def test_spchain_edges(dev, case, dec):
    args = _spchain_inputs(dev, case)
    got = singlepulse.boxcar_dec_best(*args, dec)
    want = singlepulse.boxcar_dec_best_plain(*args, dec)
    torch.cuda.synchronize()
    # bit for bit, the sign of a zero S/N included
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def _peaks_levels(rows, nbins, nlev, case, seed):
    rng = np.random.default_rng(seed)
    npad = -(-nbins // 4096) * 4096
    levels = []
    for _ in range(nlev):
        s = 0.1 * np.abs(rng.normal(size=(rows, npad))).astype(np.float32)
        s[:, nbins:] = 1e9
        levels.append(s)
    windows = np.tile(np.asarray([[nbins // 10, nbins + 500]], np.int32), (nlev, 1))
    mx = 32
    if case == "word_bits":
        for lv in levels:
            lv[:, [1024, 1055, 2048, 2079, 4095, 4096, 6143, 6144]] = 40.0
        windows = np.asarray([[1024, 6144], [1025, 6145], [1055, 4096], [1056, 4095],
                              [0, nbins + 700]], np.int32)[:nlev]
    elif case == "dense_runs":
        for h, lv in enumerate(levels):
            lv[1, 1000 + h : 3100] += 25.0
            lv[-1, 4000:9000:3] += 25.0
        mx = 64
    elif case == "overflow":
        for lv in levels:
            lv[:, 1000 : nbins - 100 : 61] += 30.0
        mx = 4
    elif case == "empty_windows":
        for lv in levels:
            lv[:, ::97] += 30.0
        windows = np.asarray([[500, 500], [8000, 7000], [-40, nbins - 1], [300, 301],
                              [0, 0]], np.int32)[:nlev]
    else:  # "comb", over many rows
        for h, lv in enumerate(levels):
            lv[::2, h::61] += 30.0
    return levels, windows, mx


@pytest.mark.parametrize(
    "case,rows,nbins",
    [("word_bits", 4, 9000), ("dense_runs", 5, 20000), ("overflow", 3, 20000),
     ("empty_windows", 4, 9000), ("comb", 3000, 5000)],  # more rows than resident
)
def test_peaks_edges(dev, case, rows, nbins):
    nlev = 5
    levels, windows, mx = _peaks_levels(rows, nbins, nlev, case, rows)
    kw = dict(threshold=9.0, max_peaks=mx, scales=harmonics.level_scales(nlev - 1),
              nbins=nbins)
    lv = _on(dev, *levels)
    got = peaks.find_cluster_peaks_multi(lv, windows, **kw)
    want = peaks.find_cluster_peaks_multi_plain(lv, windows, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert int(got[3].max()) > (mx if case == "overflow" else 0)
