"""The port's CUDA kernels against their plain versions on the card, at
small shapes with the edge cases (odd widths, birdies at block edges,
garbage padding, cluster overflow) that the main path's inputs may not
hold. `chip_smoke.py` holds the kernels at the main path's shapes and
the card's search against the CPU's. Every test here needs an NVIDIA
card and skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed (the tests' conftest.py imports JAX; skip it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from peasoup_tpu_torch.ops import dedisperse, fft, harmonics, peaks, spectrum

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def test_dedisperse(dev):
    rng = np.random.default_rng(0)
    c, d, t = 16, 12, 8192
    k = np.linspace(0.0, 30.0, c)
    delays = np.rint(np.sort(rng.uniform(0, 40, d))[:, None] * k / 30.0).astype(np.int32)
    fil = rng.integers(0, 4, size=(t, c)).astype(np.uint8)
    kill = (rng.random(c) > 0.2).astype(np.int32)
    x, dl, kl = _on(dev, fil, delays, kill)
    out_nsamps = t - int(delays.max())
    got = dedisperse.dedisperse(x, dl, kl, out_nsamps, scale=0.7)
    want = dedisperse.dedisperse_block(x, dl, kl, out_nsamps=out_nsamps, scale=0.7)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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


def test_interbin(dev):
    rng = np.random.default_rng(2)
    rows, n = 5, 1 << 14
    x = rng.normal(size=(rows, n)) + 3.0 * np.sin(2 * np.pi * np.arange(n) * 0.1317)
    mean = rng.normal(size=rows).astype(np.float32)
    std = (0.5 + rng.random(rows)).astype(np.float32)
    xs, mean, std = _on(dev, x.astype(np.float32), mean, std)
    z = fft.packed_dft_z(xs)
    npad = n // 2 + 4096
    got = fft.untwist_interbin_normalise(z, mean, std, npad=npad)
    want = fft.untwist_interbin_normalise_plain(z, mean, std, npad=npad)
    torch.cuda.synchronize()
    body, ref = got[:, : n // 2 + 1], want[:, : n // 2 + 1]
    rms = torch.sqrt(torch.mean(ref * ref, dim=1, keepdim=True))
    assert bool(((body - ref).abs() <= 1e-5 * (ref.abs() + rms)).all())
    assert not bool(got[:, n // 2 + 1 :].any())


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
