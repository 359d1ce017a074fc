"""The port's harmonic sums + threshold + cluster walk
(peasoup_tpu_torch/ops/peaks.py find_harmonic_cluster_peaks,
ops/harmonics.py) against the JAX package's Pallas harmpeaks kernel
(interpret mode) and its jnp take-order oracle.

Level values are accumulated in the reference's order, one ``+`` at a
time, so every output is compared for exact equality: cluster bins,
cluster S/N, raw crossing counts and cluster counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops.harmonics import harmonic_sums as jax_harmonic_sums
from peasoup_tpu.ops.pallas.harmpeaks import find_harmonic_cluster_peaks as jax_kernel
from peasoup_tpu.ops.peaks import cluster_peaks_device as jax_cluster
from peasoup_tpu.ops.peaks import find_peaks_device as jax_find
from peasoup_tpu_torch.ops import harmonics, peaks

NPAD_ALIGN = 4096  # the JAX kernel's row block


def _spectrum(seed, rows, nbins):
    """Noise with tones every 61 bins on every third row, a comb of close
    crossings on row 1, and garbage (1e9) in the pad past nbins."""
    rng = np.random.default_rng(seed)
    s = np.abs(rng.normal(size=(rows, nbins))).astype(np.float32)
    s[::3, ::61] += 30.0
    s[min(1, rows - 1), nbins // 2 : nbins // 2 + 400 : 4] += 20.0
    npad = -(-nbins // NPAD_ALIGN) * NPAD_ALIGN
    sp = np.pad(s, ((0, 0), (0, npad - nbins)), constant_values=1e9)
    return s, sp


def _windows(nlev, nbins):
    lo, hi = nbins // 10, nbins - nbins // 16
    w = np.tile(np.asarray([[lo, hi]], np.int32), (nlev, 1))
    w[-1, 1] = nbins + 500  # reaches into the pad: must be clamped to nbins
    return w


@pytest.mark.parametrize(
    "nharms,nbins,rows,mx",
    [(4, 6000, 5, 64), (2, 4500, 3, 64), (4, 4200, 1, 4)],  # last: overflow
)
def test_matches_pallas_kernel_exactly(nharms, nbins, rows, mx):
    s, sp = _spectrum(nharms * rows, rows, nbins)
    nlev = nharms + 1
    windows = _windows(nlev, nbins)
    scales = harmonics.level_scales(nharms)
    want = [
        np.asarray(a)
        for a in jax_kernel(
            jnp.asarray(sp), jnp.asarray(windows), nharms=nharms, threshold=9.0,
            max_peaks=mx, scales=scales, nbins=nbins, interpret=True,
        )
    ]
    got = [
        t.numpy()
        for t in peaks.find_harmonic_cluster_peaks(
            torch.from_numpy(sp), windows, nharms=nharms, threshold=9.0,
            max_peaks=mx, scales=scales, nbins=nbins,
        )
    ]
    for g, w, name in zip(got, want, ("idxs", "snrs", "counts", "ccounts")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3].max() > 0
    if mx == 4:
        assert got[3].max() > mx  # the overflow case really overflows


@pytest.mark.parametrize("nharms", [1, 3, 5])
def test_harmonic_sums_match_take_order(nharms):
    s, _ = _spectrum(nharms, 2, 3001)
    want = jax_harmonic_sums(jnp.asarray(s), nharms=nharms, method="take", scaled=True)
    got = harmonics.harmonic_sums(torch.from_numpy(s), nharms=nharms, scaled=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_find_and_cluster_match_jax():
    s, _ = _spectrum(11, 4, 5000)
    lo, hi = 200, 4800
    i_, s_, c_ = jax_find(
        jnp.asarray(s), jnp.float32(9.0), jnp.int32(lo), jnp.int32(hi),
        max_peaks=1 << 12,
    )
    ji, js, jc = (np.asarray(a) for a in jax_cluster(i_, s_, jnp.int32(5000)))
    ti, ts, tc = peaks.find_peaks_device(
        torch.from_numpy(s), 9.0, torch.full((4,), lo), torch.full((4,), hi)
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(c_))
    ci, cs, cc = peaks.cluster_peaks_device(ti, ts, tc, nbins=5000)
    np.testing.assert_array_equal(cc.numpy(), jc)
    for r in range(4):
        k = int(jc[r])
        np.testing.assert_array_equal(ci[r, :k].numpy(), ji[r, :k])
        np.testing.assert_array_equal(cs[r, :k].numpy(), js[r, :k])


def test_validation():
    sp = torch.zeros((2, NPAD_ALIGN))
    w = np.zeros((3, 2), np.int32)
    with pytest.raises(ValueError, match="nharms"):
        peaks.find_harmonic_cluster_peaks(
            sp, w, nharms=6, threshold=9.0, max_peaks=8, scales=(1.0,) * 7
        )
    with pytest.raises(ValueError, match="levels"):
        peaks.find_harmonic_cluster_peaks(
            sp, w, nharms=2, threshold=9.0, max_peaks=8, scales=(1.0, 0.5)
        )

