"""The port's threshold + cluster walk over levels formed apart
(peasoup_tpu_torch/ops/peaks.py find_cluster_peaks_multi, the search's
``PEASOUP_MEGA_HARM=0`` route) against the JAX package's Pallas peaks
kernel (interpret mode), and the unscaled harmonic sums of the padded
spectrum that feed it (ops/harmonics.py) against the JAX package's
block-aligned sums.

Every output is compared for exact equality: cluster bins, cluster S/N,
raw crossing counts and cluster counts, and the harmonic sums bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops.harmonics import harmonic_sums as jax_harmonic_sums
from peasoup_tpu.ops.pallas.peaks import PEAKS_BLOCK
from peasoup_tpu.ops.pallas.peaks import find_cluster_peaks_multi as jax_kernel
from peasoup_tpu_torch.ops import harmonics, peaks


def _levels(nbins, nlev, distinct, seed=0, rows=9):
    """probe_pallas_peaks's data (ops/pallas/__init__.py:68-156): noise
    under the threshold, a comb of crossings on every third row, a dense
    cluster run on row 1 and garbage (1e9) past nbins up to the 4096-bin
    block; ``distinct`` gives every level its own noise and comb."""
    rng = np.random.default_rng(seed)
    npad = -(-nbins // PEAKS_BLOCK) * PEAKS_BLOCK
    out = []
    for lv in range(nlev if distinct else 1):
        s = np.abs(rng.normal(size=(rows, nbins))).astype(np.float32)
        s[::3, lv :: max(1, nbins // 97)] += 30.0
        s[1, nbins // 2 + lv : nbins // 2 + 400 : 4] += 20.0
        out.append(np.pad(s, ((0, 0), (0, npad - nbins)), constant_values=1e9))
    return out if distinct else out * nlev


@pytest.mark.parametrize(
    "nbins,nlev,mx,distinct",
    [
        (6000, 5, 64, False),  # the probe's own case: one array, five scales
        (6000, 5, 64, True),
        (9000, 3, 32, True),
        (5000, 5, 4, True),  # clusters overflow max_peaks
    ],
)
def test_matches_pallas_kernel_exactly(nbins, nlev, mx, distinct):
    levels = _levels(nbins, nlev, distinct, seed=nbins + nlev)
    lo, hi = nbins // 10, nbins - nbins // 16
    windows = np.tile(np.asarray([[lo, hi]], np.int32), (nlev, 1))
    windows[-1, 1] = nbins + 700  # reaches into the garbage: clamped to nbins
    scales = harmonics.level_scales(nlev - 1)
    want = [
        np.asarray(a)
        for a in jax_kernel(
            [jnp.asarray(lv) for lv in levels], jnp.asarray(windows),
            threshold=9.0, max_peaks=mx, scales=scales, nbins=nbins, interpret=True,
        )
    ]
    got = [
        t.numpy()
        for t in peaks.find_cluster_peaks_multi(
            [torch.from_numpy(lv) for lv in levels], windows, threshold=9.0,
            max_peaks=mx, scales=scales, nbins=nbins,
        )
    ]
    for g, w, name in zip(got, want, ("idxs", "snrs", "counts", "ccounts")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3].sum() > 0
    if mx == 4:
        assert got[3].max() > mx  # the overflow case really overflows


def _spectrum(seed, rows, nbins):
    """A normalised-spectrum stand-in as the spectrum kernels emit it:
    noise with tones, a close comb on row 1, and exact zeros past nbins up
    to the 4096-bin block."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(rows, nbins)).astype(np.float32)
    s[::2, 37::211] += 25.0
    s[1, nbins // 3 : nbins // 3 + 300 : 5] += 15.0
    npad = -(-nbins // PEAKS_BLOCK) * PEAKS_BLOCK
    return np.pad(s, ((0, 0), (0, npad - nbins)))


@pytest.mark.parametrize("nharms,nbins", [(4, 9001), (2, 4097), (5, 12000)])
def test_padded_sums_are_jax_block_aligned_levels(nharms, nbins):
    # the sums of the zero-padded spectrum are the JAX package's
    # block-aligned levels over the whole padded row, and its unpadded
    # sums over the true bins
    sp = _spectrum(nharms, 3, nbins)
    got = harmonics.harmonic_sums(torch.from_numpy(sp), nharms=nharms, scaled=False)
    want = jax_harmonic_sums(
        jnp.asarray(sp[:, :nbins]), nharms=nharms, scaled=False,
        block_align=PEAKS_BLOCK,
    )
    unaligned = jax_harmonic_sums(jnp.asarray(sp[:, :nbins]), nharms=nharms, scaled=False)
    for g, w, u in zip(got, want, unaligned):
        assert g.shape == sp.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy()[:, :nbins], np.asarray(u))


@pytest.mark.parametrize("nharms,mx", [(4, 64), (3, 2)])
def test_split_route_equals_harmpeaks(nharms, mx):
    # the search's two peaks routes on one padded spectrum: its sums +
    # find_cluster_peaks_multi against the fused harmonic walk
    nbins = 10001
    s = torch.from_numpy(_spectrum(7 * nharms, 4, nbins))
    windows = np.tile(np.asarray([[40, nbins]], np.int32), (nharms + 1, 1))
    kw = dict(threshold=9.0, max_peaks=mx, scales=harmonics.level_scales(nharms),
              nbins=nbins)
    sums = harmonics.harmonic_sums(s, nharms=nharms, scaled=False)
    got = peaks.find_cluster_peaks_multi([s, *sums], windows, **kw)
    want = peaks.find_harmonic_cluster_peaks_plain(s, windows, nharms=nharms, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3].max()) > 0


def test_validation():
    lv = torch.zeros((2, PEAKS_BLOCK))
    w = np.zeros((7, 2), np.int32)
    kw = dict(threshold=9.0, max_peaks=8)
    with pytest.raises(ValueError, match="levels"):
        peaks.find_cluster_peaks_multi([lv] * 7, w, scales=(1.0,) * 7, **kw)
    with pytest.raises(ValueError, match="scales"):
        peaks.find_cluster_peaks_multi([lv] * 3, w[:3], scales=(1.0, 0.5), **kw)
    with pytest.raises(ValueError, match="windows"):
        peaks.find_cluster_peaks_multi([lv] * 3, w[:2], scales=(1.0,) * 3, **kw)
