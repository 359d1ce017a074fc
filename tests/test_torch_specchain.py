"""The port's spectrum chain (peasoup_tpu_torch/ops/spectrum.py specchain,
ops/rednoise.py) against the JAX package's Pallas specchain kernel
(interpret mode) and its jnp twins.

The dereddened and zapped parts carry no multiply-add pair, so they are
bitwise; the interbinned amplitude s0 may differ by FMA contraction in
its sums of squares, which ``s0_envelope`` bounds (a few ULP of the bin
magnitude, as the JAX package states it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.ops.pallas.specchain import interp_deredden_zap_pallas
from peasoup_tpu.ops.pallas.specchain import s0_envelope as jax_s0_envelope
from peasoup_tpu.ops.rednoise import running_median as jax_running_median
from peasoup_tpu.ops.spectrum import interp_deredden_zap as jax_plain
from peasoup_tpu.ops.spectrum import spectrum_stats as jax_stats
from peasoup_tpu_torch.ops import rednoise, spectrum


def _case(seed, d, nbins):
    """Raw spectrum parts, a positive median, and birdies at bin 2, across
    the Pallas kernel's 512-bin tile edge and at the last bins."""
    rng = np.random.default_rng(seed)
    re = rng.normal(size=(d, nbins)).astype(np.float32)
    im = rng.normal(size=(d, nbins)).astype(np.float32)
    med = (0.5 + rng.random((d, nbins))).astype(np.float32)
    zap = np.zeros(nbins, dtype=bool)
    zap[2] = True
    zap[510:514] = True
    zap[nbins - 3 :] = True
    return re, im, med, zap


def _port(re, im, med, zap):
    got = spectrum.specchain(*(torch.from_numpy(a) for a in (re, im, med, zap)))
    return [t.numpy() for t in got]


def test_matches_pallas_kernel():
    re, im, med, zap = _case(0, 9, 1537)  # odd nbins, 9 rows: both padded
    want = [
        np.asarray(a)
        for a in interp_deredden_zap_pallas(
            jnp.asarray(re), jnp.asarray(im), jnp.asarray(med), jnp.asarray(zap),
            interpret=True,
        )
    ]
    got = _port(re, im, med, zap)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (np.abs(got[2] - want[2]) <= jax_s0_envelope(want[2])).all()
    # zapped bins are 1+0i, the first five bins 0 unless zapped
    assert (got[0][:, zap] == 1.0).all() and (got[1][:, zap] == 0.0).all()
    assert (got[0][:, [0, 1, 3, 4]] == 0.0).all()


@pytest.mark.parametrize("d,nbins", [(3, 1025), (4, 4097), (1, 515)])
def test_matches_jnp_twin(d, nbins):
    re, im, med, zap = _case(d + nbins, d, nbins)
    want = [np.array(a) for a in jax_plain(re, im, med, jnp.asarray(zap))]
    got = _port(re, im, med, zap)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    env = spectrum.s0_envelope(torch.from_numpy(want[2])).numpy()
    assert (np.abs(got[2] - want[2]) <= env).all()


def test_stats_and_normalise_match_jax():
    rng = np.random.default_rng(4)
    x = np.abs(rng.normal(2.0, 1.0, size=(5, 3001))).astype(np.float32)
    want = [np.array(a) for a in jax_stats(jnp.asarray(x))]
    got = [t.numpy() for t in spectrum.spectrum_stats(torch.from_numpy(x))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    mean, _, std = (torch.from_numpy(w) for w in want)
    s = spectrum.normalise(torch.from_numpy(x), mean, std).numpy()
    np.testing.assert_allclose(s, (x - want[0][:, None]) / want[2][:, None], rtol=1e-6)


@pytest.mark.parametrize("n", [1, 7, 8, 12_345, (1 << 16) + 1])
def test_row_sum_is_each_rows_own(n):
    # a row's sum has the same bits alone, in any batch and from a start
    # that is not vector aligned, and is the float64 sum rounded to float32
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(3.0, 2.0, size=(7, n)).astype(np.float32))
    full = spectrum.row_sum(x)
    for i in range(7):
        assert torch.equal(spectrum.row_sum(x[i : i + 1])[0], full[i])
        assert torch.equal(spectrum.row_sum(x[i].clone()), full[i])
    shifted = torch.empty(7 * n + 3)[3:].view(7, n)
    shifted.copy_(x)
    assert torch.equal(spectrum.row_sum(shifted), full)
    assert torch.equal(full, x.double().sum(-1).float())


@pytest.mark.parametrize("nbins,pos5,pos25", [(4097, 30, 300), (1001, 0, 7), (4, 1, 2)])
def test_running_median_matches_jax(nbins, pos5, pos25):
    rng = np.random.default_rng(nbins)
    p = np.abs(rng.normal(size=(3, nbins))).astype(np.float32)
    want = np.asarray(jax_running_median(jnp.asarray(p), pos5=pos5, pos25=pos25))
    got = rednoise.running_median(torch.from_numpy(p), pos5=pos5, pos25=pos25)
    # medians are exact selections; the stretch's left + frac*(right-left)
    # may be contracted to an FMA by XLA
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=1e-7)


def test_refuses_a_device_that_is_neither_cpu_nor_cuda():
    re, im, med = (torch.zeros(2, 8, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="unsupported device"):
        spectrum.specchain(re, im, med, torch.zeros(8, dtype=torch.bool, device="meta"))

