"""The port's folding (peasoup_tpu_torch.ops.fold, ops.fold_optimise,
ops.rednoise.whiten_fseries and pipeline.folder) against the JAX
package's on the same numpy inputs, on the CPU.

Tolerances: the phase-bin map is host f64 in both and must be equal; the
fold's segment sums run in another order (and on the card with atomics),
so folds agree to 1e-5 relative; the optimiser's FFTs round differently,
so a clear pulse's template, bin, shift and optimised period must agree
exactly and its S/N to 1e-4 relative. Through the whole folder the
dereddening FFTs differ in rounding too, so S/N agrees to 1e-3 relative
and the folded profiles to 1e-3 of their peak.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peasoup_tpu.core.candidates import Candidate as JaxCandidate
from peasoup_tpu.ops import fold as jax_fold
from peasoup_tpu.ops.fold_optimise import FoldOptimiser as JaxOptimiser
from peasoup_tpu.ops.fold_optimise import calculate_sn as jax_calculate_sn
from peasoup_tpu.ops.rednoise import whiten_fseries as jax_whiten
from peasoup_tpu.pipeline.folder import MultiFolder as JaxFolder
from peasoup_tpu.pipeline.folder import fold_geometry as jax_fold_geometry
from peasoup_tpu_torch.core.candidates import Candidate
from peasoup_tpu_torch.ops import fold
from peasoup_tpu_torch.ops.fold_optimise import NBINS, NINTS, FoldOptimiser, calculate_sn
from peasoup_tpu_torch.ops.rednoise import whiten_fseries
from peasoup_tpu_torch.pipeline.folder import MultiFolder, fold_geometry


def test_fold_constants_are_the_jax_defaults():
    # the JAX package's folder defaults to the reference's 64 x 16 fold,
    # the geometry the port fixes
    params = inspect.signature(JaxFolder).parameters
    assert (params["nbins"].default, params["nints"].default) == (NBINS, NINTS)


@pytest.mark.parametrize(
    "nsamps,tsamp,period", [(1 << 14, 1e-3, 0.05037), (5000, 6.4e-5, 0.00503)]
)
def test_fold_bins_equal(nsamps, tsamp, period):
    np.testing.assert_array_equal(
        fold.fold_bins_np(nsamps, tsamp, period, NBINS, NINTS),
        jax_fold.fold_bins_np(nsamps, tsamp, period, NBINS, NINTS),
    )


def test_fold_time_series_matches_jax():
    rng = np.random.default_rng(0)
    n, periods = 1 << 14, (0.05037, 0.0131, 0.2)
    x = rng.normal(size=(len(periods), n)).astype(np.float32)
    bins = np.stack([fold.fold_bins_np(n, 1e-3, p, NBINS, NINTS) for p in periods])
    got = fold.fold_time_series(
        torch.from_numpy(x), torch.from_numpy(bins), nbins=NBINS, nints=NINTS
    ).numpy()
    want = np.asarray(
        jax_fold.fold_time_series(
            jnp.asarray(x), jnp.asarray(bins), nbins=NBINS, nints=NINTS
        )
    )
    assert got.shape == want.shape == (len(periods), NINTS, NBINS)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the count starts at 1: the f64 oracle with the bias
    oracle = jax_fold.fold_time_series_np(x[0], n, 1e-3, periods[0], NBINS, NINTS)
    np.testing.assert_allclose(got[0], oracle, rtol=1e-5, atol=1e-6)


def _pulse_folds(k: int, seed: int) -> np.ndarray:
    """(k, NINTS, NBINS) folds of a drifting pulse in noise."""
    rng = np.random.default_rng(seed)
    folds = rng.normal(size=(k, NINTS, NBINS)).astype(np.float32)
    b = np.arange(NBINS)
    for i in range(k):
        width, start, drift = 2 + 3 * i, 10 + 7 * i, (i % 3) - 1
        for s in range(NINTS):
            on = (b - start - drift * s // 4) % NBINS < width
            folds[i, s, on] += 8.0
    return folds


def test_optimiser_matches_jax():
    folds = _pulse_folds(5, seed=1)
    periods = np.asarray([0.05, 0.0131, 0.2, 0.7, 0.0021])
    tobs = 16.384
    got = FoldOptimiser().optimise(torch.from_numpy(folds), periods, tobs)
    want = JaxOptimiser(NBINS, NINTS).optimise(folds, periods, tobs)
    assert len(got) == len(want) == len(periods)
    for g, w in zip(got, want):
        for key in ("opt_width", "opt_bin", "opt_shift", "opt_period"):
            assert g[key] == w[key], key
        assert w["opt_sn"] > 20.0
        assert abs(g["opt_sn"] - w["opt_sn"]) <= 1e-4 * w["opt_sn"]
        np.testing.assert_allclose(g["opt_fold"], w["opt_fold"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["opt_prof"], w["opt_prof"], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("bin_,width", [(0, 0), (5, 3), (40, 17), (63, 62)])
def test_calculate_sn_matches_jax(bin_, width):
    prof = _pulse_folds(1, seed=2)[0].sum(axis=0)
    assert calculate_sn(prof, bin_, width) == jax_calculate_sn(
        prof, bin_, width, NBINS
    )


def test_whiten_fseries_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(80, 120, size=1 << 14).astype(np.uint8)
    got = whiten_fseries(torch.from_numpy(x), pos5=10, pos25=100).numpy()
    want = np.asarray(jax_whiten(jnp.asarray(x), pos5=10, pos25=100))
    assert not got[:5].any()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


TSAMP, PERIOD = 1e-3, 0.05037


@pytest.fixture(scope="module")
def trial_block():
    """(3, 2^14 + 100) u8 dedispersed trials; a 50.37 ms pulsar in trial 1,
    an accelerated copy of it (inverse resample map) in trial 2."""
    rng = np.random.default_rng(4)
    nsamps = (1 << 14) + 100
    size = 1 << 14
    j = np.arange(nsamps, dtype=np.float64)
    af = 2.5e-7  # a 16.8-sample drift at mid-series
    trials = rng.normal(100.0, 6.0, size=(3, nsamps))
    trials[1] += 25.0 * (((j * TSAMP / PERIOD) % 1.0) < 0.08)
    ginv = j - af * j * (j - size)
    trials[2] += 25.0 * (((ginv * TSAMP / PERIOD) % 1.0) < 0.08)
    return np.clip(np.rint(trials), 0, 255).astype(np.uint8), af


def _cands(cls, af):
    acc = af * 2.0 * 299792458.0 / TSAMP
    return [
        cls(dm=5.0, dm_idx=1, acc=0.0, nh=1, snr=40.0, freq=1.0 / PERIOD),
        cls(dm=9.0, dm_idx=2, acc=acc, nh=1, snr=30.0, freq=1.0 / PERIOD),
        cls(dm=1.0, dm_idx=0, acc=0.0, nh=0, snr=20.0, freq=1.0 / 0.0131),
        cls(dm=5.0, dm_idx=1, acc=0.0, nh=0, snr=15.0, freq=2000.0),  # P < 1 ms
        cls(dm=5.0, dm_idx=1, acc=-acc, nh=2, snr=12.0, freq=0.5 / PERIOD),
        cls(dm=9.0, dm_idx=2, acc=0.0, nh=0, snr=11.0, freq=1.0 / PERIOD),
    ]


def test_fold_geometry_matches_jax():
    for n, tsamp in (((1 << 14) + 100, TSAMP), ((1 << 21) + 7868, 64e-6)):
        assert fold_geometry(n, tsamp) == jax_fold_geometry(n, tsamp)


@pytest.mark.parametrize("n", [5, 6])
def test_multifolder_matches_jax(trial_block, n):
    trials, af = trial_block
    nsamps = trials.shape[1]
    got = MultiFolder(torch.from_numpy(trials), TSAMP).fold_outcomes(
        _cands(Candidate, af), n
    )
    want = JaxFolder(trials, nsamps, TSAMP).fold_outcomes(_cands(JaxCandidate, af), n)
    assert sorted(o["cand_idx"] for o in got) == sorted(o["cand_idx"] for o in want)
    assert 3 not in [o["cand_idx"] for o in got]  # out of the period range
    by_idx = {o["cand_idx"]: o for o in want}
    for g in got:
        w = by_idx[g["cand_idx"]]
        assert g["opt_period"] == w["opt_period"], g["cand_idx"]
        assert abs(g["opt_sn"] - w["opt_sn"]) <= 1e-3 * abs(w["opt_sn"]), g["cand_idx"]
        np.testing.assert_allclose(
            g["opt_fold"], w["opt_fold"], rtol=0, atol=1e-3 * np.abs(w["opt_fold"]).max()
        )
    # the pulsar folds clearly in both trials, the accelerated one only
    # at its own acceleration
    sn = {g["cand_idx"]: g["opt_sn"] for g in got}
    assert sn[0] > 30.0 and sn[1] > 30.0
    if n == 6:
        assert sn[5] < 0.5 * sn[1]


def test_apply_outcomes_resorts(trial_block):
    trials, af = trial_block
    folder = MultiFolder(torch.from_numpy(trials), TSAMP)
    cands = folder.fold_n(_cands(Candidate, af), 6)
    keys = [max(c.snr, c.folded_snr) for c in cands]
    assert keys == sorted(keys, reverse=True)
    folded = [c for c in cands if c.fold is not None]
    assert len(folded) == 5
    assert all(c.fold.shape == (NINTS, NBINS) and c.opt_period > 0 for c in folded)
