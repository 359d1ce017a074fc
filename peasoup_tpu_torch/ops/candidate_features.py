"""Batched candidate features and the scorer's forward pass.

The ranking stage's device work (the JAX package's
ops/candidate_features.py), as plain torch on the batch's device: a batch
of fold products (folded profile, subintegration stamp, DM curve) becomes
a feature matrix, and the small MLP scorer runs over it. Feature rows are
independent (no reduction crosses rows), so the scoring loop can halve
the batch on out-of-memory and get the same bits.

The DM curve is the fold significance at :data:`DM_CURVE_FRACTIONS` of
the candidate DM (index 0 = the zero-DM hypothesis, last = the candidate
DM): broadband terrestrial RFI peaks at zero DM, a dispersed pulsar at its
own, and the contrast features carry that discriminant.

As in the JAX package: standard deviations are population ones (ddof 0;
``torch.std``'s default is the sample one), the median is the sorted
middle (the mean of the two middle values for an even count), and the
DM curve's argmax takes the first maximum. Sums may run in another order
than XLA's, so continuous features agree with the JAX package's to a
relative tolerance (tests/test_torch_rank.py).
"""

from __future__ import annotations

import torch

#: DM-curve sample points, as fractions of the candidate DM
DM_CURVE_FRACTIONS = (0.0, 0.25, 0.5, 0.75, 1.0)
DM_CURVE_POINTS = len(DM_CURVE_FRACTIONS)

#: Feature-matrix columns, in order; the model artifact pins this list
FEATURE_NAMES = (
    "prof_snr",            # (peak - off-pulse mean) / off-pulse std
    "prof_sharpness",      # fraction of bins above half the peak
    "offpulse_cv",         # off-pulse std / profile dynamic range
    "offpulse_mad_ratio",  # off-pulse MAD/std (baseline gaussianity)
    "subint_chi2",         # mean sq. dev of normalised subints vs prof
    "subint_corr_mean",    # mean subint-profile correlation
    "subint_persistence",  # fraction of subints correlated with prof
    "subint_intermittency",  # std/mean of per-subint peak amplitude
    "dm_contrast",         # (S(dm_c) - S(0)) / (|S(0)| + |S(dm_c)|)
    "dm_peakedness",       # (max - mean) / std over the DM curve
    "dm_argmax_frac",      # argmax position on the curve (1 = cand DM)
)
NFEATURES = len(FEATURE_NAMES)

_EPS = 1e-6


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as the sorted middle."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    mid = n // 2
    if n % 2:
        return s[..., mid]
    return 0.5 * (s[..., mid - 1] + s[..., mid])


def _std(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    return torch.std(x, dim=dim, correction=0, keepdim=keepdim)


def candidate_features_batch(
    prof: torch.Tensor,  # (B, nbins) f32 folded profiles
    subints: torch.Tensor,  # (B, nints, nbins) f32 subint stamps
    dm_curve: torch.Tensor,  # (B, DM_CURVE_POINTS) f32 significances
) -> torch.Tensor:
    """Feature matrix of a batch of fold products -> (B, NFEATURES) f32,
    each row the JAX package's ``_row_features`` of its own products."""
    # --- profile shape ------------------------------------------------
    med = _median_last(prof)[:, None]
    centred = prof - med
    peak = torch.amax(centred, dim=1, keepdim=True)
    on = centred > 0.5 * peak  # the half-max pulse window
    off = ~on
    zero = torch.zeros((), dtype=prof.dtype, device=prof.device)
    n_off = torch.clamp(off.sum(dim=1), min=1).to(torch.float32)
    off_mean = torch.where(off, prof, zero).sum(dim=1) / n_off
    dev = prof - off_mean[:, None]
    off_var = torch.where(off, dev * dev, zero).sum(dim=1) / n_off
    off_std = torch.sqrt(torch.clamp(off_var, min=0.0))
    off_mad = torch.where(off, torch.abs(dev), zero).sum(dim=1) / n_off
    pmax = torch.amax(prof, dim=1)
    dyn = pmax - torch.amin(prof, dim=1)
    prof_snr = (pmax - off_mean) / (off_std + _EPS)
    prof_sharpness = on.to(torch.float32).mean(dim=1)
    offpulse_cv = off_std / (dyn + _EPS)
    offpulse_mad_ratio = off_mad / (off_std + _EPS)

    # --- subintegration persistence ----------------------------------
    nprof = (prof - prof.mean(dim=1, keepdim=True)) / (_std(prof, 1, True) + _EPS)
    smean = subints.mean(dim=2, keepdim=True)
    sstd = _std(subints, 2, True)
    nsub = (subints - smean) / (sstd + _EPS)
    corr = (nsub * nprof[:, None, :]).mean(dim=2)  # (B, nints)
    resid = nsub - nprof[:, None, :]
    subint_chi2 = (resid * resid).mean(dim=(1, 2))
    subint_corr_mean = corr.mean(dim=1)
    subint_persistence = (corr > 0.15).to(torch.float32).mean(dim=1)
    peaks = torch.amax(subints, dim=2) - _median_last(subints)  # (B, nints)
    subint_intermittency = _std(peaks, 1) / (torch.abs(peaks.mean(dim=1)) + _EPS)

    # --- DM curve vs the zero-DM hypothesis --------------------------
    s0, sc = dm_curve[:, 0], dm_curve[:, -1]
    dm_contrast = (sc - s0) / (torch.abs(s0) + torch.abs(sc) + _EPS)
    dm_peakedness = (torch.amax(dm_curve, dim=1) - dm_curve.mean(dim=1)) / (
        _std(dm_curve, 1) + _EPS
    )
    dm_argmax_frac = torch.argmax(dm_curve, dim=1).to(torch.float32) / float(
        max(dm_curve.shape[1] - 1, 1)
    )

    return torch.stack(
        [
            prof_snr, prof_sharpness, offpulse_cv, offpulse_mad_ratio,
            subint_chi2, subint_corr_mean, subint_persistence,
            subint_intermittency, dm_contrast, dm_peakedness, dm_argmax_frac,
        ],
        dim=1,
    ).to(torch.float32)


def score_apply(feats, mean, scale, w1, b1, w2, b2) -> torch.Tensor:
    """The scorer's forward pass: standardise the features, one tanh
    hidden layer, logistic output -> (B,) f32 probabilities. The weights
    are arguments, so one function serves every model artifact."""
    z = (feats - mean[None, :]) / scale[None, :]
    h = torch.tanh(z @ w1 + b1[None, :])
    logit = h @ w2 + b2
    return torch.sigmoid(logit)
