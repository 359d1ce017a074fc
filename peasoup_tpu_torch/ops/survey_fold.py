"""Survey-scale batched folding: many candidates, one batch.

The per-observation folder (:mod:`peasoup_tpu_torch.pipeline.folder`)
folds the candidates of one DM trial against one dereddened series. At
campaign scale candidates from different observations and DM trials fold
together, so this batch carries one dereddened series per row: each row
is resampled at its own acceleration factor and folded through its own
phase-bin map. Rows are independent, so a candidate's fold is the same
bits here as in the per-observation folder (tests/test_torch_sift.py; on
the card, chip_smoke.py phase 24). The JAX package computes this outside
any Pallas kernel (its ops/survey_fold.py, a gather and a segment sum);
here it is plain torch on the rows' device.
"""

from __future__ import annotations

import torch

from .fold import fold_time_series
from .resample import resample_accel_quadratic_rows


def survey_fold_batch(
    xd: torch.Tensor,  # (B, N) f32 dereddened series, one per candidate
    afs: torch.Tensor,  # (B,) f32 acceleration factors (a*tsamp/2c)
    flat_bins: torch.Tensor,  # (B, used) int from fold_bins_np per row
    *,
    nbins: int,
    nints: int,
) -> torch.Tensor:
    """Resample + fold a batch of candidates -> (B, nints, nbins): the
    folder's per-candidate chain (quadratic resample, then the segment-sum
    fold with the reference's 1+hits count bias) with a series per row."""
    xr = resample_accel_quadratic_rows(xd, afs)
    used = flat_bins.shape[-1]
    return fold_time_series(xr[:, :used], flat_bins, nbins=nbins, nints=nints)
