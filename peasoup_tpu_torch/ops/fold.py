"""Time-series folding into (subint, phase-bin) profiles.

Reference: fold_time_series_kernel — one CUDA block per subint builds a
shared-memory phase histogram with atomicAdd, phase from
frac(jj*tsamp/period)*nbins in f64, and a count array initialised to 1
(an off-by-one bias kept for parity; src/kernels.cu:597-651).

As in the JAX package, the phase->bin map is computed exactly in host
f64 (:func:`fold_bins_np`) and the fold itself is a segment sum on the
device, batched over candidates. On the CPU ``index_add_`` adds each
segment's samples in order. On the card the sums go through
``index_put_(accumulate=True)``, which sorts the indices and reduces each
segment in a fixed order, not through atomics: a row's fold is the same
from run to run and in any batch, so the survey folder and the
per-observation folder give one candidate the same bits there too.
"""

from __future__ import annotations

import numpy as np
import torch


def fold_bins_np(
    nsamps: int, tsamp: float, period: float, nbins: int, nints: int
) -> np.ndarray:
    """Exact (f64) flattened (subint*nbins + phase_bin) index per sample.

    Samples beyond nints*(nsamps//nints) are dropped, like the kernel's
    per-block ranges. Returns (nints*(nsamps//nints),) int32.
    """
    nsps = nsamps // nints
    used = nsps * nints
    jj = np.arange(used, dtype=np.float64)
    frac = np.mod(jj * (tsamp / period), 1.0)
    bins = np.floor(frac * nbins).astype(np.int32)
    subs = (np.arange(used) // nsps).astype(np.int32)
    return subs * nbins + bins


def fold_time_series(
    x: torch.Tensor,  # (K, used_nsamps) f32 resampled time series
    flat_bins: torch.Tensor,  # (K, used_nsamps) int from fold_bins_np
    *,
    nbins: int,
    nints: int,
) -> torch.Tensor:
    """Segment-sum fold -> (K, nints, nbins), value = sum/(1+hits)."""
    nseg = nints * nbins
    k = x.shape[0]
    seg = flat_bins.to(torch.int64) + (
        torch.arange(k, device=x.device)[:, None] * nseg
    )
    seg = seg.reshape(-1)
    vals = x.to(torch.float32).reshape(-1)
    sums = torch.zeros(k * nseg, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        sums.index_add_(0, seg, vals)
    else:
        sums.index_put_((seg,), vals, accumulate=True)
    counts = torch.zeros(k * nseg, dtype=torch.float32, device=x.device)
    # whole numbers below 2^24: exact in any order
    counts.index_add_(0, seg, torch.ones_like(vals))
    return (sums / (counts + 1.0)).reshape(k, nints, nbins)
