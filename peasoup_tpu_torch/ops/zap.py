"""RFI "birdie" zapping of known-interference frequency ranges.

Reference: zap_birdies_kernel (src/kernels.cu:1036-1069) sets spectrum
bins in [(f-w)/bw_floor, (f+w)/bw_ceil) to 1+0j. The bin mask is
precomputed on the host from the (freq, width) list (it only depends on
the plan, not the data) and applied as a select: inside the fused
spectrum chain (ops/spectrum.py:specchain) in the periodicity search, by
:func:`zap_birdies` in the FDAS search.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def birdie_mask(
    freqs: np.ndarray, widths: np.ndarray, bin_width: float, nbins: int
) -> np.ndarray:
    """Boolean (nbins,) mask, True where the spectrum must be replaced by 1.

    Bin ranges replicate the kernel exactly: low = floor((f-w)/bw)
    clamped to 0, high = ceil((f+w)/bw) clamped to nbins-1, half-open
    [low, high) — including the quirk that a range clipped at the top
    stops at nbins-2 (kernels.cu:1047-1057).
    """
    mask = np.zeros(nbins, dtype=bool)
    for f, w in zip(np.asarray(freqs, float), np.asarray(widths, float)):
        low = math.floor(np.float32(np.float32(f - w) / np.float32(bin_width)))
        high = math.ceil(np.float32(np.float32(f + w) / np.float32(bin_width)))
        if low < 0:
            low = 0
        if low >= nbins:
            continue
        if high >= nbins:
            high = nbins - 1
        mask[low:high] = True
    return mask


def zap_birdies(fseries: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Replace the masked bins of the complex spectrum with 1+0j (the JAX
    package's ops/zap.py:zap_birdies)."""
    one = torch.ones((), dtype=fseries.dtype, device=fseries.device)
    return torch.where(mask, one, fseries)
