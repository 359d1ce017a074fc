"""Incoherent harmonic summing of power spectra.

Reference: harmonic_sum_kernel (src/kernels.cu:33-208) produces, for
fold level h in 1..5, sum_{k=1..2^h} p[(int)(i*k/2^h + 0.5)] scaled by
rsqrt(2^h), accumulating across levels (level h reuses level h-1's sum
and adds only the odd-k/2^h gathers). The float index expression is
exact integer math: (i*k + 2^(h-1)) >> h.

These are plain torch gathers (the JAX package's ``method="take"``
order). The search sums harmonics inside the harmpeaks kernel
(ops/peaks.py:find_harmonic_cluster_peaks) unless ``PEASOUP_MEGA_HARM=0``
asks for the JAX package's other route: unscaled sums of the padded
spectrum from here, then the peaks kernel
(ops/peaks.py:find_cluster_peaks_multi).
The JAX package computes those sums in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def level_scales(nharms: int) -> tuple[float, ...]:
    """Per-level rsqrt(2^h) factors, level 0 (the spectrum) first."""
    return (1.0,) + tuple(2.0 ** (-h / 2.0) for h in range(1, nharms + 1))


def harmonic_sums(
    p: torch.Tensor, *, nharms: int = 4, scaled: bool = True
) -> list[torch.Tensor]:
    """Cumulative fractional-harmonic sums of a (..., nbins) f32 spectrum.

    Gathers are added one ``+`` at a time in the reference order: levels
    h ascending, odd k ascending within a level. Returns ``nharms``
    arrays shaped like ``p``; entry h-1 is the 2^h-harmonic sum, scaled
    by f32(rsqrt(2^h)) unless ``scaled=False``. A gather for bin i reads
    a bin at or below i, so on a spectrum zero-padded past its true bins
    (as the spectrum kernels emit it) the true bins' sums are those of
    the unpadded spectrum, and the padding holds sums of real low bins:
    the JAX package's ``harmonic_sums(block_align=...)`` levels.
    """
    if not 0 < nharms <= 5:
        raise ValueError("nharms must be in 1..5")
    i = torch.arange(p.shape[-1], dtype=torch.int64, device=p.device)
    scales = level_scales(nharms)
    out = []
    val = p
    for h in range(1, nharms + 1):
        half = 1 << (h - 1)
        for k in range(1, 1 << h, 2):  # odd: new gathers this level
            val = val + p[..., (i * k + half) >> h]
        if scaled:
            out.append(val * torch.tensor(scales[h], dtype=torch.float32, device=p.device))
        else:
            out.append(val)
    return out
