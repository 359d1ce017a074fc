"""Running-median red-noise estimation.

Reference: Heimdall-derived median_scrunch5 / linear_stretch kernels
(src/kernels.cu:867-1011) composed into a three-scale piecewise median
spline by Dereddener::calculate_median
(include/transforms/dereddener.hpp:41-62). The search divides by the
median (with the first five bins zeroed) in the fused spectrum chain,
ops/spectrum.py:specchain; the candidate folder whitens with
:func:`whiten_fseries`.

All functions are batched over leading axes.
"""

from __future__ import annotations

import torch

from .spectrum import form_power


def median_scrunch5(x: torch.Tensor) -> torch.Tensor:
    """Median of non-overlapping blocks of 5 along the last axis.

    Truncates the tail like the reference (kernels.cu:972-979). For
    inputs shorter than 5 the reference degenerates to mean/median of
    what is there (kernels.cu:954-970).
    """
    n = x.shape[-1]
    if n == 1:
        return x
    if n == 2:
        return torch.mean(x, dim=-1, keepdim=True)
    if n in (3, 4):
        s = torch.sort(x, dim=-1).values
        if n == 3:
            return s[..., 1:2]
        return 0.5 * (s[..., 1:2] + s[..., 2:3])
    m = n // 5
    blocks = x[..., : m * 5].reshape(*x.shape[:-1], m, 5)
    return torch.sort(blocks, dim=-1).values[..., 2]


def linear_stretch(x: torch.Tensor, out_count: int) -> torch.Tensor:
    """Linear interpolation of the last axis up to ``out_count`` points.

    Matches linear_stretch_functor (kernels.cu:983-996): step is
    (in_count-1)/(out_count-1) in f32; fractional parts below 1e-5 snap
    to the left sample.
    """
    in_count = x.shape[-1]
    f32 = torch.float32
    step = torch.tensor(in_count - 1, dtype=f32) / torch.tensor(out_count - 1, dtype=f32)
    pos = torch.arange(out_count, dtype=f32, device=x.device) * step.to(x.device)
    j = pos.to(torch.int64)  # floor for non-negative
    frac = pos - j.to(f32)
    j1 = torch.clamp(j + 1, max=in_count - 1)
    left = x[..., j]
    right = x[..., j1]
    return torch.where(frac > 1e-5, left + frac * (right - left), left)


def running_median(powers: torch.Tensor, *, pos5: int, pos25: int) -> torch.Tensor:
    """Three-scale running median of an amplitude spectrum.

    Splices stretched medians of block size 5/25/125: bins [0,pos5) from
    the x5 median, [pos5,pos25) from x25, [pos25,end) from x125
    (dereddener.hpp:41-62). ``pos5``/``pos25`` are the bin positions of
    the boundary frequencies (0.05 Hz and 0.5 Hz by default).
    """
    size = powers.shape[-1]
    med5 = median_scrunch5(powers)
    med25 = median_scrunch5(med5)
    med125 = median_scrunch5(med25)
    s5 = linear_stretch(med5, size)
    s25 = linear_stretch(med25, size)
    s125 = linear_stretch(med125, size)
    idx = torch.arange(size, device=powers.device)
    return torch.where(idx < pos5, s5, torch.where(idx < pos25, s25, s125))


def deredden(fseries: torch.Tensor, median: torch.Tensor) -> torch.Tensor:
    """Divide the complex spectrum by the running median; zero bins 0-4
    (kernels.cu:1013-1023). The parts are divided separately, as the
    spectrum chain divides them."""
    med = median.to(torch.float32)
    out = torch.complex(fseries.real / med, fseries.imag / med)
    idx = torch.arange(fseries.shape[-1], device=fseries.device)
    return torch.where(idx < 5, torch.zeros((), dtype=out.dtype, device=out.device), out)


def whiten_fseries(x: torch.Tensor, *, pos5: int, pos25: int) -> torch.Tensor:
    """rfft -> amplitude -> running median -> dereddened Fourier series:
    the stanza the reference's candidate folder runs on each DM trial
    (folder.hpp:385-388)."""
    fser = torch.fft.rfft(x.to(torch.float32), dim=-1)
    med = running_median(form_power(fser), pos5=pos5, pos25=pos25)
    return deredden(fser, med)
