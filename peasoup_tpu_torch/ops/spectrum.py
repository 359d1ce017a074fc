"""Power-spectrum forming, statistics and normalisation.

Reference kernels: power_series_kernel (amplitude via z*rsqrt(z)) and
bin_interbin_series_kernel (Fourier interpolation by nearest-bin
difference), src/kernels.cu:215-304; stats/normalise kernels
src/kernels.cu:420-494 and include/utils/stats.hpp.

:func:`specchain` is the once-per-DM-trial deredden -> zap -> interbin
pass: the hand-written kernel (csrc/specchain.cu) for CUDA tensors, the
plain version :func:`interp_deredden_zap` for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..device import check, on_cpu, stream_ptr


def form_power(fseries: torch.Tensor) -> torch.Tensor:
    """Amplitude spectrum |X_k| (the reference's "power series")."""
    return torch.abs(fseries).to(torch.float32)


def form_interpolated_parts(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Interbinned amplitude sqrt(max(|X_k|^2, 0.5|X_k - X_{k-1}|^2))
    over the last axis, X_{-1} = 0 (kernels.cu:231-252)."""
    re_l = torch.nn.functional.pad(re[..., :-1], (1, 0))
    im_l = torch.nn.functional.pad(im[..., :-1], (1, 0))
    ampsq = re * re + im * im
    dr = re - re_l
    di = im - im_l
    ampsq_diff = 0.5 * (dr * dr + di * di)
    return torch.sqrt(torch.maximum(ampsq, ampsq_diff))


def form_interpolated(fseries: torch.Tensor) -> torch.Tensor:
    """:func:`form_interpolated_parts` of a complex spectrum."""
    return form_interpolated_parts(
        fseries.real.to(torch.float32), fseries.imag.to(torch.float32)
    )


def interp_deredden_zap(
    re: torch.Tensor,  # (..., nbins) f32 real part of the raw spectrum
    im: torch.Tensor,  # (..., nbins) f32 imaginary part
    med: torch.Tensor,  # (..., nbins) f32 running median (rednoise)
    zapmask: torch.Tensor,  # (nbins,) bool birdie mask
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the spectrum-chain tail: deredden (divide by
    the running median, zero bins 0-4, kernels.cu:1013-1023), zap birdies
    to 1+0j (kernels.cu:1036-1069) and Fourier-interpolate the amplitude.
    Returns (re_d, im_d, s0): the dereddened+zapped parts (the irfft
    input) and the interbinned amplitude (the stats input)."""
    low5 = torch.arange(re.shape[-1], device=re.device) < 5
    zero = torch.zeros((), dtype=torch.float32, device=re.device)
    one = torch.ones((), dtype=torch.float32, device=re.device)
    re_d = torch.where(low5, zero, re / med)
    im_d = torch.where(low5, zero, im / med)
    re_d = torch.where(zapmask, one, re_d)
    im_d = torch.where(zapmask, zero, im_d)
    return re_d, im_d, form_interpolated_parts(re_d, im_d)


def s0_envelope(plain: torch.Tensor) -> torch.Tensor:
    """Per-bin bound on the kernel's s0 deviation from the plain version:
    a few ULP of the bin magnitude (FMA or reassociation in the plain
    version's squares-and-sum), as the JAX package's
    ops/pallas/specchain.py:s0_envelope states it."""
    rms = torch.sqrt(torch.mean(plain * plain, dim=-1, keepdim=True))
    return 1e-6 * (torch.abs(plain) + rms)


def specchain(
    re: torch.Tensor, im: torch.Tensor, med: torch.Tensor, zapmask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deredden + zap + interbin over a (D, nbins) batch in one pass.
    CUDA tensors go through the specchain kernel (parts bitwise equal to
    :func:`interp_deredden_zap`, s0 within :func:`s0_envelope`), CPU
    tensors through the plain version."""
    if on_cpu(re, im, med, zapmask):
        return interp_deredden_zap(re, im, med, zapmask)
    for t, name in ((re, "re"), (im, "im"), (med, "med")):
        check(t, name, torch.float32, 2)
    if not re.shape == im.shape == med.shape or zapmask.shape != re.shape[-1:]:
        raise ValueError("re, im, med must be (D, nbins) and zapmask (nbins,)")
    if zapmask.dtype != torch.bool:
        raise TypeError(f"zapmask: expected torch.bool, got {zapmask.dtype}")
    rows, nbins = re.shape
    zap = zapmask.contiguous().view(torch.uint8)
    re_d, im_d, s0 = (torch.empty_like(re) for _ in range(3))
    kernels.launch(
        "specchain", re.data_ptr(), im.data_ptr(), med.data_ptr(),
        zap.data_ptr(), re_d.data_ptr(), im_d.data_ptr(), s0.data_ptr(),
        rows, nbins, stream_ptr(re.device), shape=(rows, nbins),
    )
    return re_d, im_d, s0


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed order, in float64: add the row's
    eighths in turn (a remainder of under 8 onto the first elements), then
    fold the second half onto the first (an odd length's last element onto
    the first) until one element is left; the sum is rounded to x's dtype
    once. Elementwise adds only, so a row's sum has the same bits whatever
    the rows around it, wherever the row starts in memory, and on the CPU
    as on the card. torch.sum's order on the card follows the shape and
    alignment of the whole tensor, so a DM trial's statistics (and its
    candidates) would depend on the height of its DM block, which the
    memory ladder halves, and on its place in it. The float64 buffer is a
    quarter of x's bytes."""
    n = x.shape[-1]
    q = n // 8
    if q == 0:
        # audit: ignore[PSA003] -- the fixed-order accumulator (ROADMAP C.2), a quarter of x's bytes
        y = x.to(torch.float64)
    else:
        # audit: ignore[PSA003] -- the fixed-order accumulator (ROADMAP C.2), a quarter of x's bytes
        y = x[..., :q].to(torch.float64)
        for k in range(1, 8):
            y += x[..., k * q : (k + 1) * q]
        if n > 8 * q:
            y[..., : n - 8 * q] += x[..., 8 * q :]
    while y.shape[-1] > 1:
        h = y.shape[-1] // 2
        z = y[..., :h] + y[..., h : 2 * h]
        if y.shape[-1] % 2:
            z[..., :1] += y[..., 2 * h :]
        y = z
    return y[..., 0].to(x.dtype)


def spectrum_stats(
    x: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, rms, std) over the last axis; std = sqrt(rms^2 - mean^2)
    (stats.hpp:20-23). Sums by :func:`row_sum`."""
    n = x.shape[-1]
    mean = row_sum(x) / n
    rms = torch.sqrt(row_sum(x * x) / n)
    std = torch.sqrt(rms * rms - mean * mean)
    return mean, rms, std


def normalise(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std with broadcasting (kernels.cu:469-494)."""
    return (x - mean[..., None]) / std[..., None]
