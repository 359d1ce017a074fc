"""Fold optimisation (mini-PDMP): phase-shift x boxcar-template matched
filtering of folded subintegrations.

Reference: FoldOptimiser (include/transforms/folder.hpp:65-335) and its
kernels (src/kernels.cu:653-865). Pipeline per fold:
  FFT subints along phase -> multiply by nshifts linear phase ramps
  (subint-proportional shift) -> collapse subints -> multiply by
  ntemplates FFT'd boxcars (/ sqrt(width), bin0 zeroed) -> inverse FFT
  -> |.| -> 3-D argmax (template, shift, bin) -> S/N from on/off-pulse
  statistics of the recovered profile.

As in the JAX package, K candidates are optimised in one batched pass
of torch.fft (complex64) over (K, nshifts, nints, nbins) tensors on the
folds' device; the S/N is taken on the host. Quirks kept for parity: the
(32 - opt_shift) period-update constant (folder.hpp:330, which holds for
the reference's fixed 64 bins only), calculate_sn's width coming from
the 0-based template index, and S/N values > 99999 squashed to 0.
"""

from __future__ import annotations

import numpy as np
import torch

# the reference's fixed fold geometry (folder.hpp): 64 phase bins, 16
# subintegrations; the period update below is only right at 64 bins
NBINS, NINTS = 64, 16


def _shift_array() -> np.ndarray:
    """(nshifts, nints, nbins) complex64 phase ramps (kernels.cu:665-684)."""
    nbins, nints = NBINS, NINTS
    nshifts = nbins
    shift_mags = np.arange(nshifts, dtype=np.float64) - nshifts // 2
    subint = np.arange(nints, dtype=np.float64)
    b = np.arange(nbins, dtype=np.float64)
    ramp = b * 2.0 * np.pi / nbins
    ramp = np.where(b > nbins / 2, ramp - 2.0 * np.pi, ramp)
    shift = (subint / nints)[None, :, None] * shift_mags[:, None, None]
    return np.exp(-1j * ramp[None, None, :] * shift).astype(np.complex64)


def _templates_fft() -> np.ndarray:
    """FFT'd boxcar templates (nbins - 1, nbins) (kernels.cu:686-696)."""
    w = np.arange(NBINS - 1)[:, None]
    b = np.arange(NBINS)[None, :]
    boxcars = (b <= w).astype(np.complex64)
    return np.fft.fft(boxcars, axis=-1).astype(np.complex64)


def calculate_sn(prof: np.ndarray, bin: int, width: int) -> tuple[float, float]:
    """On/off-pulse S/N of a profile (folder.hpp:140-183).

    ``width`` is the 0-based template index, as passed by the reference's
    optimise() (folder.hpp:311). Negative centred indices wrap positively
    here (the reference's C % would go out of bounds — UB not copied).
    """
    nbins = NBINS
    edge = int(width * 0.3 + 0.5)
    width_by_2 = int(width / 2.0 + 0.5)
    rprof = np.array(
        [prof[(bin - nbins // 2 + ii) % nbins] for ii in range(nbins)],
        dtype=prof.dtype,
    )
    centre = nbins // 2 - 1
    upper = centre + (width_by_2 + edge)
    lower = centre - (width_by_2 + edge)
    sel = (np.arange(nbins) <= upper) & (np.arange(nbins) >= lower)
    on, off = rprof[sel], rprof[~sel]
    on_mean = on.mean()
    off_mean = off.mean()
    off_std = np.sqrt(np.mean((off - off_mean) ** 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        sn1 = (on_mean - off_mean) * np.sqrt(width) / off_std
        sn2 = ((rprof - off_mean) / off_std).sum() / np.sqrt(width)
    sn1 = 0.0 if not np.isfinite(sn1) or sn1 > 99999 else float(sn1)
    sn2 = 0.0 if not np.isfinite(sn2) or sn2 > 99999 else float(sn2)
    return sn1, sn2


class FoldOptimiser:
    """Batched fold optimiser; one device pass for K candidates."""

    def __init__(self):
        self._shiftar = torch.from_numpy(_shift_array())
        self._templates = torch.from_numpy(_templates_fft())

    def _device_pass(self, folds: torch.Tensor):
        nbins = NBINS
        dev = folds.device
        shiftar = self._shiftar.to(dev)
        templates = self._templates.to(dev)
        f = torch.fft.fft(folds.to(torch.complex64), dim=-1)  # (K, I, B)
        shifted = f[:, None, :, :] * shiftar[None]  # (K, S, I, B)
        profiles = shifted.sum(dim=2)  # (K, S, B) collapse subints
        width = torch.sqrt(
            torch.arange(1, templates.shape[0] + 1, dtype=torch.float32, device=dev)
        )
        final = (
            profiles[:, None, :, :]
            * templates[None, :, None, :]
            / width[None, :, None, None]
        )  # (K, W, S, B)
        final[..., 0] = 0.0  # bin0 zeroed (kernels.cu:741-742)
        # the inverse FFT's constant scale does not move the argmax
        tdom = torch.abs(torch.fft.ifft(final, dim=-1))
        argmax = torch.argmax(tdom.reshape(tdom.shape[0], -1), dim=-1)
        opt_template = argmax // (nbins * nbins)
        opt_bin = argmax % nbins - opt_template // 2
        opt_shift = (argmax // nbins) % nbins
        # the optimal subints and profile, scaled by nbins like the
        # reference's unnormalised inverse FFT
        k = torch.arange(folds.shape[0], device=dev)
        opt_subs = torch.fft.ifft(shifted[k, opt_shift], dim=-1).real * nbins
        opt_prof = torch.fft.ifft(profiles[k, opt_shift], dim=-1).real * nbins
        return opt_template, opt_bin, opt_shift, opt_subs, opt_prof

    def optimise(
        self, folds: torch.Tensor, periods: np.ndarray, tobs: float
    ) -> list[dict]:
        """Optimise K folded candidates.

        Args:
          folds: (K, NINTS, NBINS) f32 fold profiles, on any device.
          periods: (K,) trial periods in seconds.
          tobs: observation length in seconds.

        Returns one dict per candidate: opt_sn, opt_period, opt_width,
        opt_bin, opt_shift, opt_fold (NINTS, NBINS), opt_prof (NBINS,).
        """
        opt_template, opt_bin, opt_shift, opt_subs, opt_prof = (
            t.cpu().numpy() for t in self._device_pass(folds)
        )
        results = []
        for k in range(folds.shape[0]):
            sn1, sn2 = calculate_sn(opt_prof[k], int(opt_bin[k]), int(opt_template[k]))
            p = float(periods[k])
            opt_period = p * (
                ((32.0 - float(opt_shift[k])) * p) / (NBINS * float(tobs)) + 1.0
            )
            results.append(
                dict(
                    opt_sn=max(sn1, sn2),
                    opt_period=opt_period,
                    opt_width=int(opt_template[k]) + 1,
                    opt_bin=int(opt_bin[k]),
                    opt_shift=int(opt_shift[k]),
                    opt_fold=opt_subs[k],
                    opt_prof=opt_prof[k],
                )
            )
        return results
