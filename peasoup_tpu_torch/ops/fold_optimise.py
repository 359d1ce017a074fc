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
folds' device; the S/N is taken on the host. Each fold's result is its
own, whatever else shares the batch: the subints are collapsed by adding
them one by one in order (a reduction kernel's order may change with the
batch on the card), so the per-observation folder and the survey folder
give one candidate the same bits. Quirks kept for parity: the
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


def _shift_array(nbins: int = NBINS, nints: int = NINTS) -> np.ndarray:
    """(nshifts, nints, nbins) complex64 phase ramps (kernels.cu:665-684)."""
    nshifts = nbins
    shift_mags = np.arange(nshifts, dtype=np.float64) - nshifts // 2
    subint = np.arange(nints, dtype=np.float64)
    b = np.arange(nbins, dtype=np.float64)
    ramp = b * 2.0 * np.pi / nbins
    ramp = np.where(b > nbins / 2, ramp - 2.0 * np.pi, ramp)
    shift = (subint / nints)[None, :, None] * shift_mags[:, None, None]
    return np.exp(-1j * ramp[None, None, :] * shift).astype(np.complex64)


def _templates_fft(nbins: int = NBINS) -> np.ndarray:
    """FFT'd boxcar templates (nbins - 1, nbins) (kernels.cu:686-696)."""
    w = np.arange(nbins - 1)[:, None]
    b = np.arange(nbins)[None, :]
    boxcars = (b <= w).astype(np.complex64)
    return np.fft.fft(boxcars, axis=-1).astype(np.complex64)


def calculate_sn(prof: np.ndarray, bin: int, width: int,
                 nbins: int = NBINS) -> tuple[float, float]:
    """On/off-pulse S/N of a profile (folder.hpp:140-183).

    ``width`` is the 0-based template index, as passed by the reference's
    optimise() (folder.hpp:311). Negative centred indices wrap positively
    here (the reference's C % would go out of bounds — UB not copied).
    """
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
    """Batched fold optimiser; one device pass for K candidates. The
    geometry defaults to the reference's 64 bins x 16 subints; the survey
    folder passes its own, as the JAX package's does."""

    def __init__(self, nbins: int = NBINS, nints: int = NINTS):
        self.nbins, self.nints = int(nbins), int(nints)
        self._shiftar = torch.from_numpy(_shift_array(self.nbins, self.nints))
        self._templates = torch.from_numpy(_templates_fft(self.nbins))

    def _device_pass(self, folds: torch.Tensor):
        nbins = self.nbins
        dev = folds.device
        shiftar = self._shiftar.to(dev)
        templates = self._templates.to(dev)
        f = torch.fft.fft(folds.to(torch.complex64), dim=-1)  # (K, I, B)
        shifted = f[:, None, :, :] * shiftar[None]  # (K, S, I, B)
        # collapse subints (K, S, B), adding them in order: each row's sum
        # is the same in any batch and on either device
        profiles = shifted[:, :, 0]
        for i in range(1, shifted.shape[2]):
            profiles = profiles + shifted[:, :, i]
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

    def optimise(self, folds: torch.Tensor, periods: np.ndarray, tobs) -> list[dict]:
        """Optimise K folded candidates.

        Args:
          folds: (K, nints, nbins) f32 fold profiles, on any device.
          periods: (K,) trial periods in seconds.
          tobs: observation length in seconds: a scalar, or (K,) when the
            batch mixes observations of different lengths (the survey
            folder's batches).

        Returns one dict per candidate: opt_sn, opt_period, opt_width,
        opt_bin, opt_shift, opt_fold (nints, nbins), opt_prof (nbins,).
        """
        opt_template, opt_bin, opt_shift, opt_subs, opt_prof = (
            t.cpu().numpy() for t in self._device_pass(folds)
        )
        tobs_k = np.broadcast_to(np.asarray(tobs, dtype=np.float64), (folds.shape[0],))
        results = []
        for k in range(folds.shape[0]):
            sn1, sn2 = calculate_sn(opt_prof[k], int(opt_bin[k]), int(opt_template[k]),
                                    self.nbins)
            p = float(periods[k])
            opt_period = p * (
                ((32.0 - float(opt_shift[k])) * p) / (self.nbins * float(tobs_k[k])) + 1.0
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
