"""The Fourier-domain acceleration search (FDAS) on a tile of DM trials and
templates: the JAX package's ops/fdas.py in torch.

Where the time-domain search resamples and transforms the series once per
acceleration trial, FDAS forms one dereddened, zapped spectrum per DM
trial and recovers every (f-dot, f-ddot) trial by correlating it with a
bank of finite-duration response templates (peasoup_tpu_torch/fdas/
templates.py): batched complex products in the frequency domain. A (DM
block x template batch) tile runs as one call of :func:`fdas_block_core`:
overlap-save correlation (torch.fft, cuFFT on the card), interbin power,
normalisation against the zero-drift spectrum's statistics, harmonic sums
and, per level, the first ``max_peaks`` threshold crossings
(:func:`ops.peaks.find_peaks_device`) clustered
(:func:`ops.peaks.cluster_peaks_device`). The JAX package computes all of
it in XLA, outside any Pallas kernel, and so does this module: plain torch
and cuFFT. The peaks kernel (csrc/peaks.cu) is not used here: it clusters
every crossing before it keeps ``max_peaks`` clusters, where the JAX FDAS
keeps the first ``max_peaks`` crossings and clusters those, and the two
differ when a level overflows.

Template rows are independent and every step is row-wise, so on the card
(where cuFFT and the row-wise steps do not depend on the batch height) a
split of the template batch or the DM block gives the same bits; torch's
CPU FFTs round with the batch height, so on the CPU only equal blocks give
equal bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from .harmonics import harmonic_sums
from .peaks import cluster_peaks_device, find_peaks_device
from .rednoise import whiten_fseries
from .spectrum import form_interpolated, normalise, row_sum, spectrum_stats
from .zap import zap_birdies


class FdasPeaks(NamedTuple):
    """Peak sets of a (DM block x template batch) tile.

    idxs, snrs: (D, nharms+1, T, max_peaks): level 0 is the template
    correlation power itself, level h the 2^h-harmonic sum; T indexes the
    template batch. counts: (D, nharms+1, T) threshold crossings, every
    one counted (more than max_peaks is an overflow); ccounts the cluster
    counts of the kept crossings."""

    idxs: torch.Tensor
    snrs: torch.Tensor
    counts: torch.Tensor
    ccounts: torch.Tensor


def _pad_trial(tims: torch.Tensor, *, size: int, nsamps_valid: int) -> torch.Tensor:
    """Pad or truncate each trial of (D, >=n) to ``size`` samples with the
    mean-padded tail of the search (pipeline/accel_search.py:_pad_trials:
    the mean of the valid head in :func:`row_sum`'s fixed order)."""
    x = tims[:, :size].to(torch.float32)
    if nsamps_valid < size:
        x = torch.nn.functional.pad(x, (0, size - x.shape[1]))
        mean_head = row_sum(x[:, :nsamps_valid])[:, None] / nsamps_valid
        idx = torch.arange(size, device=x.device)
        x = torch.where(idx < nsamps_valid, x, mean_head)
    return x


def correlate_bank(fser: torch.Tensor, tmpl: torch.Tensor, *, segment: int) -> torch.Tensor:
    """Overlap-save correlation of complex spectra (..., nbins) with every
    template row (T, width): out[..., t, r] = sum_j fser[..., r - half + j]
    * conj(tmpl[t, j]), half = (width - 1) // 2, for every bin r. Returns
    (..., T, nbins) complex64.

    The spectrum is cut into ``segment``-long windows advancing by ``step
    = segment - (width - 1)`` bins, taken as a strided view (``unfold``);
    each window's circular FFT correlation is valid on its first ``step``
    outputs, which tile the output exactly. Each template's output depends
    on that template alone."""
    nbins = fser.shape[-1]
    ntmpl, width = tmpl.shape
    half = (width - 1) // 2
    step = segment - (width - 1)
    if step <= 0:
        raise ValueError(f"segment {segment} too short for template width {width}")
    nseg = -(-nbins // step)
    total = nseg * step + width - 1
    fpad = torch.nn.functional.pad(fser, (half, total - nbins - half))
    segs = fpad.unfold(-1, segment, step)  # (..., nseg, segment), a view
    tf = torch.conj(torch.fft.fft(tmpl, n=segment, dim=-1))  # (T, segment)
    sf = torch.fft.fft(segs, dim=-1)  # (..., nseg, segment)
    y = torch.fft.ifft(sf[..., None, :, :] * tf[:, None, :], dim=-1)
    lead = fser.shape[:-1]
    y = y[..., :step].reshape(*lead, ntmpl, nseg * step)[..., :nbins]
    return y.to(torch.complex64)


def fdas_block_core(
    tims: torch.Tensor,  # (D, >=size) dedispersed trials of a DM block
    tmpl: torch.Tensor,  # (T, width) complex64 template batch (unit energy)
    zapmask: torch.Tensor,  # (size//2+1,) bool birdie mask
    windows,  # (nharms+1, 2) int [start, limit) per level
    *,
    threshold: float,
    size: int,
    nsamps_valid: int,
    segment: int,
    nharms: int,
    max_peaks: int,
    pos5: int,
    pos25: int,
) -> FdasPeaks:
    """The FDAS of a (DM block x template batch) tile: the JAX package's
    fdas_trial_core over every DM trial of the block (its fdas_block_core)
    in one batched pass: pad, whiten and zap each trial, then
    :func:`fdas_spectrum_peaks`."""
    x = _pad_trial(tims, size=size, nsamps_valid=nsamps_valid)
    fser = zap_birdies(whiten_fseries(x, pos5=pos5, pos25=pos25), zapmask)
    del x
    return fdas_spectrum_peaks(fser, tmpl, windows, threshold=threshold, segment=segment,
                               nharms=nharms, max_peaks=max_peaks)


def fdas_spectrum_peaks(
    fser: torch.Tensor,  # (D, nbins) complex64 whitened, zapped spectra
    tmpl: torch.Tensor,  # (T, width) complex64 template batch
    windows,  # (nharms+1, 2) int [start, limit) per level
    *,
    threshold: float,
    segment: int,
    nharms: int,
    max_peaks: int,
) -> FdasPeaks:
    """The tile's peaks from its whitened, zapped spectra: correlate with
    the template batch, interbin, normalise by the zero-drift spectrum's
    statistics (so every template row is scored against the same noise
    floor and the z = 0 row is the plain periodicity spectrum), sum
    harmonics, and per level keep the first ``max_peaks`` crossings of
    each (trial, template) row and cluster them."""
    with record_function("FDAS-Correlate"):
        mean, _, std = spectrum_stats(form_interpolated(fser))
        corr = correlate_bank(fser, tmpl, segment=segment)  # (D, T, nbins)
        s = normalise(form_interpolated(corr), mean[:, None], std[:, None])
        del corr
    d, t, nbins = s.shape
    with record_function("Harmonic summing"):
        levels = [s, *harmonic_sums(s, nharms=nharms, scaled=True)]
    dev = s.device
    idxs, snrs, counts, ccounts = [], [], [], []
    with record_function("Peaks"):
        for lvl, spec in enumerate(levels):
            lo = torch.full((d * t,), int(windows[lvl][0]), dtype=torch.int64, device=dev)
            hi = torch.full((d * t,), int(windows[lvl][1]), dtype=torch.int64, device=dev)
            i_, s_, c_ = find_peaks_device(
                spec.reshape(d * t, nbins), threshold, lo, hi, max_peaks=max_peaks
            )
            i_, s_, cc_ = cluster_peaks_device(i_, s_, c_, nbins=nbins)
            idxs.append(i_.reshape(d, t, max_peaks))
            snrs.append(s_.reshape(d, t, max_peaks))
            counts.append(c_.reshape(d, t))
            ccounts.append(cc_.reshape(d, t))
    return FdasPeaks(
        idxs=torch.stack(idxs, dim=1).to(torch.int32),
        snrs=torch.stack(snrs, dim=1),
        counts=torch.stack(counts, dim=1).to(torch.int32),
        ccounts=torch.stack(ccounts, dim=1).to(torch.int32),
    )
