"""The acceleration-search device work for a block of DM trials.

The reference's hot loop (Worker::start, src/pipeline_multi.cu:144-243)
runs one FFT/spectrum/harmonic/peak pass per acceleration trial. Here a
block of DM trials is preprocessed together, then every (DM, accel)
trial of the block is one row of a batched chain:

  once per DM trial: pad (pipeline_multi.cu:112-114,160-163) -> rfft
  (174) -> |.| (178) -> running median (182) -> [specchain kernel:
  deredden (186), zap (188-192), interbin (196)] -> stats (200) ->
  irfft (204);
  per row: [resample kernel (212)] -> spectrum -> peaks.

The spectrum route (rfft (216), interbin (220), normalise (224)) is
either the dftspec kernel, which computes the packed DFT itself and fuses
the untwist, interbin and normalise, or cuFFT + the interbin kernel. The
peaks route (harmonic sums (228), peaks (233-234), clustering
(peakfinder.hpp:27-56)) is either the harmpeaks kernel, which sums the
harmonics inside the walk, or torch harmonic sums + the peaks kernel. The
search (pipeline/search.py:choose_routes) picks both where the JAX package
does.

This is the JAX package's fused chain (pipeline/accel_search.py:
_preprocess_block_fused and the ``fused_interbin`` branches of
_spectra_and_peaks), with rows in place of its (D, A) grid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.dftspec import dft_untwist_interbin
from ..ops.fft import packed_dft_z, untwist_interbin_normalise
from ..ops.harmonics import harmonic_sums, level_scales
from ..ops.peaks import find_cluster_peaks_multi, find_harmonic_cluster_peaks
from ..ops.rednoise import running_median
from ..ops.resample import resample_rows
from ..ops.spectrum import form_power, row_sum, specchain, spectrum_stats
from ..utils.trace import trace_span

# spectrum rows are padded to a multiple of this many bins, as the JAX
# package pads them to its peaks kernel's block (ops/pallas/peaks.py)
SPEC_ALIGN = 4096


class AccelSearchPeaks(NamedTuple):
    """Cluster peaks per row (one (DM, accel) trial) and level.

    idxs/snrs: (rows, nharms+1, max_peaks) — level 0 is the fundamental
    spectrum, level h the 2^h-harmonic sum; min-gap cluster peaks
    (identify_unique_peaks), padded with nbins / 0. counts: (rows,
    nharms+1) raw threshold crossings; ccounts: cluster counts, which
    may exceed max_peaks (the overflow-escalation signal).
    """

    idxs: torch.Tensor
    snrs: torch.Tensor
    counts: torch.Tensor
    ccounts: torch.Tensor


def padded_bins(size: int) -> int:
    """Spectrum row width: the size//2 + 1 true bins, padded to SPEC_ALIGN."""
    nbins = size // 2 + 1
    return -(-nbins // SPEC_ALIGN) * SPEC_ALIGN


def _pad_trials(tims: torch.Tensor, *, size: int, nsamps_valid: int) -> torch.Tensor:
    """Pad/truncate each trial to ``size`` with the reference's
    mean-padded tail (pipeline_multi.cu:160-163)."""
    x = tims[:, :size].to(torch.float32)
    if nsamps_valid < size:
        x = torch.nn.functional.pad(x, (0, size - x.shape[1]))
        mean_head = row_sum(x[:, :nsamps_valid])[:, None] / nsamps_valid
        idx = torch.arange(size, device=x.device)
        x = torch.where(idx < nsamps_valid, x, mean_head)
    return x


def _pre_spectrum_parts(tims, *, size, nsamps_valid, pos5, pos25):
    """The front half for a block of trials: pad, rfft, running median —
    returning the raw spectrum parts the specchain pass consumes."""
    x = _pad_trials(tims, size=size, nsamps_valid=nsamps_valid)
    fser = torch.fft.rfft(x, dim=-1)
    med = running_median(form_power(fser), pos5=pos5, pos25=pos25)
    return fser.real.contiguous(), fser.imag.contiguous(), med.contiguous()


def preprocess_block(tims, zapmask, *, size, nsamps_valid, pos5, pos25):
    """Once-per-DM-trial stage for a (D, >=size) block: returns the
    whitened, zapped time series xd (D, size) and the per-trial spectrum
    (mean, std) that normalise every accel trial's spectrum."""
    with trace_span("Spectrum-Chain"):
        re, im, med = _pre_spectrum_parts(
            tims, size=size, nsamps_valid=nsamps_valid, pos5=pos5, pos25=pos25
        )
        re_d, im_d, s0 = specchain(re, im, med, zapmask)
        mean, _, std = spectrum_stats(s0)
        xd = torch.fft.irfft(torch.complex(re_d, im_d), n=size, dim=-1)
    return xd, mean, std


def search_rows(
    xd: torch.Tensor,  # (D, size) f32 preprocessed series of the DM block
    row_dm: torch.Tensor,  # (R,) i32 each row's DM trial in the block
    afs: torch.Tensor,  # (R,) f32 acceleration factors
    mean: torch.Tensor,  # (R,) f32
    std: torch.Tensor,  # (R,) f32
    windows,  # (nharms+1, 2) int [start, limit) per level
    *,
    threshold: float,
    nharms: int,
    max_peaks: int,
    fused_dft: bool,
    mega_harm: bool,
    row_bounds: tuple[int, int] | None = None,
) -> AccelSearchPeaks:
    """Resample, spectrum, harmonic sums and cluster peaks for R (DM,
    accel) rows of one DM block. ``fused_dft`` takes the dftspec kernel
    for the spectrum, else cuFFT + the interbin kernel; ``mega_harm`` the
    harmpeaks kernel for sums and peaks, else torch sums + the peaks
    kernel. ``row_bounds``, row_dm's (min, max) where the caller knows them
    on the host, spares the resample wrapper its read. The stages run under the JAX package's named scopes
    (utils/trace.py:trace_span), which tools/scope_trace.py reads."""
    size = xd.shape[-1]
    nbins = size // 2 + 1
    npad = padded_bins(size)
    with trace_span("Acceleration-Loop"):
        with trace_span("Resample"):
            x = resample_rows(xd, row_dm, afs, bounds=row_bounds)
        with trace_span("Spectrum-Chain"):
            if fused_dft:
                s = dft_untwist_interbin(x, mean, std, npad=npad)
            else:
                s = untwist_interbin_normalise(packed_dft_z(x), mean, std, npad=npad)
        del x
        kw = dict(
            threshold=threshold, max_peaks=max_peaks, scales=level_scales(nharms),
            nbins=nbins,
        )
        if mega_harm:
            with trace_span("Harmonic summing"), trace_span("Peaks"):
                peaks = find_harmonic_cluster_peaks(s, windows, nharms=nharms, **kw)
        else:
            # s is padded to SPEC_ALIGN, so its sums are the JAX package's
            # block-aligned levels
            with trace_span("Harmonic summing"):
                sums = harmonic_sums(s, nharms=nharms, scaled=False)
            with trace_span("Peaks"):
                peaks = find_cluster_peaks_multi([s, *sums], windows, **kw)
    return AccelSearchPeaks(*peaks)
