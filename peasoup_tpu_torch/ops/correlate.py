"""Cross-beam delay finding by frequency-domain cross-correlation (the
JAX package's ops/correlate.py).

Reference: ``DelayFinder::find_delays`` (include/transforms/correlator.hpp:
44-92) FFTs beam ``ii``, conjugates it, and for every later beam ``jj``
FFTs it, multiplies, inverse-FFTs and takes the argmax of the powers of
the first and last ``max_delay`` lags. Here every beam is transformed
once, the conjugate products of all baselines are one batched multiply
and one batched inverse FFT, all on the beams' device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DelayResult(NamedTuple):
    """Per-baseline cross-correlation peaks.

    pairs: (P, 2) int32 beam-index pairs (ii, jj) with ii < jj.
    distance: (P,) int32 argmax position inside the 2*max_delay lag window,
      the reference's printed "Distance" (correlator.hpp:85-86): [0,
      max_delay) are lags 0..max_delay-1, [max_delay, 2*max_delay) lags
      -max_delay..-1.
    lag: (P,) int32 signed sample delay of the correlation peak.
    power: (P,) float32 |cc|^2 at the peak.
    """

    pairs: np.ndarray
    distance: torch.Tensor
    lag: torch.Tensor
    power: torch.Tensor


def baseline_pairs(nbeams: int) -> np.ndarray:
    """All (ii, jj) with ii < jj, in the reference's loop order
    (correlator.hpp:62-69)."""
    return np.asarray(
        [(i, j) for i in range(nbeams) for j in range(i + 1, nbeams)], dtype=np.int32
    ).reshape(-1, 2)


def find_delays(beams, max_delay: int, device: str | torch.device | None = None) -> DelayResult:
    """Cross-correlate every beam pair and locate the peak lag. ``beams``
    (B, N) real or complex series, a tensor (on its device) or numpy (on
    ``device``)."""
    beams = torch.as_tensor(beams, device=device)
    if not beams.is_complex():
        beams = beams.to(torch.complex64)
    if beams.dim() != 2:
        raise ValueError("beams must be (nbeams, nsamps)")
    nbeams, nsamps = beams.shape
    if not 0 < 2 * max_delay <= nsamps:
        raise ValueError("max_delay must be in (0, nsamps/2]")
    pairs = baseline_pairs(nbeams)
    pi = torch.from_numpy(pairs.astype(np.int64)).to(beams.device)
    spectra = torch.fft.fft(beams, dim=-1)  # one FFT a beam, not a pair
    cc = torch.fft.ifft(torch.conj(spectra[pi[:, 0]]) * spectra[pi[:, 1]], dim=-1)
    # positive lags, then negative, like the reference's two copies
    # (correlator.hpp:77-78)
    window = torch.cat([cc[:, :max_delay], cc[:, -max_delay:]], dim=-1)
    power = window.real ** 2 + window.imag ** 2
    distance = torch.argmax(power, dim=-1)
    lag = torch.where(distance < max_delay, distance, distance - 2 * max_delay)
    peak = torch.gather(power, -1, distance[:, None])[:, 0]
    return DelayResult(
        pairs=pairs, distance=distance.to(torch.int32), lag=lag.to(torch.int32),
        power=peak.to(torch.float32),
    )
