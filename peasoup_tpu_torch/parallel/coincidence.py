"""Per-beam baselining for multibeam coincidence (the JAX package's
parallel/coincidence.py; its beam-sharded ``sharded_coincidence`` is not
ported: the port runs on one device).

Reference: src/coincidencer.cpp:163-180, one beam at a time.
"""

from __future__ import annotations

import torch

from ..ops.rednoise import whiten_fseries
from ..ops.spectrum import form_interpolated, normalise, spectrum_stats


def baseline_beam(
    tim: torch.Tensor, *, size: int, pos5: int, pos25: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One beam's zero-DM baselining: returns (normalised interbinned
    spectrum (size//2+1,), normalised dereddened time series (size,))."""
    fser = whiten_fseries(tim[:size], pos5=pos5, pos25=pos25)
    spec = form_interpolated(fser)
    mean, _, std = spectrum_stats(spec)
    spec = normalise(spec, mean, std)
    xd = torch.fft.irfft(fser, n=size, dim=-1)
    tmean, _, tstd = spectrum_stats(xd)
    return spec, normalise(xd, tmean, tstd)
