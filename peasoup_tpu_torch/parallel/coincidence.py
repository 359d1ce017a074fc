"""Multibeam coincidence over a (possibly sharded) beam axis: the JAX
package's parallel/coincidence.py.

Reference: src/coincidencer.cpp + kernels.cu:1073-1100, an offline binary
looping over beam device pointers on one GPU. Here beams are a leading
tensor axis; per-beam baselining runs one beam at a time, and when the
beams are split over a mesh's 'beam' axis each shard counts its own
beams' threshold crossings on its device and the counts are summed
across shards (the JAX package's psum).
"""

from __future__ import annotations

import torch

from ..ops.coincidence import coincidence_mask
from ..ops.rednoise import whiten_fseries
from ..ops.spectrum import form_interpolated, normalise, spectrum_stats
from .mesh import Mesh


def baseline_beam(
    tim: torch.Tensor, *, size: int, pos5: int, pos25: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One beam's zero-DM baselining (coincidencer.cpp:163-180): returns
    (normalised interbinned spectrum (size//2+1,), normalised dereddened
    time series (size,))."""
    fser = whiten_fseries(tim[:size], pos5=pos5, pos25=pos25)
    spec = form_interpolated(fser)
    mean, _, std = spectrum_stats(spec)
    spec = normalise(spec, mean, std)
    xd = torch.fft.irfft(fser, n=size, dim=-1)
    tmean, _, tstd = spectrum_stats(xd)
    return spec, normalise(xd, tmean, tstd)


def sharded_coincidence(
    mesh: Mesh,
    beams: torch.Tensor,  # (B, N), B a multiple of the axis size
    thresh: float,
    beam_thresh: int,
    axis: str = "beam",
) -> torch.Tensor:
    """(N,) keep-mask on the axis's first device: 1.0 where fewer than
    ``beam_thresh`` beams exceed ``thresh``. Each shard holds B/n
    contiguous beams on its device; the exceed-counts are summed across
    shards."""
    devs = mesh.axis_devices(axis)
    if beams.shape[0] % len(devs):
        raise ValueError(f"{beams.shape[0]} beams do not split over {len(devs)} shards")
    per = beams.shape[0] // len(devs)
    shards = [beams[s * per : (s + 1) * per].to(dev) for s, dev in enumerate(devs)]
    total = sum(torch.sum(b > thresh, dim=0).to(devs[0]) for b in shards)
    return coincidence_mask(shards[0], thresh, beam_thresh, reduce=lambda _: total)
