"""Incoherent dedispersion: out[d, t] = sum_c kill[c] * x[t + delay[d, c], c].

The reference delegates this to the external ``dedisp`` CUDA library
(reference: include/transforms/dedisperser.hpp:98-113); the JAX package
runs it as a channel scan (ops/dedisperse.py) or its Pallas kernel. Here
:func:`dedisperse` launches the hand-written kernel
(csrc/dedisperse.cu) for CUDA tensors and runs the plain version
:func:`dedisperse_block` for CPU tensors.

Output matches the reference's u8 trials: channel sums of <=8-bit
samples are exact integers in f32, so the summation order cannot change
them, then ``scale`` (:func:`output_scale`), round half to even and a
clip to [0, 255].
"""

from __future__ import annotations

import torch

from .. import kernels
from ..device import check, on_cpu, stream_ptr


def unpack_fil_device(
    raw: torch.Tensor, *, nbits: int, nsamps: int, nchans: int
) -> torch.Tensor:
    """Unpack sub-byte filterbank samples on the tensor's device
    (LSB-first within each byte, matching io.sigproc.unpack_bits and
    libdedisp's sub-word extraction): (nbytes,) u8 -> (nsamps, nchans)
    u8. The host uploads the packed bytes, 8/nbits times fewer than the
    samples."""
    per = 8 // nbits
    shifts = torch.arange(per, dtype=torch.uint8, device=raw.device) * nbits
    mask = (1 << nbits) - 1
    w = torch.bitwise_and(torch.bitwise_right_shift(raw[:, None], shifts), mask)
    return w.reshape(nsamps, nchans)


def fil_to_device(fil, device: torch.device) -> torch.Tensor:
    """A Filterbank's samples as a (nsamps, nchans) u8 tensor on
    ``device``, uploading packed bytes when the file had sub-byte
    samples."""
    raw = getattr(fil, "raw", None)
    if raw is not None and fil.nbits in (1, 2, 4):
        return unpack_fil_device(
            torch.from_numpy(raw).to(device), nbits=fil.nbits,
            nsamps=fil.nsamps, nchans=fil.nchans,
        )
    return torch.tensor(fil.data, device=device)


def output_scale(nbits: int, nchans_kept: int) -> float:
    """Data-independent factor keeping worst-case channel sums inside u8.

    1.0 whenever raw sums already fit (e.g. 2-bit x 64 channels = 192),
    else shrink so the maximum possible sum maps to 255.
    """
    max_sum = (2**nbits - 1) * max(1, nchans_kept)
    return 1.0 if max_sum <= 255 else 255.0 / max_sum


def _quantize(acc: torch.Tensor, scale: float) -> torch.Tensor:
    if scale != 1.0:
        acc = acc * torch.tensor(scale, dtype=torch.float32, device=acc.device)
    return torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)


def dedisperse_block(
    fil_tc: torch.Tensor,  # (T, C) u8 filterbank samples
    delays: torch.Tensor,  # (D, C) int32 per-trial per-channel delay in samples
    killmask: torch.Tensor,  # (C,) 1 = keep
    *,
    out_nsamps: int,
    scale: float = 1.0,
) -> torch.Tensor:
    """The plain version: for each trial, channel rows shifted by their
    delay are added in ascending channel order, then scaled, rounded and
    clipped to u8. Returns (D, out_nsamps) u8."""
    x_ct = fil_tc.t().to(torch.float32).contiguous()
    x_ct = x_ct * killmask.to(torch.float32)[:, None]
    dl = delays.cpu().numpy()
    out = torch.zeros(
        (dl.shape[0], out_nsamps), dtype=torch.float32, device=fil_tc.device
    )
    for d in range(dl.shape[0]):
        for c in range(dl.shape[1]):
            s = int(dl[d, c])
            out[d] += x_ct[c, s : s + out_nsamps]
    return _quantize(out, scale)


def dedisperse(
    fil_tc: torch.Tensor,
    delays: torch.Tensor,
    killmask: torch.Tensor,
    out_nsamps: int,
    *,
    scale: float = 1.0,
) -> torch.Tensor:
    """All DM trials at once; bitwise equal to :func:`dedisperse_block`.
    CUDA tensors go through the dedisperse kernel, CPU tensors through
    the plain version."""
    if on_cpu(fil_tc, delays, killmask):
        return dedisperse_block(
            fil_tc, delays, killmask, out_nsamps=out_nsamps, scale=scale
        )
    check(fil_tc, "fil_tc", torch.uint8, 2)
    check(delays, "delays", torch.int32, 2)
    t_in, nchans = fil_tc.shape
    ndm = delays.shape[0]
    if delays.shape[1] != nchans or killmask.shape != (nchans,):
        raise ValueError(
            f"shape mismatch: fil {tuple(fil_tc.shape)}, delays "
            f"{tuple(delays.shape)}, killmask {tuple(killmask.shape)}"
        )
    if ndm and (int(delays.min()) < 0 or int(delays.max()) + out_nsamps > t_in):
        raise ValueError("delays reach outside the filterbank")
    x_ct = fil_tc.t().contiguous()
    kill = killmask.to(torch.float32).contiguous()
    out = torch.empty((ndm, out_nsamps), dtype=torch.uint8, device=fil_tc.device)
    kernels.launch(
        "dedisperse", x_ct.data_ptr(), delays.data_ptr(), kill.data_ptr(),
        out.data_ptr(), t_in, nchans, ndm, out_nsamps, float(scale),
        int(scale != 1.0), stream_ptr(fil_tc.device),
        shape=(t_in, nchans, ndm, out_nsamps),
    )
    return out
