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
clip to [0, 255]. The kernel sums the same integers in integer lanes.

The delays and the kill mask are host arrays, the plan's: the wrapper
checks them and builds the kernel's per-block tables on the host
(:func:`_tables`), uploads them once for a plan and keeps them
(:func:`_device_tables`), so a call reads nothing back from the card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..device import check, stream_ptr

# the kernel's block (csrc/dedisp_map.cuh): output samples, DM trials, the
# widest channel chunk as a power of two, and the shared memory it may take
TILE, TRIALS, MAX_LOG_CHUNK = 2048, 16, 4
SMEM_BYTES = 227 * 1024


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
    delays,  # (D, C) int per-trial per-channel delay in samples
    killmask,  # (C,) 1 = keep
    *,
    out_nsamps: int,
    scale: float = 1.0,
) -> torch.Tensor:
    """The plain version: for each trial, channel rows shifted by their
    delay are added in ascending channel order, then scaled, rounded and
    clipped to u8. Returns (D, out_nsamps) u8."""
    x_ct = fil_tc.t().to(torch.float32).contiguous()
    x_ct = x_ct * torch.as_tensor(killmask, device=fil_tc.device).to(torch.float32)[:, None]
    dl = np.asarray(delays)
    out = torch.zeros(
        (dl.shape[0], out_nsamps), dtype=torch.float32, device=fil_tc.device
    )
    for d in range(dl.shape[0]):
        for c in range(dl.shape[1]):
            s = int(dl[d, c])
            out[d] += x_ct[c, s : s + out_nsamps]
    return _quantize(out, scale)


def _host(a, name: str) -> np.ndarray:
    """A host array (numpy, or a CPU tensor) as numpy; the kernel's tables
    are built on the host, so a table on the card would stall it."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name} must be a host array (the plan's), not on {a.device}")
        return a.numpy()
    return np.asarray(a)


def _pitch_words(max_spread: int) -> int:
    """csrc/dedisp_map.cuh:pitch_words."""
    return ((TILE + max_spread + 4 + 3) // 4) | 1


def _tables(delays: np.ndarray, chans: np.ndarray) -> dict:
    """The kernel's per-block tables (csrc/dedisp_map.cuh): for each tile of
    TRIALS DM trials and each chunk of 2^log_chunk kept channels, the least
    delay ``lo`` and the spread of the rest above it, and each trial's
    delay on each channel less ``lo`` as 16 bits, a record of TRIALS per
    channel. Chunks are as wide as shared memory allows, up to 16 channels."""
    ndm = delays.shape[0]
    nkept = len(chans)
    ntiles = -(-ndm // TRIALS)
    dk = delays[:, chans].astype(np.int64)
    # padding trials repeat the last one, which moves no tile's least or
    # largest delay; the kernel writes no padding trial
    dk = np.concatenate([dk, np.repeat(dk[-1:], ntiles * TRIALS - ndm, axis=0)])
    for log_chunk in range(MAX_LOG_CHUNK, -1, -1):
        chunk = 1 << log_chunk
        nchunks = -(-nkept // chunk)
        if nchunks == 0:
            lo = spread = np.zeros((ntiles, 0), np.int64)
            rel = np.zeros((ntiles, 0, chunk, TRIALS), np.uint16)
        else:
            kp = np.concatenate(
                [dk, np.repeat(dk[:, -1:], nchunks * chunk - nkept, axis=1)], axis=1
            ).reshape(ntiles, TRIALS, nchunks, chunk)
            lo = kp.min(axis=(1, 3))
            spread = kp.max(axis=(1, 3)) - lo
            rel = (kp - lo[:, None, :, None]).transpose(0, 2, 3, 1)
        max_spread = int(spread.max()) if spread.size else 0
        pitch = _pitch_words(max_spread)
        # the kernel's shared memory: the records, then the larger of the
        # window and the output tile
        smem = (2 << MAX_LOG_CHUNK) * TRIALS + max(chunk * pitch * 4, TRIALS * TILE + 4)
        if max_spread <= 0xFFFF and smem <= SMEM_BYTES:
            return dict(
                rel=np.ascontiguousarray(rel, dtype=np.uint16),
                lo_spread=np.stack([lo, spread], axis=-1).astype(np.int32),
                log_chunk=log_chunk, nchunks=nchunks, pitch=pitch,
            )
    raise ValueError(
        f"the delays of one DM tile spread over {max_spread} samples on one "
        "channel: past what the dedisperse kernel stages"
    )


def dedisperse(
    fil_tc: torch.Tensor,
    delays,
    killmask,
    out_nsamps: int,
    *,
    scale: float = 1.0,
) -> torch.Tensor:
    """All DM trials at once; bitwise equal to :func:`dedisperse_block`.
    ``delays`` (D, C) and ``killmask`` (C,) are host arrays (the plan's),
    checked and turned into the kernel's tables on the host. A CUDA
    ``fil_tc`` goes through the dedisperse kernel, a CPU one through the
    plain version."""
    delays = _host(delays, "delays")
    killmask = _host(killmask, "killmask")
    if fil_tc.device.type == "cpu":
        return dedisperse_block(
            fil_tc, delays, killmask, out_nsamps=out_nsamps, scale=scale
        )
    check(fil_tc, "fil_tc", torch.uint8, 2)
    t_in, nchans = fil_tc.shape
    ndm = delays.shape[0]
    if delays.ndim != 2 or delays.shape[1] != nchans or killmask.shape != (nchans,):
        raise ValueError(
            f"shape mismatch: fil {tuple(fil_tc.shape)}, delays "
            f"{delays.shape}, killmask {killmask.shape}"
        )
    if not ((killmask == 0) | (killmask == 1)).all():
        raise ValueError("killmask must hold 0 and 1 only")
    if ndm and (int(delays.min()) < 0 or int(delays.max()) + out_nsamps > t_in):
        raise ValueError("delays reach outside the filterbank")
    chans = np.flatnonzero(killmask).astype(np.int32)
    if len(chans) * 255 >= 1 << 24:
        raise ValueError("more kept channels than f32 sums hold exactly")
    out = torch.empty((ndm, out_nsamps), dtype=torch.uint8, device=fil_tc.device)
    if ndm == 0 or out_nsamps <= 0:
        return out
    buf, geom = _device_tables(
        delays.astype(np.int32, copy=False).tobytes(), delays.shape, chans.tobytes(),
        fil_tc.device,
    )
    base = buf.data_ptr()
    kernels.launch(
        "dedisperse", fil_tc.data_ptr(), t_in, nchans, base + geom["chans_at"],
        len(chans), base, base + geom["lo_spread_at"], geom["log_chunk"],
        geom["nchunks"], geom["pitch"], out.data_ptr(), ndm, out_nsamps,
        float(scale), int(scale != 1.0), stream_ptr(fil_tc.device),
        shape=(t_in, nchans, ndm, out_nsamps),
    )
    return out


@lru_cache(maxsize=4)
def _device_tables(delay_bytes: bytes, shape: tuple, chan_bytes: bytes, device):
    """:func:`_tables` of the delays and kept channels (given as bytes, so
    a plan's tables are built and uploaded once a process), as one device
    buffer: the records (16-byte aligned), then lo/spread, then the kept
    channels; and the byte offsets and geometry the kernel takes."""
    delays = np.frombuffer(delay_bytes, dtype=np.int32).reshape(shape)
    chans = np.frombuffer(chan_bytes, dtype=np.int32)
    tab = _tables(delays, chans)
    rel32 = tab["rel"].reshape(-1).view(np.int32)
    lo_spread = tab["lo_spread"].reshape(-1)
    buf = torch.from_numpy(np.concatenate([rel32, lo_spread, chans])).to(device)
    geom = dict(
        lo_spread_at=4 * rel32.size, chans_at=4 * (rel32.size + lo_spread.size),
        log_chunk=tab["log_chunk"], nchunks=tab["nchunks"], pitch=tab["pitch"],
    )
    return buf, geom
