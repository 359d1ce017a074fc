"""Real FFT of the per-acceleration series, and the spectrum it feeds.

The series is packed into a half-length complex sequence
z[j] = x[2j] + i*x[2j+1] (a free view of the f32 row), one complex DFT
of length m = n/2 runs in cuFFT (``torch.fft.fft``; the JAX package
computes the same DFT as matmul einsums, ops/fft.py:packed_dft_z, outside
any kernel), and the untwist to the true rfft bins is left to the
consumer:

  X[k] = (Z[k] + conj(Z[m-k]))/2 - i/2 e^{-2pi i k/n} (Z[k] - conj(Z[m-k]))

:func:`untwist_interbin_normalise` turns Z straight into the normalised
interbin spectrum: the hand-written kernel (csrc/interbin.cu) for CUDA
tensors, the plain version :func:`untwist_interbin_normalise_plain` for
CPU tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..device import check, on_cpu, stream_ptr
from .spectrum import form_interpolated_parts, normalise


def packed_dft_z(x: torch.Tensor) -> torch.Tensor:
    """(..., n) f32 series -> (..., n//2) complex64 Z = DFT_m(x[0::2] +
    i*x[1::2])."""
    n = x.shape[-1]
    z = torch.view_as_complex(
        x.to(torch.float32).contiguous().reshape(*x.shape[:-1], n // 2, 2)
    )
    return torch.fft.fft(z, dim=-1)


@lru_cache(maxsize=4)
def untwist_tables(m: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(m+1,) f32 untwist phasor e^{-i theta_k} = unc - i*uns, theta_k =
    2 pi k / (2m), computed in f64 and rounded once (as the JAX package's
    ops/pallas/interbin.py builds its tables)."""
    un = np.exp(-2j * np.pi * np.arange(m + 1, dtype=np.float64) / (2 * m))
    unc = torch.from_numpy(un.real.astype(np.float32)).to(device)
    uns = torch.from_numpy((-un.imag).astype(np.float32)).to(device)
    return unc, uns


def untwist_parts(
    z: torch.Tensor, unc: torch.Tensor, uns: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """rfft bins k = 0..m as (re, im) f32 from the packed DFT Z (..., m)."""
    zr, zi = z.real, z.imag
    zkr = torch.cat([zr, zr[..., :1]], dim=-1)  # Z[k], k = 0..m
    zki = torch.cat([zi, zi[..., :1]], dim=-1)
    zmr = torch.cat([zr[..., :1], zr.flip(-1)], dim=-1)  # Z[m-k]
    zmi = torch.cat([zi[..., :1], zi.flip(-1)], dim=-1)
    arr = 0.5 * (zkr + zmr)
    aii = 0.5 * (zki - zmi)
    br = zkr - zmr
    bi = zki + zmi
    xr = arr + 0.5 * (unc * bi - uns * br)
    xi = aii - 0.5 * (unc * br + uns * bi)
    return xr, xi


def untwist_interbin_normalise_plain(
    z: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, *, npad: int
) -> torch.Tensor:
    """The plain version: untwist, interbin, normalise, zero-pad to npad."""
    m = z.shape[-1]
    unc, uns = untwist_tables(m, z.device)
    s = normalise(form_interpolated_parts(*untwist_parts(z, unc, uns)), mean, std)
    return torch.nn.functional.pad(s, (0, npad - (m + 1)))


def untwist_interbin_normalise(
    z: torch.Tensor,  # (R, m) complex64 packed-DFT output
    mean: torch.Tensor,  # (R,) f32 per-row spectrum mean
    std: torch.Tensor,  # (R,) f32 per-row spectrum std
    *,
    npad: int,  # output width, > m
) -> torch.Tensor:
    """(R, npad) f32 normalised interbin spectrum of the real series
    whose packed half-length DFT is Z; bins k in [0, m] real, the rest
    zero."""
    if z.dim() != 2 or npad <= z.shape[-1]:
        raise ValueError(f"bad interbin geometry: z {tuple(z.shape)}, {npad=}")
    if on_cpu(z, mean, std):
        return untwist_interbin_normalise_plain(z, mean, std, npad=npad)
    check(z, "z", torch.complex64, 2)
    check(mean, "mean", torch.float32, 1)
    check(std, "std", torch.float32, 1)
    rows, m = z.shape
    if mean.shape != (rows,) or std.shape != (rows,):
        raise ValueError("mean and std must be (R,)")
    # the kernel's mirror pairs load Z[k..k+1] as one aligned 16-byte word
    # and store the output's low pairs as 8-byte words
    if m % 4 or npad % 2 or z.data_ptr() % 16:
        raise ValueError(
            f"bad interbin geometry for the kernel: m {m} (a multiple of 4), "
            f"npad {npad} (even), Z at {z.data_ptr() % 16} past 16-byte alignment"
        )
    unc, uns = untwist_tables(m, z.device)
    out = torch.empty((rows, npad), dtype=torch.float32, device=z.device)
    kernels.launch(
        "interbin", z.data_ptr(), unc.data_ptr(), uns.data_ptr(),
        mean.data_ptr(), std.data_ptr(), out.data_ptr(), rows, m, npad,
        stream_ptr(z.device), shape=(rows, m, npad),
    )
    return out
