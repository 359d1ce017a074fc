"""The fused spectrum of the tutorial-sized search: the packed DFT of each
resampled series, untwist, interbin and normalise in one call.

Counterpart of the JAX package's ops/pallas/dftspec.py. The JAX package
takes this route where its geometry gate holds (pow2 m = n/2 <= 2^17, an
output pad that n1 divides) and its select resample serves the shift
span; elsewhere the search takes cuFFT + the interbin kernel
(ops/fft.py). :func:`dft_untwist_interbin` is the hand-written dftspec
kernel (csrc/dftspec.cu: the DFT and the epilogue in one launch, one
thread-block cluster a row, no scratch in device memory) for CUDA
tensors, and the plain version :func:`dft_untwist_interbin_plain` for
CPU tensors.

The geometry helpers and the accuracy oracle (:func:`oracle_data`,
:func:`accuracy_rel`, ``ACC_MAX_REL``, ``ACC_Q999_REL``) are copies of the
JAX package's (``accuracy_rel`` in torch), so the port's kernel is held to
the same gate; :func:`accuracy` reads the gate's two numbers, for the
tests and for the on-card check alike.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import check, on_cpu, stream_ptr
from .fft import packed_dft_z, untwist_interbin_normalise_plain, untwist_tables

_MAX_M = 1 << 17  # the JAX kernel's VMEM gate on the half length

# accuracy class against the exact chain: per-bin max and 99.9% quantile
ACC_MAX_REL = 1e-3
ACC_Q999_REL = 2e-4


def plane_factors(m: int) -> tuple[int, int]:
    """The DFT factorisation m = n1 * n2, n1 the power of two at or below
    sqrt(m)."""
    n1 = 1 << ((m.bit_length() - 1) // 2)
    return n1, m // n1


def _geometry(m: int, npad: int) -> tuple[int, int, int]:
    """(n1, n2, npad // n1) for half length ``m`` and output pad ``npad``,
    or ValueError where the JAX kernel refuses the shape."""
    if m <= 0 or m & (m - 1):
        raise ValueError(f"fused DFT kernel needs pow2 m, got {m}")
    if m > _MAX_M:
        raise ValueError(f"fused DFT kernel gated to m <= {_MAX_M}, got {m}")
    n1, n2 = plane_factors(m)
    if npad % n1 or npad <= m or n1 % 128 or n2 % 8:
        raise ValueError(f"bad dftspec geometry {m=} {npad=} {n1=} {n2=}")
    return n1, n2, npad // n1


def dftspec_supported(size: int, npad: int) -> bool:
    """True iff the fused route takes series length ``size`` and output
    pad ``npad``."""
    if size <= 0 or size % 2:
        return False
    try:
        _geometry(size // 2, npad)
    except ValueError:
        return False
    return True


def oracle_data(n: int, r: int = 9, seed: int = 0):
    """The tone + noise case of the accuracy gate: interbin's max() takes
    both branches and the gate sees the cancellation-heavy bins beside the
    tone. Returns (x, xe, xo, mean, std) as numpy."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (
        rng.normal(size=(r, n)) + 3.0 * np.sin(2 * np.pi * t * 0.1317)
    ).astype(np.float32)
    xe = np.ascontiguousarray(x[:, 0::2])
    xo = np.ascontiguousarray(x[:, 1::2])
    mean = rng.normal(size=r).astype(np.float32)
    std = (0.5 + rng.random(r)).astype(np.float32)
    return x, xe, xo, mean, std


def accuracy_rel(
    got: torch.Tensor, ref: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
    m: int,
) -> torch.Tensor:
    """Per-bin |amp - amp_ref| / (|amp_ref| + row rms) on the
    un-normalised amplitudes of bins 0..m (gate: max <= ACC_MAX_REL,
    99.9% quantile <= ACC_Q999_REL; :func:`accuracy` reads both)."""
    stdn = std[:, None]
    meann = mean[:, None]
    amp_g = got[:, : m + 1] * stdn + meann
    amp_r = ref[:, : m + 1] * stdn + meann
    scale = torch.sqrt((amp_r**2).mean(dim=1, keepdim=True))
    return (amp_g - amp_r).abs() / (amp_r.abs() + scale)


def accuracy(
    got: torch.Tensor, ref: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
    m: int,
) -> tuple[float, float]:
    """(max, 99.9% quantile) of :func:`accuracy_rel` over every bin, the
    quantile interpolated between ranks as numpy's default; within the
    gate where max <= ACC_MAX_REL and quantile <= ACC_Q999_REL. The
    quantile comes from the largest 0.1% (torch.quantile refuses inputs
    of more than 2^24 values)."""
    rel = accuracy_rel(got, ref, mean, std, m).flatten()
    n = rel.numel()
    pos = 0.999 * (n - 1)
    lo = int(pos)
    top = torch.topk(rel, n - lo).values  # descending: ranks n-1 .. lo
    v_lo = float(top[-1])
    v_hi = float(top[-2]) if n - lo > 1 else v_lo
    return float(top[0]), v_lo + (pos - lo) * (v_hi - v_lo)


def dft_untwist_interbin_plain(
    x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor, *, npad: int
) -> torch.Tensor:
    """The plain version: the packed DFT by torch.fft, then untwist,
    interbin, normalise and zero-pad (ops/fft.py)."""
    return untwist_interbin_normalise_plain(packed_dft_z(x), mean, std, npad=npad)


def dft_untwist_interbin(
    x: torch.Tensor,  # (R, n) f32 series; even/odd samples are the planes
    mean: torch.Tensor,  # (R,) f32
    std: torch.Tensor,  # (R,) f32
    *,
    npad: int,  # output width, a multiple of n1 and > n/2
) -> torch.Tensor:
    """(R, npad) f32 normalised interbin spectrum of each real series:
    bins k in [0, n/2], the rest zero. Raises ValueError outside
    :func:`dftspec_supported`. CUDA tensors go through the dftspec kernel
    (within the accuracy gate of the plain version), CPU tensors through
    the plain version."""
    if x.dim() != 2:
        raise ValueError(f"x must be (R, n), got {tuple(x.shape)}")
    rows, n = x.shape
    if n % 2:
        raise ValueError(f"series length must be even, got {n}")
    _geometry(n // 2, npad)
    if on_cpu(x, mean, std):
        return dft_untwist_interbin_plain(x, mean, std, npad=npad)
    check(x, "x", torch.float32, 2)
    check(mean, "mean", torch.float32, 1)
    check(std, "std", torch.float32, 1)
    if mean.shape != (rows,) or std.shape != (rows,):
        raise ValueError("mean and std must be (R,)")
    if x.data_ptr() % 8:
        raise ValueError("x must be 8-byte aligned (read as complex pairs)")
    m = n // 2
    dev = x.device
    unc, uns = untwist_tables(m, dev)
    out = torch.empty((rows, npad), dtype=torch.float32, device=dev)
    kernels.launch(
        "dftspec", x.data_ptr(), unc.data_ptr(), uns.data_ptr(), mean.data_ptr(),
        std.data_ptr(), out.data_ptr(), rows, m, npad, stream_ptr(dev),
        shape=(rows, n, npad),
    )
    return out
