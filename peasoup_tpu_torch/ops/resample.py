"""Time-domain acceleration resampling as an index-map gather.

Reference kernels: resample_kernelII (the search pipeline's version,
out[i] = in[rn(i + i*af*(i-N))], src/kernels.cu:314-346) and the
quadratic resample_kernel (used by the candidate folder,
out[i] = in[rn(i + af*((i-N/2)^2-(N/2)^2))], kernels.cu:308-332), with
af = a*tsamp/(2c) (kernels.cu:354).

The index arithmetic is f32 and exact to the JAX package's: quad =
i*(i-N) is rounded once (i and i-N are exact for N < 2^24), the shift
rint(af*quad) is one more rounding, and the source index is clipped to
[0, N-1] like the reference. :func:`resample_rows` is the search's
resample: the hand-written kernel (csrc/resample.cu) for CUDA tensors,
the plain version :func:`resample_rows_plain` for CPU tensors. Its output
is bitwise that of every route the JAX package takes (its jnp gather,
its gather-free select and its Pallas kernel), whatever the shift span.

:func:`select_span` and :func:`choose_block` are copies of the JAX
package's route tests (ops/resample.py:select_span and
ops/pallas/resample.py:choose_block): the port resamples every span with
one kernel, but the span decides whether the JAX package takes its fused
DFT (ops/dftspec.py), and the search takes it where the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import check, on_cpu, stream_ptr

SPEED_OF_LIGHT = 299792458.0

# sub-blocks per invocation of the JAX package's Pallas resample kernel
_SUPER = 8


def select_span(af_max: float, n: int, limit: int = 64) -> int:
    """The JAX package's shift bound for its gather-free select resample:
    ceil(max|af| * N^2 / 4) plus one guard sample, or 0 when the span
    exceeds ``limit``."""
    smax = int(np.ceil(af_max * (n / 2.0) ** 2)) + 1
    return smax if smax <= limit else 0


def choose_block(af_max: float, n: int) -> int:
    """The JAX package's Pallas resample block: the largest power of two
    in [128, 2048] whose shift spread stays within one sample and whose
    super-block divides N, or 0 when none exists."""
    if af_max < 0:
        raise ValueError("af_max must be >= 0")
    limit = 2.0 / (af_max * n) if af_max > 0 else float("inf")
    blk = 128
    if blk > limit or n % (_SUPER * blk):
        return 0
    while blk * 2 <= min(limit, 2048) and n % (_SUPER * blk * 2) == 0:
        blk *= 2
    return blk


def accel_factor(accs: np.ndarray, tsamp: float) -> np.ndarray:
    """af = (a*tsamp) / (2c): the a*tsamp product is an F32 multiply in
    the reference (``float a, float tsamp``, kernels.cu:348-354), the
    division by 2c is f64."""
    prod = (np.asarray(accs, dtype=np.float32) * np.float32(tsamp)).astype(
        np.float32
    )
    return prod.astype(np.float64) / (2.0 * SPEED_OF_LIGHT)


def resample_rows_plain(
    x: torch.Tensor, row_dm: torch.Tensor, afs: torch.Tensor
) -> torch.Tensor:
    """Resample one series per row.

    Args:
      x: (D, N) float32 time series, one per DM trial.
      row_dm: (R,) int32 DM trial (row of ``x``) of each output row.
      afs: (R,) float32 acceleration factors (a*tsamp/2c).

    Returns (R, N): out[r, i] = x[row_dm[r], clip(i + rint(afs[r]*i*(i-N)))].
    The even and odd samples of a row, the packed DFT's real and
    imaginary planes, are a free view of it (ops/fft.py:packed_dft_z).
    """
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=x.device)
    quad = idx * (idx - float(n))  # exact inputs, one f32 rounding
    shift = torch.round(afs[:, None] * quad).to(torch.int64)  # (R, N)
    src = torch.clamp(torch.arange(n, device=x.device) + shift, 0, n - 1)
    return torch.gather(x[row_dm.to(torch.int64)], 1, src)


def resample_rows(
    x: torch.Tensor, row_dm: torch.Tensor, afs: torch.Tensor
) -> torch.Tensor:
    """:func:`resample_rows_plain`'s function: the resample kernel for
    CUDA tensors (bitwise equal to the plain version), the plain version
    for CPU tensors."""
    if on_cpu(x, row_dm, afs):
        return resample_rows_plain(x, row_dm, afs)
    check(x, "x", torch.float32, 2)
    check(row_dm, "row_dm", torch.int32, 1)
    check(afs, "afs", torch.float32, 1)
    if row_dm.shape != afs.shape:
        raise ValueError("row_dm and afs must both be (R,)")
    d, n = x.shape
    if n >= 1 << 24:
        raise ValueError(f"N = {n}: the f32 index arithmetic needs N < 2^24")
    rows = row_dm.shape[0]
    if rows:
        lo, hi = torch.stack(torch.aminmax(row_dm)).tolist()  # one host sync
        if lo < 0 or hi >= d:
            raise IndexError(f"row_dm must lie in [0, {d})")
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    if rows == 0 or n == 0:
        return out
    kernels.launch(
        "resample", x.data_ptr(), row_dm.data_ptr(), afs.data_ptr(),
        out.data_ptr(), rows, n, stream_ptr(x.device), shape=(rows, d, n),
    )
    return out


def resample_accel_quadratic(x: torch.Tensor, afs: torch.Tensor) -> torch.Tensor:
    """The folder's variant, one row per factor: (N,) series and (K,)
    factors -> (K, N), out[k, i] = x[clip(i + rint(afs[k]*((i-N/2)^2 -
    (N/2)^2)))] (kernels.cu:308-332), in the JAX package's f32 steps."""
    return resample_accel_quadratic_rows(x.expand(afs.shape[0], -1), afs)


def resample_accel_quadratic_rows(x: torch.Tensor, afs: torch.Tensor) -> torch.Tensor:
    """:func:`resample_accel_quadratic` with a series of its own for each
    factor (the survey folder's rows come from different observations and
    DM trials): (B, N) series and (B,) factors -> (B, N)."""
    n = x.shape[-1]
    half = torch.tensor(float(n), dtype=torch.float32, device=x.device) / 2.0
    idx = torch.arange(n, dtype=torch.float32, device=x.device)
    off = idx - half
    quad = off * off - half * half
    shift = torch.round(afs[:, None] * quad).to(torch.int64)  # (B, N)
    src = torch.clamp(torch.arange(n, device=x.device) + shift, 0, n - 1)
    return torch.gather(x, 1, src)
