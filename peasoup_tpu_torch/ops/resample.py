"""Time-domain acceleration resampling as an index-map gather.

Reference kernel: resample_kernelII (the search pipeline's version,
out[i] = in[rn(i + i*af*(i-N))], src/kernels.cu:314-346) with
af = a*tsamp/(2c) (kernels.cu:354).

The index arithmetic is f32 and exact to the JAX package's: quad =
i*(i-N) is rounded once (i and i-N are exact for N < 2^24), the shift
rint(af*quad) is one more rounding, and the source index is clipped to
[0, N-1] like the reference. The JAX package's gather-free select
(ops/resample.py:resample_select*) produces the same values for spans up
to ``select_span``; its Pallas resample kernel serves wider spans and is
not ported yet, so the search refuses those spans on the card.
"""

from __future__ import annotations

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0

# the widest shift span the search accepts on the card: past it the
# JAX package switches to its Pallas resample kernel (search.py:861)
MAX_SELECT_SPAN = 8


def accel_factor(accs: np.ndarray, tsamp: float) -> np.ndarray:
    """af = (a*tsamp) / (2c): the a*tsamp product is an F32 multiply in
    the reference (``float a, float tsamp``, kernels.cu:348-354), the
    division by 2c is f64."""
    prod = (np.asarray(accs, dtype=np.float32) * np.float32(tsamp)).astype(
        np.float32
    )
    return prod.astype(np.float64) / (2.0 * SPEED_OF_LIGHT)


def select_span(af_max: float, n: int, limit: int = 64) -> int:
    """Static shift bound: ceil of max|af|*N^2/4 plus one guard sample,
    or 0 when the span exceeds ``limit``."""
    smax = int(np.ceil(af_max * (n / 2.0) ** 2)) + 1
    return smax if smax <= limit else 0


def resample_accel(x: torch.Tensor, afs: torch.Tensor) -> torch.Tensor:
    """Resample each time series for each of its acceleration factors.

    Args:
      x: (D, N) float32 time series.
      afs: (D, A) float32 acceleration factors (a*tsamp/2c).

    Returns (D, A, N): out[d, a, i] = x[d, clip(i + rint(afs[d, a]*i*(i-N)))].
    The even and odd samples of a row, the packed DFT's real and
    imaginary planes, are a free view of it (ops/fft.py:packed_dft_z).
    """
    n = x.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=x.device)
    quad = idx * (idx - float(n))  # exact inputs, one f32 rounding
    shift = torch.round(afs[..., None] * quad).to(torch.int64)  # (D, A, N)
    src = torch.clamp(torch.arange(n, device=x.device) + shift, 0, n - 1)
    d, a = afs.shape
    return torch.gather(x[:, None, :].expand(d, a, n), 2, src)
