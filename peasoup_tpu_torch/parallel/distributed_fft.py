"""Distributed FFT over a mesh axis (a series split over devices): the JAX
package's parallel/distributed_fft.py over an in-process mesh.

The reference never splits a time series: each GPU holds the whole
series (up to 2^23 samples). Past one device's memory, a four-step
(Bailey) decomposition of the DFT splits the series over the devices of
a 'seq' axis:

  x viewed as (N1, N2), n = n1*N2 + n2, split by columns n2:
    1. local FFT over n1 (each shard holds all rows of its columns)
    2. local twiddle multiply exp(-2*pi*i * n2 * k1 / N)
    3. transpose: shard j receives every shard's k1 rows of block j
    4. local FFT over n2
  giving X[k2*N1 + k1] laid out as rows k1 (split), columns k2.

In the JAX package step 3 is one all-to-all over the chips' links; here
it is copies between the shards' devices. A real input packs even and odd
samples into a complex series of half the length, re-splits the shuffled
output into natural frequency order with a second transpose, and
untangles the conjugate-symmetric halves with the mirrored blocks and the
one-element seam (two permutations between shards).

:func:`fft_sharded` and :func:`rfft_sharded` take and return per-shard
lists; :func:`distributed_fft` and :func:`distributed_rfft` split a whole
tensor and gather the result on its device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .mesh import Mesh


def _all_to_all(blocks: list[torch.Tensor], devs, split: int, concat: int) -> list:
    """Shard j's output: piece j (of ``len(devs)`` along ``split``) of every
    shard's block, in shard order, concatenated along ``concat`` on
    device j (the JAX package's tiled all_to_all)."""
    p = len(devs)
    pieces = [torch.chunk(b, p, dim=split) for b in blocks]
    return [torch.cat([pieces[i][j].to(devs[j]) for i in range(p)], dim=concat)
            for j in range(p)]


def _fft_local_steps(cols: list[torch.Tensor], n1: int, n2: int, devs) -> list:
    """Steps 1-4 on every shard's (n1, n2/P) column block -> its row block
    (n1/P, n2) of X[k2*n1 + k1]."""
    p = len(devs)
    width = n2 // p
    out = []
    for me, x in enumerate(cols):
        w = torch.fft.fft(x, dim=0)  # rows now k1
        k1 = torch.arange(n1, device=x.device, dtype=torch.float64)[:, None]
        n2g = (me * width + torch.arange(width, device=x.device, dtype=torch.float64))[None, :]
        tw = torch.exp((-2j * math.pi / (n1 * n2)) * (k1 * n2g))
        out.append(w * tw.to(w.dtype))
    out = _all_to_all(out, devs, split=0, concat=1)
    return [torch.fft.fft(w, dim=1) for w in out]  # (n1/p, n2): rows k1, cols k2


def fft_sharded(cols: list[torch.Tensor], n: int, devs) -> list[torch.Tensor]:
    """C2C DFT of a length-``n`` series split over ``devs``: ``cols[j]`` is
    shard j's (n1, n2/P) column block of x viewed as (n1, n2) row-major
    with n1 = P. Returns each shard's (1, n2) row block of X arranged
    [k1, k2], flat index k = k2*n1 + k1 (unshuffle_fft_order gives natural
    order)."""
    n1 = cols[0].shape[0]
    return _fft_local_steps(cols, n1, n // n1, devs)


def unshuffle_fft_order(x_rows: np.ndarray) -> np.ndarray:
    """Host helper: gathered (n1, n2) [k1, k2] layout -> natural X[k]
    (k = k2*n1 + k1, so natural order is the column-major flatten)."""
    return np.asarray(x_rows).T.reshape(-1)


def distributed_fft(x: torch.Tensor, mesh: Mesh, axis: str = "seq") -> torch.Tensor:
    """C2C FFT of a 1-D complex tensor over a mesh axis. The series is laid
    out (n1=P, n2) row-major and split by columns; returns the (n1, n2)
    [k1, k2] matrix (flat index k = k2*n1 + k1) on x's device."""
    devs = mesh.axis_devices(axis)
    p = len(devs)
    n = x.shape[-1]
    if n % (p * p):
        raise ValueError(f"n={n} must be divisible by P^2={p * p}")
    x2 = x.reshape(p, n // p).to(torch.complex64)
    cols = [c.to(d) for c, d in zip(torch.chunk(x2, p, dim=1), devs)]
    return torch.cat([r.to(x.device) for r in fft_sharded(cols, n, devs)])


def rfft_sharded(z_cols: list[torch.Tensor], n: int, devs) -> list[torch.Tensor]:
    """R2C DFT by the even/odd packing trick: ``z_cols[j]`` is shard j's
    (n1, m2/P) column block of z[j] = x[2j] + i*x[2j+1] viewed as (n1, m2),
    m = n/2 = n1*m2; ``n`` is the real series' length. Returns each shard's
    (m/P,) block of the half-spectrum X[0:m] in natural order."""
    p = len(devs)
    n1 = z_cols[0].shape[0]
    m = n // 2
    m2 = m // n1
    zf = _fft_local_steps(z_cols, n1, m2, devs)  # (n1/p, m2) [k1, k2]
    # re-split into contiguous blocks of Z: shard j gets every k1 of its
    # k2 chunk, then a local transpose is natural order
    za = _all_to_all(zf, devs, split=1, concat=0)  # (n1, m2/p)
    z_nat = [a.T.reshape(-1) for a in za]
    length = m // p
    out = []
    for me in range(p):
        dev = devs[me]
        # mirrors Z[(m-k) mod m] of this shard's k block: the whole tail of
        # shard p-1-me's block, and the seam Z[((p-me) % p) * L]
        mirror = z_nat[p - 1 - me].to(dev)
        first = z_nat[(p - me) % p][:1].to(dev)
        zmc = torch.conj(torch.cat([first, torch.flip(mirror, dims=[0])[: length - 1]]))
        z = z_nat[me]
        k = (me * length + torch.arange(length, device=dev, dtype=torch.float64))
        wk = torch.exp((-2j * math.pi / n) * k).to(z.dtype)
        out.append(0.5 * (z + zmc) + wk * (-0.5j * (z - zmc)))
    return out


def distributed_rfft(x: torch.Tensor, mesh: Mesh, axis: str = "seq") -> torch.Tensor:
    """First n/2 bins of rfft(x) for real x, on x's device (the Nyquist
    bin is dropped; the search never uses it on its own)."""
    devs = mesh.axis_devices(axis)
    p = len(devs)
    n = x.shape[-1]
    m = n // 2
    if n % 2 or m % (p * p):
        raise ValueError(f"n={n}: n/2 must be divisible by P^2={p * p}")
    z = torch.complex(x[0::2].to(torch.float32), x[1::2].to(torch.float32))
    z2 = z.reshape(p, m // p)
    cols = [c.to(d) for c, d in zip(torch.chunk(z2, p, dim=1), devs)]
    return torch.cat([r.to(x.device) for r in rfft_sharded(cols, n, devs)])
