"""Single-pulse search ops: per-trial normalisation and the boxcar
matched-filter sweep over the dedispersed DM-time plane.

The reference has no single-pulse stage (it searches periodicity only);
this is the JAX package's transient search (peasoup_tpu/ops/singlepulse.py),
in the shape of GPU single-pulse pipelines (Heimdall; GSP,
arXiv:2110.12749): each DM trial's series is baseline and variance
normalised, swept by a bank of octave-spaced boxcars through prefix-sum
differences, and thresholded in S/N.

The boxcar at sample ``t`` with width ``w`` covers ``[t, t + w)``:
``snr_w[t] = (csum[t + w] - csum[t]) * scale[w]`` with ``scale[w] =
1/sqrt(w)`` rounded once to f32, which is the matched-filter S/N of a
top-hat pulse in unit-variance noise. The bank collapses to a per-sample
best-width plane (best S/N and its width index; ties keep the narrowest
width), and the search reads a ``dec``-fold max-decimated view of it:
block max, the first sample reaching it, and the width there.

:func:`boxcar_best` (the sweep alone, which the streaming search runs)
and :func:`boxcar_dec_best` (the sweep and the dec-fold, which the batch
search runs) launch the hand-written kernels csrc/boxcar.cu and
csrc/spchain.cu for CUDA tensors and run their plain versions
:func:`boxcar_best_plain` and :func:`boxcar_dec_best_plain` for CPU
tensors. A dec-fold the spchain kernel does not take (not a power of two
<= 1024) runs the boxcar kernel and :func:`dec_fold`. Both kernels are
bitwise equal to the plain versions given the same prefix sums.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import check, on_cpu, stream_ptr
from .peaks import find_peaks_device
from .spectrum import row_sum

# rows pad to a multiple of _QUANT samples, in tiles of at most _SPAN_MAX
# (the JAX package's Pallas tiling); they fix tpad, and so the shape of
# every output, so the port keeps them
_QUANT = 1024
_SPAN_MAX = 8192

# Std retained by a +-3 sigma clipped Gaussian:
# sqrt(1 - 6*phi(3)/(2*Phi(3)-1)). The clipped passes estimate sigma from
# clipped samples; dividing by the retention unbiases it so reported S/N
# matches the matched-filter expectation on pure noise.
CLIP3_STD_RETENTION = 0.9865835
DEFAULT_N_WIDTHS = 12

# the kernels' limits. Both kernels stream their rows through a ring
# whose geometry csrc/spchain_map.cuh alone decides; an entry refuses a
# bank or a layout that does not fit (kernels.launch raises ValueError).
# The width bank goes to a kernel by value, in a fixed array.
MAX_WIDTHS = 32


def default_widths(n_widths: int = DEFAULT_N_WIDTHS, max_width: int = 0):
    """Octave-spaced boxcar widths 1, 2, 4, ... (samples). ``max_width``
    > 0 additionally caps the largest width."""
    widths = []
    for k in range(max(1, n_widths)):
        w = 1 << k
        if max_width and w > max_width:
            break
        widths.append(w)
    return tuple(widths)


def width_scales(widths) -> np.ndarray:
    """Matched-filter normalisation 1/sqrt(w) per width, rounded once to
    f32 (what both the plain versions and the kernels multiply by)."""
    return (1.0 / np.sqrt(np.asarray(widths, dtype=np.float64))).astype(np.float32)


def plan_pad(nsamps: int) -> tuple[int, int]:
    """(tpad, span): trial rows pad to ``tpad`` samples, a multiple of
    ``span``; both are multiples of 1024."""
    span = _SPAN_MAX if nsamps >= _SPAN_MAX else -(-nsamps // _QUANT) * _QUANT
    tpad = -(-nsamps // span) * span
    return tpad, span


def width_extent(widths) -> int:
    """Slack past ``tpad`` in a prefix-sum row for the widest boxcar,
    rounded up to a multiple of 1024."""
    return -(-(int(max(widths)) + 2) // _QUANT) * _QUANT


def normalise_trials(
    x: torch.Tensor, *, clip_sigma: float = 3.0, n_rounds: int = 2
) -> torch.Tensor:
    """Per-trial baseline and variance normalisation of (D, n) trials:
    moments over the whole trial, then ``n_rounds`` passes over the
    samples within ``clip_sigma`` of the running estimate, so a bright
    pulse does not inflate its own noise estimate. The clipped std is
    unbiased by the Gaussian truncation retention each round. Returns
    (D, n) f32. Sums run in :func:`row_sum`'s fixed order, not XLA's, so
    the result differs from the JAX package's in the last bits, and a
    trial's result does not depend on the trials beside it."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    corr = torch.tensor(
        CLIP3_STD_RETENTION if clip_sigma == 3.0 else 1.0,
        dtype=torch.float32, device=x.device,
    )
    mean = row_sum(x)[..., None] / n
    var = row_sum((x - mean) ** 2)[..., None] / n
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    for _ in range(max(1, n_rounds)):
        keep = torch.abs(x - mean) <= clip_sigma * std
        nkeep = torch.clamp(torch.sum(keep, dim=-1, keepdim=True), min=1)
        mean = row_sum(torch.where(keep, x, 0.0))[..., None] / nkeep
        var = row_sum(torch.where(keep, (x - mean) ** 2, 0.0))[..., None] / nkeep
        std = torch.sqrt(torch.clamp(var, min=1e-12)) / corr
    return (x - mean) / std


def prefix_sum_padded(norm: torch.Tensor, tpad: int, wext: int) -> torch.Tensor:
    """(D, tpad + wext) exclusive prefix-sum rows: csum[d, t] =
    sum(norm[d, :t]) for t <= n, zero past it (f32 ``torch.cumsum``)."""
    d, n = norm.shape
    out = torch.zeros((d, tpad + wext), dtype=torch.float32, device=norm.device)
    out[:, 1 : n + 1] = torch.cumsum(norm, dim=-1, dtype=torch.float32)
    return out


def boxcar_best_plain(
    csum_pad: torch.Tensor,  # (D, tpad + wext) from prefix_sum_padded
    widths: tuple[int, ...],
    scales: np.ndarray,  # f32 from width_scales
    nvalid: int,
    tpad: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain width sweep: (best S/N (D, tpad) f32, best width index
    (D, tpad) i32). A boxcar starting past ``nvalid - w`` is -inf; the
    running max is a strict >, so ties keep the narrowest width."""
    dev = csum_pad.device
    j = torch.arange(tpad, device=dev)
    lo = csum_pad[:, :tpad]
    best = torch.full(lo.shape, -np.inf, dtype=torch.float32, device=dev)
    bw = torch.zeros(lo.shape, dtype=torch.int32, device=dev)
    for k, w in enumerate(widths):
        hi = csum_pad[:, w : w + tpad]
        scale = torch.tensor(scales[k], dtype=torch.float32, device=dev)
        snr = torch.where(j + w <= nvalid, (hi - lo) * scale, -np.inf)
        better = snr > best
        best = torch.where(better, snr, best)
        bw = torch.where(better, k, bw)
    return best, bw


def dec_fold(
    best: torch.Tensor, bw: torch.Tensor, dec: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block max, first in-block argmax and the width index there, over
    ``dec``-sample blocks of a (D, tpad) sweep (plain torch). The block max
    is jnp.max's: IEEE maximum, so a block whose maximum is zero gives +0
    where any of its samples is +0 and -0 where all its zeros are -0 (the
    value at the argmax may carry the other sign)."""
    d, tpad = best.shape
    blocks = best.reshape(d, tpad // dec, dec)
    barg = torch.argmax(blocks, dim=-1)  # the first maximum, as jnp.argmax
    bmax = torch.gather(blocks, -1, barg[..., None])[..., 0]
    pos_zero = ((blocks == 0) & ~torch.signbit(blocks)).any(dim=-1)
    bmax = torch.where(bmax == 0, torch.where(pos_zero, 0.0, -0.0), bmax)
    bwidx = torch.gather(bw.reshape(d, tpad // dec, dec), -1, barg[..., None])[..., 0]
    return bmax, barg.to(torch.int32), bwidx


def boxcar_dec_best_plain(
    csum_pad: torch.Tensor,
    widths: tuple[int, ...],
    scales: np.ndarray,
    nvalid: int,
    tpad: int,
    dec: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`boxcar_dec_best`: the sweep, then the
    dec-fold."""
    best, bw = boxcar_best_plain(csum_pad, widths, scales, nvalid, tpad)
    return dec_fold(best, bw, dec)


def _check_sweep(csum_pad, widths, scales, tpad) -> int:
    """Check a sweep's geometry; returns wext, the row's slack past tpad."""
    d, row = csum_pad.shape
    wext = row - tpad
    if not widths or min(widths) < 1 or wext <= int(max(widths)):
        raise ValueError(
            f"boxcar sweep: row of {row} leaves {wext} samples past tpad={tpad} "
            f"for widths up to {max(widths) if widths else None}"
        )
    if len(scales) != len(widths):
        raise ValueError("one scale per width")
    return wext


def _check_dec(dec: int, tpad: int) -> None:
    if dec < 1 or tpad % dec:
        raise ValueError(f"decimate={dec} must divide the padded trial length {tpad}")


def spchain_takes(dec: int) -> bool:
    """Whether the spchain kernel takes the dec-fold ``dec``: a power of
    two <= 1024. Any other ``dec`` that divides the padded trial length
    goes through the boxcar kernel and :func:`dec_fold` (the JAX package's
    boxcar rung, its pipeline/single_pulse.py:select_sp_kernels)."""
    return 1 <= dec <= _QUANT and not dec & (dec - 1)


def _kernel_bank(csum_pad, widths, scales):
    """The kernels' checks, and the width bank in host memory (widths i32,
    scales f32), which the C entries pass to the kernel by value."""
    check(csum_pad, "csum_pad", torch.float32, 2)
    if len(widths) > MAX_WIDTHS:
        raise ValueError(f"the boxcar kernels take at most {MAX_WIDTHS} widths")
    return np.asarray(widths, dtype=np.int32), np.asarray(scales, dtype=np.float32)


def boxcar_best(
    csum_pad: torch.Tensor,  # (D, tpad + wext) f32 from prefix_sum_padded
    widths: tuple[int, ...],
    scales: np.ndarray,
    nvalid: int,
    tpad: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The width sweep: (best S/N (D, tpad) f32, best width index (D, tpad)
    i32); bitwise equal to :func:`boxcar_best_plain`. CUDA tensors go
    through the boxcar kernel (which needs ``tpad`` a multiple of 512,
    16-byte aligned rows of a multiple of 4 samples, and widths up to ~53k
    samples), CPU tensors through the plain version. On the card the call
    allocates the two outputs and nothing else."""
    wext = _check_sweep(csum_pad, widths, scales, tpad)
    if on_cpu(csum_pad):
        return boxcar_best_plain(csum_pad, widths, scales, nvalid, tpad)
    w_host, s_host = _kernel_bank(csum_pad, widths, scales)
    d = csum_pad.shape[0]
    dev = csum_pad.device
    best = torch.empty((d, tpad), dtype=torch.float32, device=dev)
    bw = torch.empty((d, tpad), dtype=torch.int32, device=dev)
    kernels.launch(
        "boxcar", csum_pad.data_ptr(), w_host.ctypes.data, s_host.ctypes.data,
        len(widths), d, tpad + wext, tpad, nvalid, best.data_ptr(), bw.data_ptr(),
        stream_ptr(dev), shape=(d, tpad, wext, len(widths)),
    )
    return best, bw


def boxcar_dec_best(
    csum_pad: torch.Tensor,  # (D, tpad + wext) f32 from prefix_sum_padded
    widths: tuple[int, ...],
    scales: np.ndarray,
    nvalid: int,
    tpad: int,
    dec: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The width sweep and its dec-fold: (block max S/N (D, tpad/dec) f32,
    first in-block argmax (D, tpad/dec) i32, width index at the argmax
    (D, tpad/dec) i32); bitwise equal to :func:`boxcar_dec_best_plain`.
    ``dec`` divides ``tpad``. For CUDA tensors a ``dec`` that
    :func:`spchain_takes` goes through the spchain kernel, which does both
    in one pass (and needs ``tpad`` a multiple of 512, 16-byte aligned rows
    of a multiple of 4 samples, and widths up to ~53k samples); any other
    through the boxcar kernel (:func:`boxcar_best`) and :func:`dec_fold` in
    torch. The route follows from ``dec`` alone. CPU tensors take the plain
    version."""
    _check_dec(dec, tpad)
    wext = _check_sweep(csum_pad, widths, scales, tpad)
    if on_cpu(csum_pad):
        return boxcar_dec_best_plain(csum_pad, widths, scales, nvalid, tpad, dec)
    if not spchain_takes(dec):
        return dec_fold(*boxcar_best(csum_pad, widths, scales, nvalid, tpad), dec)
    w_host, s_host = _kernel_bank(csum_pad, widths, scales)
    d = csum_pad.shape[0]
    dev = csum_pad.device
    nbd = tpad // dec
    bmax = torch.empty((d, nbd), dtype=torch.float32, device=dev)
    barg = torch.empty((d, nbd), dtype=torch.int32, device=dev)
    bwidx = torch.empty((d, nbd), dtype=torch.int32, device=dev)
    kernels.launch(
        "spchain", csum_pad.data_ptr(), w_host.ctypes.data, s_host.ctypes.data,
        len(widths), d, tpad + wext, tpad, nvalid, dec, bmax.data_ptr(),
        barg.data_ptr(), bwidx.data_ptr(), stream_ptr(dev),
        shape=(d, tpad, wext, len(widths), dec),
    )
    return bmax, barg, bwidx


def single_pulse_search_block(
    trials: torch.Tensor,  # (D, nsamps) u8 or f32 dedispersed trials
    widths: tuple[int, ...],
    threshold: float,
    max_events: int,
    dec: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block of DM trials to per-trial single-pulse events: normalise,
    sweep and dec-fold (:func:`boxcar_dec_best`), then compact the block
    maxima above ``threshold``. Returns (samples (D, K) i32, width_idx
    (D, K) i32, snrs (D, K) f32, counts (D,) i32) with K = max_events:
    the first K events of each trial in ascending time, padded with
    sample -1, width 0 and S/N 0; ``counts`` may exceed K (overflow).
    An event's sample is exact: its block's start plus the in-block
    argmax."""
    n = trials.shape[-1]
    tpad, _ = plan_pad(n)
    _check_dec(dec, tpad)
    wext = width_extent(widths)
    csum = prefix_sum_padded(normalise_trials(trials), tpad, wext)
    bmax, barg, bwidx = boxcar_dec_best(
        csum, widths, width_scales(widths), n, tpad, dec
    )
    del csum
    nbd = tpad // dec
    d = bmax.shape[0]
    dev = bmax.device
    lo = torch.zeros(d, dtype=torch.int64, device=dev)
    pidx, psnr, pcount = find_peaks_device(bmax, threshold, lo, lo + nbd)
    k = pidx.shape[1]
    if k < max_events:
        pidx = torch.nn.functional.pad(pidx, (0, max_events - k), value=nbd)
        psnr = torch.nn.functional.pad(psnr, (0, max_events - k))
    pidx, psnr = pidx[:, :max_events], psnr[:, :max_events]
    valid = pidx < nbd
    safe = torch.clamp(pidx, max=nbd - 1)
    samples = safe * dec + torch.gather(barg, 1, safe)
    widx = torch.gather(bwidx, 1, safe)
    samples = torch.where(valid, samples, -1).to(torch.int32)
    widx = torch.where(valid, widx, 0).to(torch.int32)
    return samples, widx, psnr, pcount.to(torch.int32)


def matched_filter_snr(amplitude: float, width: int, sigma: float) -> float:
    """Analytic boxcar matched-filter S/N of a top-hat pulse of
    per-sample ``amplitude`` and ``width`` samples in noise of std
    ``sigma``: amplitude * sqrt(width) / sigma."""
    return float(amplitude) * float(np.sqrt(width)) / float(sigma)
