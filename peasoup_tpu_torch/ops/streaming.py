"""The streaming single-pulse search's chunk step: the JAX package's
ops/streaming.py in torch.

The batch search (ops/singlepulse.py) sees a whole observation at once;
the streaming driver (peasoup_tpu_torch/stream/) sees an endless
dedispersed stream in fixed-length chunks. One step of the stream:

* joins the carried tail (the previous chunk's last ``hold`` dedispersed
  samples) and the new chunk into a fixed ``hold + chunk_len`` window, so
  a pulse across a chunk boundary is searched with its full context, as in
  the batch search;
* normalises the window with the batch search's sigma-clipped moments,
  over the window's valid samples only (the first chunk has no tail yet,
  the last ends early), in :func:`ops.spectrum.row_sum`'s fixed order;
* sweeps the boxcar bank (the boxcar kernel, csrc/boxcar.cu, on the card:
  :func:`ops.singlepulse.boxcar_best`), folds it by ``dec`` and keeps the
  first ``max_events`` block maxima of each trial above threshold inside
  a ``[emit_lo, emit_hi)`` block range, so each absolute sample is emitted
  by exactly one chunk (an event whose right context has not streamed in
  yet is left to the next chunk's window).

Geometry (checked when the step is built): ``hold`` and ``chunk_len`` are
multiples of ``dec`` and ``hold >= max(widths)``. The chunk windows then
tile the absolute sample axis on ``dec``-block boundaries, so the
dec-fold maxima, and the events, line up with a batch run over the same
samples.
"""

from __future__ import annotations

import numpy as np
import torch

from .peaks import find_peaks_device
from .singlepulse import (
    CLIP3_STD_RETENTION, boxcar_best, dec_fold, plan_pad, prefix_sum_padded,
    width_extent, width_scales,
)
from .spectrum import row_sum


def stream_geometry(widths: tuple[int, ...], chunk_len: int, dec: int, hold: int = 0) -> int:
    """The carried tail's length ``hold`` for a width bank, checked: at
    least the widest boxcar (the full right context of every deferred
    event), rounded up to the decimation; an explicit ``hold`` is held to
    the same constraints."""
    wmax = int(max(widths))
    if hold <= 0:
        hold = -(-max(wmax, dec) // dec) * dec
    if hold % dec or chunk_len % dec:
        raise ValueError(
            f"hold={hold} and chunk_len={chunk_len} must be multiples of "
            f"decimate={dec} (chunk windows must tile the absolute dec-block grid)"
        )
    if hold < wmax:
        raise ValueError(
            f"hold={hold} is narrower than the widest boxcar ({wmax}): "
            "boundary-spanning pulses would lose right context"
        )
    if chunk_len < hold:
        raise ValueError(
            f"chunk_len={chunk_len} must be >= hold={hold} (the emit region of "
            "a steady chunk must cover its deferred zone)"
        )
    return hold


def normalise_window(
    x: torch.Tensor,  # (D, W) window
    valid: torch.Tensor,  # (W,) bool validity mask
    *,
    clip_sigma: float = 3.0,
    n_rounds: int = 2,
) -> torch.Tensor:
    """The batch normalisation (ops/singlepulse.py:normalise_trials) over
    the ``valid`` samples only, zero outside them, so the prefix sums see
    the zero padding the batch search has past the end of a trial. The
    masked sums run in :func:`row_sum`'s fixed order, not XLA's, so the
    result differs from the JAX package's in the last bits."""
    x = x.to(torch.float32)
    vm = valid.to(torch.float32)[None, :]
    corr = torch.tensor(
        CLIP3_STD_RETENTION if clip_sigma == 3.0 else 1.0,
        dtype=torch.float32, device=x.device,
    )
    nv = torch.clamp(row_sum(vm), min=1.0)[:, None]
    mean = row_sum(x * vm)[:, None] / nv
    var = row_sum(vm * (x - mean) ** 2)[:, None] / nv
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    for _ in range(max(1, n_rounds)):
        keep = (torch.abs(x - mean) <= clip_sigma * std) * vm
        nkeep = torch.clamp(row_sum(keep), min=1.0)[:, None]
        mean = row_sum(keep * x)[:, None] / nkeep
        var = row_sum(keep * (x - mean) ** 2)[:, None] / nkeep
        std = torch.sqrt(torch.clamp(var, min=1e-12)) / corr
    return (x - mean) / std * vm


def make_stream_chunk_fn(
    widths: tuple[int, ...],
    threshold: float,
    max_events: int,
    dec: int,
    hold: int,
    chunk_len: int,
):
    """One streaming step, its geometry checked here. Returns
    ``fn(tail, new, valid_lo, nvalid, emit_lo, emit_hi)`` with

    * ``tail`` (D, hold): the previous chunk's last ``hold`` dedispersed
      samples (zeros before the first chunk),
    * ``new`` (D, chunk_len): the chunk just dedispersed,
    * ``valid_lo``, ``nvalid`` (int): the window's real samples [valid_lo,
      nvalid) (first chunk [hold, W), steady [0, W), last [0, what
      streamed in)),
    * ``emit_lo``, ``emit_hi`` (int): the dec blocks to emit (steady [0,
      chunk_len/dec); the last chunk's flush runs to W/dec),

    giving ``(samples (D, K) i32 in window coordinates, width_idx (D, K)
    i32, snrs (D, K) f32, counts (D,) i32)`` with K = ``max_events``, the
    batch search's record layout, padded with sample -1."""
    hold = stream_geometry(widths, chunk_len, dec, hold)
    w = hold + chunk_len
    tpad, _ = plan_pad(w)
    if tpad % dec:
        raise ValueError(f"decimate={dec} must divide the padded window length {tpad}")
    wext = width_extent(widths)
    scales = width_scales(widths)
    thr = float(np.float32(threshold))

    def run(tail, new, valid_lo: int, nvalid: int, emit_lo: int, emit_hi: int):
        d = tail.shape[0]
        dev = tail.device
        window = torch.cat([tail.to(torch.float32), new.to(torch.float32)], dim=-1)
        j = torch.arange(w, device=dev)
        norm = normalise_window(window, (j >= valid_lo) & (j < nvalid))
        del window
        csum = prefix_sum_padded(norm, tpad, wext)
        del norm
        bmax, barg, bwidx = dec_fold(*boxcar_best(csum, widths, scales, nvalid, tpad), dec)
        del csum
        nbd = tpad // dec
        lo = torch.full((d,), emit_lo, dtype=torch.int64, device=dev)
        hi = torch.full((d,), emit_hi, dtype=torch.int64, device=dev)
        pidx, psnr, pcount = find_peaks_device(bmax, thr, lo, hi, max_peaks=max_events)
        valid = pidx < nbd
        safe = torch.clamp(pidx, max=nbd - 1)
        samples = safe * dec + torch.gather(barg, 1, safe)
        widx = torch.gather(bwidx, 1, safe)
        return (
            torch.where(valid, samples, -1).to(torch.int32),
            torch.where(valid, widx, 0).to(torch.int32),
            psnr,
            pcount.to(torch.int32),
        )

    return run
