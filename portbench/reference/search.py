"""The spectrum of any (DM, acceleration) trial, plain torch, as peasoup
defines the search (the reference pipeline's Worker loop):

- dedispersion: each DM trial the sum over the kept channels of the samples
  shifted by their delays, scaled into u8 (round half to even, clipped);
- once per DM trial: the first ``size`` samples (the tail padded with the
  mean where the trial is shorter), the real FFT, the amplitude, its
  three-scale running median (medians of 5, 25 and 125 bins stretched
  linearly), the spectrum divided by it with bins 0-4 zeroed, the
  birdies set to 1 + 0j, the interbinned amplitude's mean and standard
  deviation, and the inverse FFT: the whitened series;
- per acceleration: the series resampled by the index map
  i + rint(af * i * (i - N)) (clipped), the real FFT, the interbinned
  amplitude max(|X_k|^2, |X_k - X_{k-1}|^2 / 2)^(1/2), normalised by the
  DM trial's mean and deviation, and the harmonic sums: level h adds the
  bins (i k + 2^(h-1)) >> h for odd k < 2^h to level h - 1, scaled by
  2^(-h/2);
- peaks: the bins of a level inside its window above the threshold,
  clustered by peasoup's walk (a new cluster where a crossing lies at
  least 30 bins past the current maximum), one peak a cluster.

``dtype`` is the precision the values are stored in between the steps:
float32 for the reference, bfloat16 for the control (the FFTs run in
float32 on values rounded to it, and their outputs are rounded again).
"""

from __future__ import annotations

import numpy as np
import torch

MIN_GAP = 30


class Rounding:
    """Stores values at ``dtype`` between the steps."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32 or not x.is_floating_point():
            return x
        return x.to(self.dtype).to(torch.float32)


def channel_major(samples: np.ndarray, header: dict, device) -> torch.Tensor:
    """The observation as (nchans, nsamps) u8 on ``device``, from its bytes
    (packed LSB first, channel fastest, below 8 bits)."""
    nchans, nsamps, nbits = int(header["nchans"]), int(header["nsamps"]), int(header["nbits"])
    raw = torch.from_numpy(np.ascontiguousarray(samples).reshape(-1)).to(device)
    if nbits < 8:
        per = 8 // nbits
        parts = [(raw >> (nbits * k)) & ((1 << nbits) - 1) for k in range(per)]
        raw = torch.stack(parts, dim=1).reshape(-1)
    return raw.reshape(nsamps, nchans).t().contiguous()


def dedisperse(xc: torch.Tensor, delays: np.ndarray, out_nsamps: int, scale: float,
               chans=None) -> torch.Tensor:
    """(D, out_nsamps) u8 trials of the (C, T) u8 channels at ``delays``
    (D, C), summed over ``chans`` (every channel where None): exact
    integer sums in f32, then the scale, rounding and clip."""
    d = torch.from_numpy(np.ascontiguousarray(delays)).to(xc.device)
    acc = torch.zeros((delays.shape[0], out_nsamps), dtype=torch.float32, device=xc.device)
    for c in (range(xc.shape[0]) if chans is None else np.asarray(chans).tolist()):
        acc += xc[c].unfold(0, out_nsamps, 1).index_select(0, d[:, c])
    if scale != 1.0:
        acc = acc * torch.tensor(scale, dtype=torch.float32, device=acc.device)
    return torch.clamp(torch.round(acc), 0, 255).to(torch.uint8)


def _median5(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n >= 5:
        m = n // 5
        return torch.sort(x[..., : 5 * m].reshape(*x.shape[:-1], m, 5), dim=-1).values[..., 2]
    s = torch.sort(x, dim=-1).values
    if n in (1, 3):
        return s[..., n // 2 : n // 2 + 1]
    return 0.5 * (s[..., n // 2 - 1 : n // 2] + s[..., n // 2 : n // 2 + 1])


def _stretch(x: torch.Tensor, n: int) -> torch.Tensor:
    """Linear interpolation of ``x`` onto ``n`` points, in f32 steps;
    fractions below 1e-5 take the left sample."""
    m = x.shape[-1]
    step = torch.tensor(m - 1, dtype=torch.float32) / torch.tensor(n - 1, dtype=torch.float32)
    pos = torch.arange(n, dtype=torch.float32, device=x.device) * step.to(x.device)
    j = pos.to(torch.int64)
    frac = pos - j.to(torch.float32)
    left, right = x[..., j], x[..., torch.clamp(j + 1, max=m - 1)]
    return torch.where(frac > 1e-5, left + frac * (right - left), left)


def running_median(amp: torch.Tensor, pos5: int, pos25: int) -> torch.Tensor:
    n = amp.shape[-1]
    m5 = _median5(amp)
    m25 = _median5(m5)
    m125 = _median5(m25)
    i = torch.arange(n, device=amp.device)
    return torch.where(i < pos5, _stretch(m5, n),
                       torch.where(i < pos25, _stretch(m25, n), _stretch(m125, n)))


def interbin(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """max(|X_k|^2, |X_k - X_{k-1}|^2 / 2)^(1/2), X_{-1} = 0."""
    dr = re - torch.nn.functional.pad(re[..., :-1], (1, 0))
    di = im - torch.nn.functional.pad(im[..., :-1], (1, 0))
    return torch.sqrt(torch.maximum(re * re + im * im, 0.5 * (dr * dr + di * di)))


def whiten(trials: torch.Tensor, plan, rnd: Rounding):
    """(D, size) whitened series and each trial's spectrum (mean, std)."""
    size = plan.size
    valid = min(plan.out_nsamps, size)
    x = trials[:, :valid].to(torch.float32)
    if valid < size:
        mean = x.to(torch.float64).sum(dim=1, keepdim=True) / valid
        x = torch.cat([x, mean.to(torch.float32).expand(-1, size - valid)], dim=1)
    spec = torch.fft.rfft(x, dim=-1)
    re, im = rnd(spec.real.contiguous()), rnd(spec.imag.contiguous())
    med = rnd(running_median(rnd(torch.sqrt(re * re + im * im)), plan.pos5, plan.pos25))
    low = torch.arange(re.shape[-1], device=re.device) < 5
    zap = torch.from_numpy(plan.zapmask).to(re.device)
    re = torch.where(zap, 1.0, torch.where(low, 0.0, re / med))
    im = torch.where(zap, 0.0, torch.where(low, 0.0, im / med))
    re, im = rnd(re), rnd(im)
    s0 = interbin(re, im).to(torch.float64)
    n = s0.shape[-1]
    mean = s0.sum(dim=1) / n
    std = torch.sqrt((s0 * s0).sum(dim=1) / n - mean * mean)
    xd = torch.fft.irfft(torch.complex(re, im), n=size, dim=-1)
    return rnd(xd), rnd(mean.to(torch.float32)), rnd(std.to(torch.float32))


def levels(xd: torch.Tensor, af: float, mean, std, nharms: int, rnd: Rounding) -> torch.Tensor:
    """(nharms + 1, nbins) normalised spectrum and scaled harmonic sums of
    one whitened series resampled by ``af``."""
    n = xd.shape[-1]
    i = torch.arange(n, dtype=torch.float32, device=xd.device)
    shift = torch.round(torch.tensor(af, dtype=torch.float32, device=xd.device) * (i * (i - float(n))))
    src = torch.clamp(torch.arange(n, device=xd.device) + shift.to(torch.int64), 0, n - 1)
    spec = torch.fft.rfft(xd[src])
    p = rnd((interbin(rnd(spec.real), rnd(spec.imag)) - mean) / std)
    out = [p]
    k = torch.arange(p.shape[-1], dtype=torch.int64, device=p.device)
    val = p
    for h in range(1, nharms + 1):
        half = 1 << (h - 1)
        for odd in range(1, 1 << h, 2):
            val = rnd(val + p[(k * odd + half) >> h])
        out.append(rnd(val * torch.tensor(2.0 ** (-h / 2.0), dtype=torch.float32,
                                          device=p.device)))
    return torch.stack(out)


def clusters(row: np.ndarray, crossings: np.ndarray):
    """peasoup's walk over a level's ascending threshold ``crossings``:
    (each cluster's peak bin, its value, the cluster each crossing
    belongs to). A crossing at least MIN_GAP bins past the current
    cluster's maximum starts a new cluster."""
    peaks_i, peaks_v = [], []
    owner = np.empty(len(crossings), dtype=np.int64)
    cur, cur_i = None, 0
    for j, b in enumerate(crossings.tolist()):
        v = float(row[b])
        if cur is not None and b - cur_i >= MIN_GAP:
            peaks_i.append(cur_i)
            peaks_v.append(cur)
            cur = None
        if cur is None or v > cur:
            cur, cur_i = v, b
        owner[j] = len(peaks_i)
    if cur is not None:
        peaks_i.append(cur_i)
        peaks_v.append(cur)
    return np.asarray(peaks_i, dtype=np.int64), np.asarray(peaks_v), owner
