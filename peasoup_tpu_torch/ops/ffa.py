"""Fast Folding Algorithm (FFA) periodicity search: the JAX package's
ops/ffa.py in torch.

The reference ships the CLI spec of an FFA pipeline
(include/utils/cmdline.hpp:35-50,211-292: p_start/p_end/min_dc over a DM
grid) but not its implementation (``ffa_pipeline.cu`` is absent from its
tree); the JAX package implements it, and this is that implementation:

* The radix-2 FFA butterfly as fixed-shape batched gathers and adds: a
  series is folded at every integer base period p0 in [128, 256) bins at
  once, as (log2 m) stages over (P, m_pad, 256) profiles. Longer periods
  are reached octave by octave, halving the time resolution each octave
  (the FFA staircase), so every octave has the same shapes.
* Circular phase shifts are modulo-p0 gathers on a 256-wide padded
  profile axis.
* Significance is a circular boxcar matched filter over octave-spaced
  duty cycles >= min_dc, (boxcar_sum - w*mean) / (sigma*sqrt(w)) with
  mean and sigma the folded profile's own moments.

Folding at base period p0 over m_pad rows (a power of two; the series
fills m of them), row j of the transform is the fold at period
p0 + j / (m_pad - 1) samples.

The transform's adds are the JAX package's, in its order, so
:func:`ffa_transform` is bitwise the JAX function's. The matched filter's
sums and prefix sums run in torch's order, not XLA's, so its S/N differs
from the JAX package's in the last bits. The search's preparation (mean
removal, downsampling, candidate extraction and collapse) is the JAX
package's numpy code, its row-to-period map included, which is off where
the series fills fewer than m_pad rows (see :func:`_extract_octave`).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

_PMIN = 128  # base-period bucket: every octave folds p0 in [128, 256)
_PMAX = 256


def _fold_rows(x: torch.Tensor, p0: torch.Tensor, m_pad: int) -> torch.Tensor:
    """(..., N) -> (..., P, m_pad, PMAX): row i of period p0 is
    x[i*p0 : i*p0 + p0], zero past p0 columns and past the series' end."""
    n = x.shape[-1]
    dev = x.device
    i = torch.arange(m_pad, device=dev)[None, :, None]
    j = torch.arange(_PMAX, device=dev)[None, None, :]
    p = p0.to(dev)[:, None, None]
    src = i * p + j
    valid = (j < p) & (src < n)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    return torch.where(valid, x[..., src.clamp(0, n - 1)], zero)


def _shift_rows(prof: torch.Tensor, shift: torch.Tensor, p0: torch.Tensor) -> torch.Tensor:
    """Delay each (..., P, m_pad, PMAX) profile row r circularly by
    shift[r] bins within its true period p0 (the pad stays put)."""
    j = torch.arange(_PMAX, device=prof.device)[None, None, :]
    p = p0.to(prof.device)[:, None, None]
    src = torch.where(j < p, (j + shift[None, :, None]) % p, j)
    return torch.gather(prof, -1, src.expand(prof.shape))


def _as_periods(p0) -> tuple[torch.Tensor, bool]:
    p = torch.as_tensor(p0, dtype=torch.int64)
    return p.reshape(-1), p.dim() == 0


def ffa_transform(x: torch.Tensor, p0, m_pad: int) -> torch.Tensor:
    """Radix-2 FFA of ``x`` (..., N) at base period(s) ``p0`` (an int, or
    (P,) ints). Returns (..., m_pad, PMAX) profiles for one p0, else
    (..., P, m_pad, PMAX): row j is the fold at period p0 + j/(m_pad-1)
    samples (input rows past the series' end are zero)."""
    p, scalar = _as_periods(p0)
    stages = int(np.log2(m_pad))
    assert 1 << stages == m_pad, "m_pad must be a power of two"
    prof = _fold_rows(x, p, m_pad)
    i = torch.arange(m_pad, device=x.device)
    for s in range(stages):
        blk = 1 << (s + 1)  # rows per merge group after this stage
        half = blk >> 1
        j = i % blk  # target drift within the group
        a = (i // blk) * blk + (j >> 1)  # top half row: drift floor(j/2)
        shift = (j + 1) >> 1  # the bottom half is delayed ceil(j/2)
        top = prof[..., a, :]
        bot = _shift_rows(prof[..., a + half, :], shift, p)
        prof = top + bot
    return prof[..., 0, :, :] if scalar else prof


def boxcar_snr(
    prof: torch.Tensor,  # (..., PMAX) folded profiles
    p0,  # true period (bins): an int, or ints broadcasting to prof.shape[:-1]
    widths: tuple[int, ...],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Circular boxcar matched filter: for each width w, (sum_w - w*mean) /
    (sigma*sqrt(w)) maximised over the start phase, with mean and sigma
    from the profile itself (the pad excluded); windows wrap modulo the
    true period p0. Returns (best snr, best width, best phase)."""
    dev = prof.device
    p = torch.as_tensor(p0, dtype=torch.int64, device=dev)
    p = p.expand(prof.shape[:-1])[..., None]  # (..., 1)
    j = torch.arange(_PMAX, device=dev)
    inmask = j < p
    p0f = p.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mean = torch.sum(torch.where(inmask, prof, zero), dim=-1, keepdim=True) / p0f
    var = torch.sum(torch.where(inmask, (prof - mean) ** 2, zero), dim=-1,
                    keepdim=True) / p0f
    sigma = torch.sqrt(torch.clamp(var, min=1e-20))
    # prefix sums over one period; a window crossing the period's end is
    # (total - head) + tail, never a read through the pad
    csum = torch.nn.functional.pad(
        torch.cumsum(torch.where(inmask, prof - mean, zero), dim=-1), (1, 0)
    )  # (..., PMAX + 1)
    total = torch.gather(csum, -1, p)

    best_snr = torch.full(prof.shape[:-1], -torch.inf, dtype=torch.float32, device=dev)
    best_w = torch.zeros(prof.shape[:-1], dtype=torch.int32, device=dev)
    best_ph = torch.zeros(prof.shape[:-1], dtype=torch.int32, device=dev)
    head = csum[..., :_PMAX]
    ninf = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    for w in widths:
        end = j + w
        nowrap = csum[..., torch.clamp(end, max=_PMAX)] - head
        tail = torch.gather(csum, -1, torch.clamp(end - p, 0, _PMAX))
        sums = torch.where(end <= p, nowrap, (total - head) + tail)
        valid = (j < p) & (w < p)
        snr_w = torch.where(valid, sums / (sigma * np.float32(np.sqrt(w))), ninf)
        s_w, ph = torch.max(snr_w, dim=-1)
        better = s_w > best_snr
        best_snr = torch.where(better, s_w, best_snr)
        best_w = torch.where(better, torch.full_like(best_w, w), best_w)
        best_ph = torch.where(better, ph.to(torch.int32), best_ph)
    return best_snr, best_w, best_ph


def duty_cycle_widths(min_dc: float, pmax: int = _PMAX) -> tuple[int, ...]:
    """Octave-spaced boxcar widths from min_dc * pmax up to half the
    period (the reference's --min_dc, cmdline.hpp:276-278)."""
    w = max(1, int(round(min_dc * pmax)))
    out = []
    while w <= pmax // 2:
        out.append(w)
        w *= 2
    return tuple(out) or (1,)


class FFAOctaveResult(NamedTuple):
    snr: torch.Tensor  # (D, P, m_pad) best boxcar S/N per (trial, p0, row)
    width: torch.Tensor  # (D, P, m_pad) i32 best boxcar width (bins)
    phase: torch.Tensor  # (D, P, m_pad) i32 best boxcar start phase (bins)


def ffa_octave(x: torch.Tensor, m_pad: int, widths: tuple[int, ...]) -> FFAOctaveResult:
    """One octave of the staircase for a block of DM trials: every base
    period p0 in [PMIN, PMAX) folded and filtered at once. x (D, N) f32."""
    p0s = torch.arange(_PMIN, _PMAX, dtype=torch.int64, device=x.device)
    prof = ffa_transform(x, p0s, m_pad)  # (D, P, m_pad, PMAX)
    snr, w, ph = boxcar_snr(prof, p0s[:, None], widths)
    return FFAOctaveResult(snr=snr, width=w, phase=ph)


class FFACandidate(NamedTuple):
    period: float  # seconds
    dm: float
    snr: float
    width: int  # boxcar bins (of the folded profile)
    dc: float  # duty cycle = width / period_bins


def _extract_octave(snr, wid, n, tcur, p_start, p_end, snr_min, dm, m_pad, out) -> None:
    """The candidates of one trial's octave: per base period in range, the
    best of the rows j < m (the complete periods of the ``n``-sample
    series, at least 2) above ``snr_min``, at period p0 + j/(m-1): the JAX
    package's row-to-period map (its ops/ffa.py:_extract_octave). Row j of
    the m_pad-row transform holds the fold at p0 + j/(m_pad-1), so where m
    < m_pad these periods are off by up to (m_pad-1)/(m-1) - 1 bins; the
    port keeps the reference's map until the reference is repaired
    (ROADMAP §C)."""
    for pi in range(snr.shape[0]):
        p0 = _PMIN + pi
        p_lo, p_hi = p0 * tcur, (p0 + 1) * tcur
        if p_hi < p_start or p_lo > p_end:
            continue
        m = min(max(n // p0, 2), m_pad)
        row = int(np.argmax(snr[pi, :m]))
        s = float(snr[pi, row])
        if s >= snr_min:
            period = (p0 + row / max(m - 1, 1)) * tcur
            if p_start <= period <= p_end:
                out.append(FFACandidate(
                    period=period, dm=dm, snr=s, width=int(wid[pi, row]),
                    dc=float(wid[pi, row]) / p0,
                ))


def ffa_search_block(
    trials: np.ndarray,  # (D, N) dedispersed time series (host)
    tsamp: float,
    p_start: float,
    p_end: float,
    min_dc: float,
    dms,  # (D,) DM values for candidate tagging
    snr_min: float = 6.0,
    hbm_budget: int = 2_000_000_000,
    progress=None,  # optional callable(fraction in [0, 1])
    device: str | torch.device = "cuda",
) -> list[FFACandidate]:
    """Full staircase FFA search of a block of DM trials on ``device``:
    each octave folds as many trials at once as ``hbm_budget`` allows,
    then the series are downsampled by 2 so base periods stay in
    [PMIN, PMAX). Returns the period-collapsed candidates."""
    dev = torch.device(device)
    X = np.asarray(trials, dtype=np.float32)
    X = X - X.mean(axis=1, keepdims=True)
    ds = max(1, int(p_start / tsamp / _PMIN))
    Xd = X[:, : X.shape[1] // ds * ds].reshape(X.shape[0], -1, ds).sum(axis=2)
    tcur = tsamp * ds
    if p_start < _PMIN * tcur:
        warnings.warn(
            f"FFA effective start period is {_PMIN * tcur:.4f} s "
            f"(requested {p_start}): base periods fold at >= {_PMIN} "
            f"bins of the {tcur:.6f} s downsampled series"
        )
    cands: list[FFACandidate] = []
    n_oct = max(1, int(np.ceil(np.log2(max(2.0, p_end / (_PMIN * tcur))))))
    oct_i = 0
    while _PMIN * tcur < p_end:
        m_pad = 1 << max(1, int(np.ceil(np.log2(max(2, Xd.shape[1] // _PMIN)))))
        widths = duty_cycle_widths(min_dc)
        # working set ~ (P, m_pad, PMAX) f32 profiles a trial, three live
        per_trial = (_PMAX - _PMIN) * m_pad * _PMAX * 4 * 3
        d_blk = max(1, min(Xd.shape[0], hbm_budget // per_trial))
        for s0 in range(0, Xd.shape[0], d_blk):
            res = ffa_octave(torch.from_numpy(Xd[s0 : s0 + d_blk]).to(dev), m_pad, widths)
            # audit: ignore[PSA001] -- the host reads each block's octave
            snr, wid = res.snr.cpu().numpy(), res.width.cpu().numpy()
            for d in range(snr.shape[0]):
                _extract_octave(snr[d], wid[d], Xd.shape[1], tcur, p_start, p_end,
                                snr_min, float(dms[s0 + d]), m_pad, cands)
        oct_i += 1
        if progress is not None:
            progress(min(1.0, oct_i / n_oct))
        if Xd.shape[1] < 4 * _PMAX:
            if 2 * _PMIN * tcur < p_end:
                warnings.warn(
                    f"FFA stopped at {_PMAX * tcur:.3f} s (requested "
                    f"p_end {p_end}): the series is too short to fold "
                    f"longer periods meaningfully"
                )
            break
        Xd = Xd[:, : Xd.shape[1] // 2 * 2].reshape(Xd.shape[0], -1, 2).sum(axis=2)
        tcur *= 2
    return collapse_periods(cands)


def ffa_search_series(
    x: np.ndarray,  # (N,) dedispersed, whitened time series
    tsamp: float,
    p_start: float,
    p_end: float,
    min_dc: float,
    dm: float = 0.0,
    snr_min: float = 6.0,
    device: str | torch.device = "cuda",
) -> list[FFACandidate]:
    """:func:`ffa_search_block` of one series."""
    return ffa_search_block(
        np.asarray(x)[None, :], tsamp, p_start, p_end, min_dc, [dm],
        snr_min=snr_min, device=device,
    )


def collapse_periods(cands: list[FFACandidate], tol: float = 1e-3) -> list[FFACandidate]:
    """Sort by S/N descending and keep the strongest candidate of each
    near-duplicate period cluster (relative tolerance)."""
    cands = sorted(cands, key=lambda c: -c.snr)
    out: list[FFACandidate] = []
    for c in cands:
        if all(abs(c.period - o.period) / o.period > tol for o in out):
            out.append(c)
    return out
