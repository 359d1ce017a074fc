"""The search's plan, worked out again from the header and the flags, as
peasoup defines it (the semantics the port follows): the DM trials
(dedisp's smearing-tolerance recurrence over f32 values), the per-channel
delays (dedisp's delay table with its constant 4.15e3), the FFT size (the
power of two peasoup picks), the kept channels of the kill mask, the acceleration trials of each DM
(peasoup's ``AccelerationPlan``), the harmonic levels' search windows and
bin-to-frequency factors, the birdie mask and the red-noise boundaries.
Plain numpy; f32 where peasoup stores f32."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

F32 = np.float32
SPEED_OF_LIGHT = 299792458.0


def dm_trials(dm_start, dm_end, tsamp, pulse_width_us, fch1, foff, nchans, tol) -> np.ndarray:
    """dedisp's DM list: each next trial where the smearing (sampling,
    intrinsic width, in-channel dispersion and the DM step across the
    band) grows by ``tol``; f64 steps on f32 inputs, each trial f32."""
    dt, ti, f0, df, tol = (float(F32(v)) for v in (tsamp, pulse_width_us, fch1, foff, tol))
    dt_us = dt * 1e6
    fc = (f0 + (nchans // 2 - 0.5) * df) * 1e-3
    a2 = (8.3 * df / fc**3) ** 2
    b2 = a2 * nchans * nchans / 16.0
    c = (dt_us * dt_us + ti * ti) * (tol * tol - 1.0)
    out = [F32(dm_start)]
    while out[-1] < dm_end:
        p = float(out[-1])
        k = c + tol * tol * a2 * p * p
        out.append(F32((b2 * p + math.sqrt(-a2 * b2 * p * p + (b2 + a2) * k)) / (a2 + b2)))
    return np.asarray(out, dtype=F32)


def delay_per_dm(fch1, foff, nchans, tsamp) -> np.ndarray:
    """Samples of delay per unit DM of each channel: f32 differences of
    inverse squares, times 4.15e3 / tsamp in f64, stored as f32."""
    f = F32(fch1) + np.arange(nchans, dtype=F32) * F32(foff)
    inv = (F32(1.0) / f).astype(F32)
    d2 = (inv * inv - F32(1.0) / F32(fch1) * (F32(1.0) / F32(fch1))).astype(F32)
    return (4.15e3 / float(F32(tsamp)) * d2.astype(np.float64)).astype(F32)


def prev_pow2(n: int) -> int:
    """peasoup's FFT size: the power of two p with p < n <= 2p."""
    p = 1
    while 2 * p < n:
        p *= 2
    return p


def accel_trials(acc_lo, acc_hi, tol, pulse_width_us, size, tsamp, cfreq, chan_bw, dm) -> np.ndarray:
    """peasoup's acceleration list at ``dm``: 0 first where both ends are
    non-zero, then acc_lo stepping by the smearing step below acc_hi,
    then acc_hi; [0] where the ends are equal."""
    if acc_hi == acc_lo:
        return np.zeros(1, dtype=F32)
    bw = float(F32(abs(chan_bw)))
    cf = float(F32(cfreq))
    tobs = float(F32(size) * F32(tsamp))
    tdm = float(F32((8.3 * bw / cf**3 * float(F32(dm))) ** 2))
    w = float(F32(np.sqrt(np.float64(F32(F32(tdm + float(F32(pulse_width_us) ** 2))
                                          + float(F32(tsamp) * F32(tsamp)))))))
    step = F32(2.0 * w * 1e-6 * 24.0 * SPEED_OF_LIGHT / tobs / tobs
               * np.sqrt(np.float64(F32(tol) * F32(tol)) - 1.0))
    accs = [0.0] if (acc_hi != 0 and acc_lo != 0) else []
    a = F32(acc_lo)
    while a < acc_hi:
        accs.append(float(a))
        a = F32(a + step)
    accs.append(float(acc_hi))
    return np.asarray(accs, dtype=F32)


def accel_factor(acc: float, tsamp: float) -> np.float32:
    """The resample factor a * tsamp / 2c: an f32 product, an f64 quotient,
    stored as f32."""
    return F32(float(F32(F32(acc) * F32(tsamp))) / (2.0 * SPEED_OF_LIGHT))


@dataclass
class Plan:
    dm_list: np.ndarray  # (ndm,) f32
    delays: np.ndarray  # (ndm, nchans) int64 samples
    out_nsamps: int
    size: int
    accels: list  # per DM trial, f32 arrays
    windows: np.ndarray  # (nlev, 2) [start, limit) bins
    factors: np.ndarray  # (nlev,) f32: frequency of bin 1 at each level
    zapmask: np.ndarray  # (size // 2 + 1,) bool
    pos5: int
    pos25: int
    scale: float  # the dedispersed sums' factor into u8
    nbins: int
    chans: np.ndarray  # the kept channels' indices, ascending

    @property
    def nlev(self) -> int:
        return len(self.factors)


def cfreq(header: dict) -> float:
    n, f1, df = header["nchans"], header["fch1"], header["foff"]
    return f1 + df * n / 2 if df < 0 else f1 - df * n / 2


def make_plan(header: dict, search: dict, birdies: list, keep=None) -> Plan:
    """The plan of a search with flags ``search`` (SearchConfig's names and
    defaults) over an observation with ``header``, whose channels ``keep``
    (1 keep, 0 kill; None keeps all) are summed. The kill mask changes
    neither the DM trials nor the delays, only the channels summed and the
    scale."""
    s = dict(DEFAULTS, **search)
    nchans, nsamps, tsamp = int(header["nchans"]), int(header["nsamps"]), float(header["tsamp"])
    dms = dm_trials(s["dm_start"], s["dm_end"], tsamp, s["dm_pulse_width"], header["fch1"],
                    header["foff"], nchans, s["dm_tol"])
    per_dm = delay_per_dm(header["fch1"], header["foff"], nchans, tsamp)
    max_delay = int(np.floor(np.float64(F32(F32(dms.max()) * np.abs(per_dm).max())) + 0.5))
    delays = np.rint((dms[:, None] * np.abs(per_dm)[None, :]).astype(F32)).astype(np.int64)
    size = prev_pow2(nsamps)
    nbins = size // 2 + 1
    tobs32 = F32(size) * F32(tsamp)
    bin_width = float(F32(1.0 / float(tobs32)))
    accels = [accel_trials(s["acc_start"], s["acc_end"], s["acc_tol"], s["acc_pulse_width"],
                           size, tsamp, cfreq(header), header["foff"], float(dm)) for dm in dms]
    nh = int(s["nharmonics"])
    # search window of each level (peasoup's PeakFinder): min_freq to max_freq
    bw64 = 1.0 / float(tobs32)
    nyq = bw64 * nbins
    windows = np.asarray([
        (int(2.0 * (nbins - 1.0) * (s["min_freq"] / nyq) * 2.0**h),
         min(nbins, int((s["max_freq"] / bw64) * 2.0**h))) for h in range(nh + 1)],
        dtype=np.int64)
    # frequency of bin 1 at each level, in peasoup's f32 steps
    bw32 = F32(1.0 / np.float64(tobs32))
    nyq32 = F32(np.float64(bw32) * np.float64(nbins))
    factors = np.asarray([F32(1.0 / np.float64(nbins) * np.float64(nyq32) / 2.0**h)
                          for h in range(nh + 1)], dtype=F32)
    zap = np.zeros(nbins, dtype=bool)
    for f, w in birdies:
        lo = max(0, math.floor(F32(F32(f - w) / F32(bin_width))))
        hi = math.ceil(F32(F32(f + w) / F32(bin_width)))
        if lo >= nbins:
            continue
        zap[lo : min(hi, nbins - 1)] = True
    chans = np.arange(nchans) if keep is None else np.flatnonzero(np.asarray(keep))
    max_sum = (2 ** int(header["nbits"]) - 1) * max(1, len(chans))
    return Plan(
        dm_list=dms, delays=delays, out_nsamps=nsamps - max_delay, size=size,
        accels=accels, windows=windows, factors=factors, zapmask=zap,
        pos5=int(s["boundary_5_freq"] / bin_width), pos25=int(s["boundary_25_freq"] / bin_width),
        scale=1.0 if max_sum <= 255 else 255.0 / max_sum, nbins=nbins, chans=chans,
    )


# peasoup's defaults for the flags a traffic mix may leave out
DEFAULTS = dict(
    dm_start=0.0, dm_end=100.0, dm_tol=1.10, dm_pulse_width=64.0, acc_start=0.0,
    acc_end=0.0, acc_tol=1.10, acc_pulse_width=64.0, boundary_5_freq=0.05,
    boundary_25_freq=0.5, nharmonics=4, min_snr=9.0, min_freq=0.1, max_freq=1100.0,
    max_harm=16, freq_tol=1e-4, limit=1000,
)
