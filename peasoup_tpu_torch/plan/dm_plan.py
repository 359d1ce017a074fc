"""Dispersion-measure trial planning.

The reference delegates DM-list generation and the per-channel delay
table to the external ``dedisp`` CUDA library
(reference: include/transforms/dedisperser.hpp:54-62 calls
``dedisp_generate_dm_list``). We re-derive both bit-faithfully: Lina
Levin's tolerance recurrence for the trial spacing (f64 on f32-rounded
plan inputs, each trial stored through f32 — dedisp's float dm_table),
and dedisp's generate_delay_table for the per-channel delays — which
uses the ROUNDED dispersion constant 4.15e3 (its source notes the more
precise 4.148741601e3 but deliberately ships 4.15e3). Matching that
rounding is required for candidate parity: the f64 divergence oracle
(tools/divergence.py) reproduces the golden candidates.peasoup S/N to
every printed digit with 4.15e3 and is 0.3-0.6% off at high DM with the
textbook 4.148808e3, because one whole-sample delay rounds differently.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# dedisp's generate_delay_table constant (see module docstring); the
# textbook value 4.148808e3 is NOT what the reference's delays use.
DM_CONSTANT = 4.15e3  # seconds when multiplied by DM * (f_MHz^-2 diff)


def generate_dm_list(
    dm_start: float,
    dm_end: float,
    dt: float,
    ti: float,
    f0: float,
    df: float,
    nchans: int,
    tol: float,
) -> np.ndarray:
    """Generate the DM trial grid with the smearing-tolerance recurrence.

    Args:
      dm_start, dm_end: DM range (pc cm^-3).
      dt: sampling time in SECONDS.
      ti: intrinsic pulse width in MICROSECONDS (--dm_pulse_width).
      f0: frequency of channel 0 in MHz (fch1).
      df: channel width in MHz (foff, negative for descending bands).
      nchans: number of channels.
      tol: smearing tolerance (e.g. 1.10).

    Each next trial is placed where total smearing (sampling + intrinsic
    width + intra-channel dispersion + inter-trial DM error across the
    band) grows by the tolerance factor. All intermediate math in f64;
    trials are rounded through f32 to match the reference's stored list.
    """
    # dedisp receives every one of these as dedisp_float (f32): dt/f0/df
    # live in the plan struct, ti/tol are dedisp_generate_dm_list args.
    # The recurrence itself then runs in f64 on the f32-rounded values.
    dt = float(np.float32(dt))
    ti = float(np.float32(ti))
    f0 = float(np.float32(f0))
    df = float(np.float32(df))
    tol = float(np.float32(tol))
    dt_us = dt * 1e6
    f_centre_ghz = (f0 + (nchans // 2 - 0.5) * df) * 1e-3
    tol2 = tol * tol
    # Intra-channel smearing per unit DM (us): 8.3 * df_MHz / f_GHz^3
    a = 8.3 * df / f_centre_ghz**3
    a2 = a * a
    # Across-the-band smearing term for a DM *error*: the band is nchans
    # channels wide, so the band-edge delay error per unit dDM is
    # (nchans/4)*a in the same units; squared -> a2*nchans^2/16.
    b2 = a2 * (nchans * nchans / 16.0)
    c = (dt_us * dt_us + ti * ti) * (tol2 - 1.0)

    # Each trial is stored as f32 and the f32 value feeds the next
    # recurrence step, matching dedisp's float dm_table; the step itself
    # is evaluated in f64.
    dms = [np.float32(dm_start)]
    while dms[-1] < dm_end:
        prev = float(dms[-1])
        prev2 = prev * prev
        k = c + tol2 * a2 * prev2
        dm = (b2 * prev + np.sqrt(-a2 * b2 * prev2 + (b2 + a2) * k)) / (a2 + b2)
        dms.append(np.float32(dm))
    return np.asarray(dms, dtype=np.float32)


def delay_table(f0: float, df: float, nchans: int, dt: float) -> np.ndarray:
    """Per-channel dispersion delay in SAMPLES per unit DM, bit-faithful
    to dedisp's generate_delay_table: ``a = 1.f/(f0+c*df)`` and the
    difference of squares in f32 arithmetic, scaled by the f64 quotient
    ``4.15e3/dt`` and rounded once to the f32 table entry.
    """
    f0 = np.float32(f0)
    df = np.float32(df)
    c = np.arange(nchans, dtype=np.float32)
    a = (np.float32(1.0) / (f0 + c * df)).astype(np.float32)
    b = np.float32(1.0) / f0
    diff2 = (a * a - b * b).astype(np.float32)
    return (
        np.float64(DM_CONSTANT) / np.float64(np.float32(dt))
        * diff2.astype(np.float64)
    ).astype(np.float32)


def max_delay_samples(dm_max: float, delays: np.ndarray) -> int:
    """Maximum whole-sample delay at the largest trial DM: dedisp's
    ``dm_list[last] * delay_table[nchans-1] + 0.5`` truncation, with the
    product in f32 (both factors are f32 in the library).

    For standard descending bands (foff < 0) the table is monotone and
    ``abs(delays).max() == abs(delays[-1])`` exactly, so using the max
    keeps dedisp parity while staying safe for ascending-frequency
    inputs, where the largest |delay| need not sit at the last channel
    (per-channel reads would otherwise run past the input)."""
    prod = np.float32(np.float32(dm_max) * np.abs(delays).max())
    return int(np.floor(np.float64(prod) + 0.5))


@dataclass
class DMPlan:
    """The full dedispersion plan: trial list + per-channel delays."""

    dm_list: np.ndarray  # (ndm,) f32
    delays: np.ndarray  # (nchans,) f32 samples per unit DM
    killmask: np.ndarray  # (nchans,) int, 1 = keep
    max_delay: int
    out_nsamps: int

    @classmethod
    def create(
        cls,
        nsamps: int,
        nchans: int,
        tsamp: float,
        fch1: float,
        foff: float,
        dm_start: float,
        dm_end: float,
        pulse_width: float = 64.0,
        tol: float = 1.10,
        dm_list: np.ndarray | None = None,
        killmask: np.ndarray | None = None,
    ) -> "DMPlan":
        if dm_list is None:
            dm_list = generate_dm_list(
                dm_start, dm_end, tsamp, pulse_width, fch1, foff, nchans, tol
            )
        dm_list = np.asarray(dm_list, dtype=np.float32)
        delays = delay_table(fch1, foff, nchans, tsamp)
        md = max_delay_samples(float(dm_list.max()), delays)
        if killmask is None:
            killmask = np.ones(nchans, dtype=np.int32)
        return cls(
            dm_list=dm_list,
            delays=delays,
            killmask=np.asarray(killmask, dtype=np.int32),
            max_delay=md,
            out_nsamps=nsamps - md,
        )

    @property
    def ndm(self) -> int:
        return len(self.dm_list)

    def subset(self, lo: int, hi: int) -> "DMPlan":
        """The [lo, hi) slice of the trial list, keeping the whole list's
        max_delay and out_nsamps, so every slice's trials have the same
        length (the JAX package's DMPlan.subset)."""
        return DMPlan(
            dm_list=self.dm_list[lo:hi], delays=self.delays, killmask=self.killmask,
            max_delay=self.max_delay, out_nsamps=self.out_nsamps,
        )

    def delay_samples(self) -> np.ndarray:
        """Integer delay (ndm, nchans) in samples: round-half-even of
        the F32 product ``dm * delay_table[c]`` (the dedisp kernel's
        __float2uint_rn on float operands)."""
        prod = (
            self.dm_list[:, None] * np.abs(self.delays)[None, :]
        ).astype(np.float32)
        return np.rint(prod).astype(np.int32)
