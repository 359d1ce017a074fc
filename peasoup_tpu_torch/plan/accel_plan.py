"""Acceleration-trial planning (reference: include/utils/utils.hpp:140-193).

The trial step is set so that the quadratic drift mismatch between
neighbouring trials smears a pulse of effective width w by no more than
the tolerance factor: alt_a = 2 * w * 24c / tobs^2 * sqrt(tol^2 - 1),
with w^2 = tdm^2 + tpulse^2 + tsamp^2 (tdm the intra-channel DM smear).

Quirks preserved for parity:
  * 0.0 is explicitly prepended when both range ends are non-zero
    (utils.hpp:183-184), so the list is NOT sorted;
  * the walk appends acc_hi after the loop, so the last interval can be
    shorter than alt_a (utils.hpp:186-190);
  * acc_hi == acc_lo yields the single trial [0.0] (utils.hpp:169-173).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SPEED_OF_LIGHT = 299792458.0


@dataclass
class AccelerationPlan:
    acc_lo: float
    acc_hi: float
    tol: float
    pulse_width: float  # microseconds (--acc_pulse_width)
    nsamps: int  # FFT size used for the search
    tsamp: float  # seconds
    cfreq: float  # MHz
    bw: float  # MHz (absolute total bandwidth)
    # Golden-vs-modern pulse-width semantics (full analysis: PARITY.md
    # "accel plan"): the 2014 golden binary fed pulse_width to the width
    # sum in MICROSECONDS; today's reference source (utils.hpp:165)
    # divides it by 1e3 first, shrinking alt_a ~100x.  Default False
    # matches the golden artifacts (the only parity ground truth);
    # set True to reproduce a build of the checked-in reference source.
    modern_pulse_width: bool = False

    def __post_init__(self):
        self.bw = abs(self.bw)
        self.tobs = self.nsamps * self.tsamp
        if self.modern_pulse_width:
            # current reference source: ``pulse_width /= 1.0e3`` in the
            # constructor (utils.hpp:165) — f32 division like the float
            # member it mutates
            self.pulse_width = float(
                np.float32(self.pulse_width) / np.float32(1.0e3)
            )

    def step(self, dm: float) -> float:
        """Trial spacing alt_a at the given DM (m/s^2).

        Follows the GOLDEN binary's semantics: pulse_width enters the
        width sum in MICROSECONDS (w_us = sqrt(tdm + pw^2 + tsamp^2),
        utils.hpp:175-179).  The reference repo's current utils.hpp:165
        divides pulse_width by 1e3 in the constructor — a later upstream
        change the 2014 golden artifacts demonstrably predate: with the
        division, the tutorial flags yield alt_a ~ 0.24 m/s^2 (~44 accel
        trials/DM), while the golden candidates.peasoup assoc lists
        contain exactly the accs {0, -5, +5} per DM trial, which
        requires alt_a > 10 (w_us = 64 gives ~240).  We match the
        artifacts, which are the only ground truth for parity.
        """
        # C semantics: float locals, double expression evaluation, one
        # truncation per assignment.
        f32 = np.float32
        bw = float(f32(self.bw))
        cfreq = float(f32(self.cfreq))
        tol = f32(self.tol)
        pulse_width = f32(self.pulse_width)
        tsamp = f32(self.tsamp)
        tobs = float(f32(self.nsamps) * f32(self.tsamp))  # uint*float: f32
        tdm = float(f32((8.3 * bw / cfreq**3 * float(f32(dm))) ** 2))
        tpulse = float(pulse_width * pulse_width)  # float*float: f32
        ttsamp = float(tsamp * tsamp)  # float*float: f32
        # float + float additions, then sqrt rounded once to the local
        w_us = float(f32(np.sqrt(np.float64(f32(f32(tdm + tpulse) + ttsamp)))))
        return float(
            f32(
                2.0 * w_us * 1.0e-6 * 24.0 * SPEED_OF_LIGHT / tobs / tobs
                * np.sqrt(np.float64(tol * tol) - 1.0)
            )
        )

    def generate_accel_list(self, dm: float) -> np.ndarray:
        if self.acc_hi == self.acc_lo:
            return np.zeros(1, dtype=np.float32)
        alt_a = self.step(dm)
        accs: list[float] = []
        if self.acc_hi != 0 and self.acc_lo != 0:
            accs.append(0.0)
        acc = np.float32(self.acc_lo)
        alt_a32 = np.float32(alt_a)
        while acc < self.acc_hi:
            accs.append(float(acc))
            acc = np.float32(acc + alt_a32)
        accs.append(float(self.acc_hi))
        return np.asarray(accs, dtype=np.float32)
