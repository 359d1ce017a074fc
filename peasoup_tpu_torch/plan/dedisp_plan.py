"""Dedispersion strategy planning: the exact sum, two-stage subbands or
the banded matmul, for one shape bucket (the JAX package's
plan/dedisp_plan.py, copied: the same cost model, the same parity gate,
the same plan, field for field, for the same bucket).

The port has three dedispersion engines (ops/dedisperse.py): the
dedisperse kernel (the exact sum), two-stage subband dedispersion
("Accelerating incoherent dedispersion", arXiv:1201.5380) and the
banded-matmul engine, which recasts the shift-and-sum as a one-hot
contraction. This module is the decision layer: an analytic cost model
over the bucket's real delay table and a parity gate whose inputs (the
largest extra smear in samples, the largest fractional S/N loss) are
plan parameters. Which shape knobs run fastest is a property of the
device ("Real-Time Dedispersion ... using Auto Tuning",
arXiv:1601.01165): perf/tuning.py measures them and caches the winners.
This module is numpy only.

Cost model (arithmetic, in channel-sum MACs over the trial set):

* exact:    ``ndm * nchans * out_nsamps``
* subband:  ``n_groups * nchans * out_nsamps``  (stage 1, once per
  nominal DM) ``+ ndm * nsub * out_nsamps``     (stage 2, per trial)
* matmul:   ``sum_blocks ndm_b * nchans * band_b * out_nsamps`` MACs
  (band_b the block's real one-hot band from the delay table), rated at
  ``MXU_MAC_GAIN`` gather-MACs per matmul-MAC and bounded below by the
  byte traffic: an effective cost of
  ``max(macs / MXU_MAC_GAIN, bytes / HBM_BYTES_PER_MAC)``.

The constants (``MXU_MAC_GAIN``, ``HBM_BYTES_PER_MAC``,
``MATMUL_RACE_SLACK``, ``MIN_SUBBAND_NCHANS``) are the JAX model's
relative units, kept so that the analytic plan is the JAX package's for
the same bucket. They describe no property of the H100: there the race
of perf/tuning.py, which times the engines on the card, decides.

``n_groups`` comes from the bucket's actual delay table by the greedy
smear-bounded grouping the engine runs (:func:`subband_group_spans`, a
vectorised twin of ops/dedisperse.py:subband_groups with the same spans,
plus each group's realised worst smear for the S/N gate).

The matmul engine is bitwise the exact sum for integer samples, so it
has no parity gate, but :meth:`DedispPlan.select` never picks it: it
records ``cost_matmul`` and flags ``matmul_candidate`` when the model
puts it within ``MATMUL_RACE_SLACK`` of the gather winner, and the tuner
selects it only where it measures faster.

Parity gate: substituting a group nominal's intra-band delay shape moves
each channel's read by at most the group's realised smear ``s`` samples.
A boxcar matched filter on a pulse of effective width ``w`` samples
smeared over ``w + s`` loses S/N by the factor ``sqrt(w / (w + s))``;
the plan predicts the worst loss per trial and selects subbands only when
it stays within ``max_snr_loss``. ``max_smear = 0`` keeps the engines
bitwise equal.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

from .dm_plan import DMPlan

PLAN_VERSION = 2

# structural floor for the two-stage split: below ~64 channels the
# stage-2 pass over nsub pseudo-channels plus the extra dispatches eat
# the arithmetic win (the ~sqrt(C) argument needs C >> nsub >> 1), so
# the planner never proposes subbands there — "exact must win at small
# nchans" is a plan invariant, not a tuning outcome
MIN_SUBBAND_NCHANS = 64
MIN_SUBBANDS = 8

# banded-matmul rate model (the JAX model's RELATIVE units — one gather-MAC of the
# channel scan is the unit of work; the empirical tuner arbitrates the
# real ratio per device): a conservative MXU-vs-VPU MAC throughput
# advantage for f32 one-hot contractions, and the HBM bytes one
# gather-MAC's time buys (the matmul engine is memory-bound once the
# band is narrow, so the byte term keeps the model honest there)
MXU_MAC_GAIN = 8.0
HBM_BYTES_PER_MAC = 2.0
# race the matmul engine on the device whenever the analytic model puts
# it within this factor of the gather winner (generous on purpose:
# measurement, not the model, decides)
MATMUL_RACE_SLACK = 4.0


def effective_subbands(nchans: int, nsub: int) -> int:
    """The engine's effective band count for a requested ``nsub``
    (ops.dedisperse.dedisperse_subband normalises the same way)."""
    w = -(-nchans // max(1, min(nsub, nchans)))
    return -(-nchans // w)


def intra_band_shapes(delay_table: np.ndarray, nsub: int) -> np.ndarray:
    """Per-trial intra-band delay shapes d1[d, c] = delay[d, c] -
    min(delay[d, band(c)]) under the engine's band grouping and
    min-reference convention (ops.dedisperse.dedisperse_subband)."""
    delay_table = np.asarray(delay_table)
    _, C = delay_table.shape
    nsub = effective_subbands(C, nsub)
    w = -(-C // nsub)
    band_of = np.minimum(np.arange(C) // w, nsub - 1)
    refdel = np.stack(
        [delay_table[:, b : b + w].min(axis=1) for b in range(0, C, w)],
        axis=1,
    )
    return delay_table - refdel[:, band_of]


def subband_group_spans(
    delay_table: np.ndarray,
    nsub: int,
    max_smear: float,
    budgets: Optional[np.ndarray] = None,
) -> list[tuple[int, int, int]]:
    """Greedy smear-bounded DM-trial grouping: the vectorised twin of
    ``ops.dedisperse.subband_groups`` (identical [lo, hi) spans — a
    test pins the equivalence) returning ``(lo, hi, err)`` with each
    group's realised worst-case intra-band smear in samples. With
    ``budgets`` each trial joins under its OWN per-trial cap (the
    DM-scaled smear budget) instead of the global ``max_smear``."""
    d1 = intra_band_shapes(delay_table, nsub)
    D = d1.shape[0]
    caps = (
        np.full(D, float(max_smear))
        if budgets is None
        else np.asarray(budgets, dtype=np.float64)
    )
    spans: list[tuple[int, int, int]] = []
    lo = 0
    step = 128
    while lo < D:
        hi = lo + 1
        err = 0
        while hi < D:
            j = min(D, hi + step)
            errs = np.abs(d1[hi:j] - d1[lo]).max(axis=1)
            bad = np.nonzero(errs > caps[hi:j])[0]
            if bad.size:
                if bad[0] > 0:
                    err = max(err, int(errs[: bad[0]].max()))
                hi += int(bad[0])
                break
            if errs.size:
                err = max(err, int(errs.max()))
            hi = j
        spans.append((lo, hi, err))
        lo = hi
    return spans


def dm_smear_budgets(
    dm_list,
    *,
    tsamp: float,
    fch1: float,
    foff: float,
    nchans: int,
    pulse_width_us: float,
    max_snr_loss: float,
    floor: float = 1.0,
) -> np.ndarray:
    """Per-trial smear budgets in samples: the largest extra smear
    whose predicted matched-filter S/N loss at that trial's effective
    width stays within ``max_snr_loss``. Inverting
    ``predicted_snr_loss(w, s) = 1 - sqrt(w / (w + s)) <= L`` gives
    ``s <= w * (1 / (1 - L)^2 - 1)`` — high-DM trials, whose intrinsic
    dispersion smearing already dominates ``w``, absorb many samples
    of grouping smear for the same loss, so they stop forcing
    conservative plans (the DM-dependent smear budget).
    ``floor`` keeps the low-DM budget at the classic global value."""
    loss = min(max(float(max_snr_loss), 0.0), 0.99)
    k = 1.0 / (1.0 - loss) ** 2 - 1.0
    ws = np.asarray(
        [
            effective_width_samples(
                float(dm), tsamp, pulse_width_us, fch1, foff, nchans
            )
            for dm in np.asarray(dm_list, dtype=np.float64)
        ]
    )
    return np.maximum(float(floor), ws * k)


def matmul_cost_profile(
    delay_table: np.ndarray,
    out_nsamps: int,
    block: Optional[int] = None,
    quant: Optional[int] = None,
) -> dict:
    """Analytic MAC + byte profile of the banded-matmul engine over the
    bucket's REAL delay table: per aligned DM-trial block, the one-hot
    band is the block's worst per-channel delay spread (padded to the
    engine's quantum), MACs are ``ndm_b * C * band_b * T`` and bytes
    are the block's f32 window copy plus its output. Returns
    ``{"macs", "bytes", "max_band", "effective"}`` with ``effective``
    in gather-MAC units (max of the MXU-rated MAC term and the
    HBM-rated byte term)."""
    from ..ops.dedisperse import MATMUL_BAND_QUANT, MATMUL_BLOCK, matmul_band

    block = MATMUL_BLOCK if block is None else block
    quant = MATMUL_BAND_QUANT if quant is None else quant
    dt = np.asarray(delay_table)
    D, C = dt.shape
    T = max(1, int(out_nsamps))
    macs = 0.0
    nbytes = 0.0
    max_band = 0
    for lo in range(0, D, block):
        blk = dt[lo : lo + block]
        band = matmul_band(blk, quant)
        max_band = max(max_band, band)
        db = len(blk)
        macs += float(db) * C * band * T
        nbytes += 4.0 * (C * (T + band - 1) + db * T)
    effective = max(macs / MXU_MAC_GAIN, nbytes / HBM_BYTES_PER_MAC)
    return {
        "macs": macs,
        "bytes": nbytes,
        "max_band": int(max_band),
        "effective": effective,
    }


def effective_delay_table(
    delay_table: np.ndarray,
    nsub: int,
    max_smear: float,
    budgets: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The integer delay table the subband engine EFFECTIVELY applies:
    each trial reads channel c at ``refdel[d, band(c)] + d1[lo, c]``
    with ``lo`` its group's nominal. Direct dedispersion with this
    table is bitwise what the two-stage engine computes (channel sums
    of <= 8-bit samples are exact in f32, so the differing summation
    order cannot change the result) — the parity property tests pin
    that equality, and ``|effective - true| <= max_smear`` everywhere
    is the smear bound made concrete."""
    delay_table = np.asarray(delay_table)
    _, C = delay_table.shape
    nsub_eff = effective_subbands(C, nsub)
    w = -(-C // nsub_eff)
    band_of = np.minimum(np.arange(C) // w, nsub_eff - 1)
    refdel = np.stack(
        [delay_table[:, b : b + w].min(axis=1) for b in range(0, C, w)],
        axis=1,
    )
    d1 = delay_table - refdel[:, band_of]
    eff = np.empty_like(delay_table)
    spans = subband_group_spans(delay_table, nsub_eff, max_smear, budgets)
    for lo, hi, _ in spans:
        eff[lo:hi] = refdel[lo:hi][:, band_of] + d1[lo][None, :]
    return eff


def effective_width_samples(
    dm: float, tsamp: float, pulse_width_us: float,
    fch1: float, foff: float, nchans: int,
) -> float:
    """Effective pulse width in SAMPLES at one DM trial: the same
    smearing terms the DM-trial recurrence uses (plan/dm_plan.py) —
    sampling time, intrinsic width, and the per-channel dispersion
    smear 8.3 * |df_MHz| / f_GHz^3 * DM microseconds."""
    dt_us = float(tsamp) * 1e6
    f_centre_ghz = (float(fch1) + (nchans // 2 - 0.5) * float(foff)) * 1e-3
    a = 8.3 * abs(float(foff)) / max(1e-9, abs(f_centre_ghz)) ** 3
    w_us = math.sqrt(
        dt_us * dt_us
        + float(pulse_width_us) ** 2
        + (a * float(dm)) ** 2
    )
    return max(1.0, w_us / dt_us)


def predicted_snr_loss(width_samps: float, smear_samps: float) -> float:
    """Fractional matched-filter S/N loss from smearing a pulse of
    effective width ``w`` samples over ``s`` extra samples:
    1 - sqrt(w / (w + s))."""
    w = max(1e-9, float(width_samps))
    return 1.0 - math.sqrt(w / (w + max(0.0, float(smear_samps))))


def candidate_subbands(nchans: int) -> list[int]:
    """The nsub candidate grid: powers of two around sqrt(nchans),
    clipped to the structural window [MIN_SUBBANDS, nchans // 4].
    Empty below MIN_SUBBAND_NCHANS — exact wins there by plan
    invariant."""
    if nchans < MIN_SUBBAND_NCHANS:
        return []
    s0 = 1 << round(math.log2(math.sqrt(nchans)))
    cands = sorted(
        {
            min(max(s, MIN_SUBBANDS), nchans // 4)
            for s in (s0 // 2, s0, s0 * 2)
        }
    )
    return [s for s in cands if MIN_SUBBANDS <= s <= nchans // 4]


@dataclass
class DedispPlan:
    """One bucket's dedispersion strategy: the engine choice plus the
    shape knobs the drivers consume. ``source`` records provenance:
    ``analytic`` (cost model only), ``tuned`` (per-device measurements
    refined the knobs, perf/tuning.py), ``cache`` (loaded from the
    tuning cache with zero re-measurement)."""

    engine: str = "exact"  # "exact" | "subband" | "matmul" (matmul
    # only ever via the tuner's measured race — select() never picks it)
    subbands: int = 0
    subband_smear: float = 0.0
    subband_matmul: bool = False  # subband stages as banded matmuls
    dedisp_block: int = 16
    dm_block: int = 0  # 0 = driver auto-sizing
    accel_bucket: int = 0  # 0 = driver default (tuned knob)
    pallas_block: int = 0  # the JAX package's Pallas resample tile: the
    # port's resample kernel has no tile knob, so here it stays 0
    cost_exact: float = 0.0
    cost_subband: float = 0.0
    cost_matmul: float = 0.0  # effective gather-MAC units (MAC+bytes)
    matmul_band: int = 0  # worst one-hot band over the real table
    matmul_candidate: bool = False  # analytic model puts matmul within
    # MATMUL_RACE_SLACK of the gather winner -> the tuner races it
    gain: float = 1.0  # cost_exact / cost_subband at the chosen nsub
    predicted_loss: float = 0.0  # worst-group fractional S/N loss
    max_group_smear: int = 0  # realised worst smear (samples)
    n_groups: int = 0
    smear_dm_scaled: bool = False  # grouping used DM-scaled budgets
    smear_loss_budget: float = 0.0  # the per-trial loss fraction those
    # budgets were derived from (drivers rebuild them deterministically
    # via dm_smear_budgets; 0 = global max_smear only)
    source: str = "analytic"
    tuning_s: float = 0.0
    trials: list = field(default_factory=list)  # tuner measurements
    version: int = PLAN_VERSION

    def to_doc(self) -> dict:
        return asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "DedispPlan":
        names = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in doc.items() if k in names})

    def summary(self) -> dict:
        """The compact provenance record for telemetry manifests and
        the BENCH json (full tuner trials stay in the cache file)."""
        return {
            "engine": self.engine,
            "subbands": self.subbands,
            "subband_smear": self.subband_smear,
            "subband_matmul": self.subband_matmul,
            "dedisp_block": self.dedisp_block,
            "dm_block": self.dm_block,
            "accel_bucket": self.accel_bucket,
            "pallas_block": self.pallas_block,
            "gain": round(self.gain, 3),
            "predicted_loss": round(self.predicted_loss, 4),
            "n_groups": self.n_groups,
            "matmul_candidate": self.matmul_candidate,
            "cost_matmul": round(self.cost_matmul, 1),
            "smear_dm_scaled": self.smear_dm_scaled,
            "source": self.source,
            "tuning_s": round(self.tuning_s, 3),
        }

    @classmethod
    def select(
        cls,
        dm_plan: DMPlan,
        *,
        nbits: int,
        tsamp: float,
        fch1: float,
        foff: float,
        max_smear: float = 1.0,
        max_snr_loss: float = 0.1,
        min_gain: float = 1.2,
        pulse_width_us: float = 64.0,
        candidates: Optional[list[int]] = None,
        dm_scale_smear: bool = True,
    ) -> "DedispPlan":
        """Pick exact vs subband for one plan (and profile the matmul
        alternative for the tuner's race). Subband is selected exactly
        when (a) the cost model predicts at least a ``min_gain``
        arithmetic win at the best candidate nsub over the bucket's
        real delay table, AND (b) the parity gate passes: the worst
        per-group predicted S/N loss stays within ``max_snr_loss``.
        With ``dm_scale_smear`` the grouping budget scales per trial
        with its intrinsic DM smearing (:func:`dm_smear_budgets`,
        floored at ``max_smear``) instead of one global cap. The
        matmul engine is bitwise-exact so it has no gate, but its MXU
        advantage is a device property: select() only records
        ``cost_matmul`` and the ``matmul_candidate`` race flag — the
        tuner promotes it when it measures faster. Everything else —
        small bands, loose geometries, tight loss budgets — keeps the
        golden-exact direct scan."""
        D = dm_plan.ndm
        C = len(dm_plan.delays)
        T = max(1, dm_plan.out_nsamps)
        cost_exact = float(D) * C * T
        plan = cls(engine="exact", cost_exact=cost_exact)
        if D < 2:
            return plan
        delay_table = dm_plan.delay_samples()
        mm = matmul_cost_profile(delay_table, T)
        plan.cost_matmul = mm["effective"]
        plan.matmul_band = mm["max_band"]
        budgets = None
        if dm_scale_smear and max_smear > 0 and max_snr_loss > 0:
            budgets = dm_smear_budgets(
                dm_plan.dm_list, tsamp=tsamp, fch1=fch1, foff=foff,
                nchans=C, pulse_width_us=pulse_width_us,
                max_snr_loss=max_snr_loss, floor=max_smear,
            )
        cands = candidates if candidates is not None else candidate_subbands(C)
        cands = [s for s in cands if 2 <= s <= C]
        if cands:
            best: Optional[
                tuple[float, int, list[tuple[int, int, int]]]
            ] = None
            for nsub in cands:
                nsub_eff = effective_subbands(C, nsub)
                spans = subband_group_spans(
                    delay_table, nsub_eff, max_smear, budgets
                )
                cost = float(len(spans)) * C * T + float(D) * nsub_eff * T
                if best is None or cost < best[0]:
                    best = (cost, nsub_eff, spans)
            assert best is not None
            cost_sub, nsub_best, spans = best
            plan.cost_subband = cost_sub
            plan.gain = cost_exact / max(1.0, cost_sub)
            plan.n_groups = len(spans)
            plan.max_group_smear = max(
                (err for _, _, err in spans), default=0
            )
            # parity gate: worst PER-TRIAL loss — each trial's realised
            # smear under its group nominal, at that trial's own
            # effective width (the group-max-at-narrowest-width form
            # over-vetoed DM-scaled budgets, which admit large smears
            # only on trials wide enough to absorb them)
            d1 = intra_band_shapes(delay_table, nsub_best)
            widths = np.asarray(
                [
                    effective_width_samples(
                        float(dm), tsamp, pulse_width_us, fch1, foff, C
                    )
                    for dm in dm_plan.dm_list
                ]
            )
            loss = 0.0
            for lo, hi, err in spans:
                if err <= 0:
                    continue
                errs = np.abs(d1[lo:hi] - d1[lo]).max(axis=1)
                w = widths[lo:hi]
                loss = max(
                    loss,
                    float(
                        np.max(1.0 - np.sqrt(w / (w + np.maximum(errs, 0.0))))
                    ),
                )
            plan.predicted_loss = loss
            if plan.gain >= min_gain and loss <= max_snr_loss:
                plan.engine = "subband"
                plan.subbands = nsub_best
                plan.subband_smear = float(max_smear)
                plan.smear_dm_scaled = budgets is not None
                plan.smear_loss_budget = (
                    float(max_snr_loss) if budgets is not None else 0.0
                )
        gather_cost = (
            plan.cost_subband
            if plan.engine == "subband"
            else plan.cost_exact
        )
        plan.matmul_candidate = (
            plan.cost_matmul <= MATMUL_RACE_SLACK * max(1.0, gather_cost)
        )
        return plan
