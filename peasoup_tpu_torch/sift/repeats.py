"""Repeat single-pulse association + RRAT period inference.

A rotating radio transient (RRAT) shows up as isolated single pulses
in many observations at one DM; the campaign database is the first
place those detections sit side by side. Two steps (the GSP/CRAFTS
repeat-source association, arXiv:2110.12749):

1. **association** — cluster single-pulse candidates across
   observations by DM proximity (and pointing, when positions are
   recorded): a chain-clustering sweep over the DM-sorted rows.

2. **period inference** — pulse arrival times of a rotator differ by
   integer multiples of the spin period, so the period is (close to)
   the greatest common divisor of the TOA differences. The classic
   trial-divisor GCD fit: take the smallest difference, try P =
   d_min/k for k = 1, 2, ..., keep the largest P whose worst phase
   residual over ALL differences stays inside the tolerance, then
   refine by least squares over the implied turn counts.
"""

from __future__ import annotations

import numpy as np

from ..obs.log import get_logger
from .dedup import position_gate_ok

log = get_logger("sift.repeats")

SECONDS_PER_DAY = 86400.0


def _split_by_position(
    group: list[dict], pos_tol_deg: float
) -> list[list[dict]]:
    """Partition one DM cluster by sky position: greedy anchoring —
    the first unassigned row seeds a source, every row passing the
    position gate against that anchor joins it (rows without recorded
    positions always pass). One DM coincidence across opposite sky
    poles is not one repeating source."""
    out: list[list[dict]] = []
    remaining = list(group)
    while remaining:
        anchor = remaining[0]
        sub = [
            r for r in remaining
            if position_gate_ok(anchor, r, pos_tol_deg)
        ]
        sub_ids = {id(r) for r in sub}
        remaining = [r for r in remaining if id(r) not in sub_ids]
        out.append(sub)
    return out


def associate_repeats(
    sp_cands: list[dict],
    *,
    dm_tol: float = 1.0,
    min_pulses: int = 3,
    min_obs: int = 2,
    pos_tol_deg: float = 0.0,
) -> list[list[dict]]:
    """Cluster single-pulse rows (needing ``dm``, ``job_id``) into
    repeat-source groups: DM chain clustering (adjacent-in-DM rows
    within ``dm_tol`` join one cluster), each cluster then split by
    sky position when ``pos_tol_deg > 0`` (rows need
    ``src_raj``/``src_dej``; missing positions never gate), kept when
    the cluster spans at least ``min_obs`` observations and
    ``min_pulses`` pulses."""
    rows = sorted(sp_cands, key=lambda c: float(c["dm"]))
    groups: list[list[dict]] = []
    cur: list[dict] = []
    for r in rows:
        if cur and float(r["dm"]) - float(cur[-1]["dm"]) > dm_tol:
            groups.append(cur)
            cur = []
        cur.append(r)
    if cur:
        groups.append(cur)
    if pos_tol_deg > 0:
        groups = [
            sub
            for g in groups
            for sub in _split_by_position(g, pos_tol_deg)
        ]
    return [
        g
        for g in groups
        if len(g) >= min_pulses
        and len({r["job_id"] for r in g}) >= min_obs
    ]


def toas_seconds(group: list[dict]) -> np.ndarray:
    """Pulse arrival times on a common clock (seconds since the
    earliest observation start): MJD ``obs_tstart`` plus the in-
    observation ``time_s``."""
    t0 = min(float(r["obs_tstart"]) for r in group)
    return np.sort(
        np.asarray(
            [
                (float(r["obs_tstart"]) - t0) * SECONDS_PER_DAY
                + float(r["time_s"])
                for r in group
            ],
            dtype=np.float64,
        )
    )


def infer_period(
    toas: np.ndarray,
    *,
    min_period: float = 0.05,
    max_harm: int = 1000,
    phase_tol: float = 0.02,
) -> tuple[float, float] | None:
    """TOA-difference GCD fit. Returns ``(period_s, worst_phase_resid)``
    or None when no period under the tolerance exists in the ladder.

    The candidate ladder divides the SMALLEST difference (the most
    constraining one); a trial survives when every difference sits
    within ``phase_tol`` turns of an integer multiple. The largest
    surviving period wins (k smallest) — sub-multiples of the true
    period always survive too, so the search stops at the first hit —
    and a least-squares refinement over the implied turn counts
    (``P = sum(n*d)/sum(n^2)``) polishes it.
    """
    toas = np.sort(np.asarray(toas, dtype=np.float64))
    diffs = np.diff(toas)
    diffs = diffs[diffs > 1e-6]
    if diffs.size == 0:
        return None
    base = float(diffs.min())
    for k in range(1, max_harm + 1):
        p = base / k
        if p < min_period:
            break
        turns = np.rint(diffs / p)
        if np.any(turns < 1):
            continue
        resid = np.abs(diffs / p - turns)
        if float(resid.max()) > phase_tol:
            continue
        # refine: best P for these integer turn counts
        p_ref = float(np.sum(turns * diffs) / np.sum(turns * turns))
        turns2 = np.rint(diffs / p_ref)
        resid2 = float(np.abs(diffs / p_ref - turns2).max())
        return p_ref, resid2
    return None


def repeat_sources(
    sp_cands: list[dict],
    *,
    dm_tol: float = 1.0,
    min_pulses: int = 3,
    min_obs: int = 2,
    min_period: float = 0.05,
    max_harm: int = 1000,
    phase_tol: float = 0.02,
    pos_tol_deg: float = 0.0,
) -> list[dict]:
    """The full pass: associate + infer. Returns one source dict per
    repeat group (period fields None when the GCD fit found nothing —
    a sporadic repeater is still worth a catalogue row)."""
    sources = []
    for group in associate_repeats(
        sp_cands, dm_tol=dm_tol, min_pulses=min_pulses,
        min_obs=min_obs, pos_tol_deg=pos_tol_deg,
    ):
        toas = toas_seconds(group)
        fit = infer_period(
            toas, min_period=min_period, max_harm=max_harm,
            phase_tol=phase_tol,
        )
        dms = np.asarray([float(r["dm"]) for r in group])
        snrs = np.asarray([float(r.get("snr") or 0.0) for r in group])
        sources.append(
            {
                "dm": float(np.median(dms)),
                "n_obs": len({r["job_id"] for r in group}),
                "n_pulses": len(group),
                "best_snr": float(snrs.max()),
                "period_s": None if fit is None else float(fit[0]),
                "period_frac_resid": (
                    None if fit is None else float(fit[1])
                ),
                "job_ids": sorted({r["job_id"] for r in group}),
                "toas_s": [round(float(t), 6) for t in toas],
                "member_ids": [r["id"] for r in group],
            }
        )
    log.info(
        "repeat single-pulse association: %d source(s) from %d "
        "detections", len(sources), len(sp_cands),
    )
    return sources
