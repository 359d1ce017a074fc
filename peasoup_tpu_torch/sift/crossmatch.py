"""Known-pulsar cross-match with harmonic / sub-harmonic ladders.

A blind periodicity search detects a known pulsar not just at its
fundamental: harmonics (P0/n), sub-harmonics (m*P0) and rational
combinations (m/n * P0) all cross the threshold (the GSP pipeline's
known-source filter, arXiv:2110.12749). The match therefore walks a
rational ladder: a candidate period matching ``(num/den) * P0`` within
a fractional tolerance, at a compatible DM, is the catalogue source —
and the ladder identity (e.g. ``1/2`` = second harmonic) is recorded
so a survey team can see *how* the source aliased.

The port ships its own copy of the JAX package's convenience catalogue,
``sift/data/known_pulsars.json`` beside this module; a survey substitutes
its own psrcat export in the same shape. ``peasoup_tpu.known_pulsars``
names that file format, which both packages share.
"""

from __future__ import annotations

import json
import math
import os

from ..obs.log import get_logger

log = get_logger("sift.crossmatch")

CATALOGUE_SCHEMA = "peasoup_tpu.known_pulsars"

DEFAULT_CATALOGUE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data",
    "known_pulsars.json",
)


def load_catalogue(path: str | None = None) -> list[dict]:
    """Load + validate an ephemeris catalogue. A malformed catalogue
    fails loudly — silently matching against garbage would launder
    every real candidate into a 'known source'."""
    path = path or DEFAULT_CATALOGUE
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != CATALOGUE_SCHEMA:
        raise ValueError(
            f"{path}: not a {CATALOGUE_SCHEMA} catalogue "
            f"(schema={doc.get('schema')!r})"
        )
    pulsars = doc.get("pulsars")
    if not isinstance(pulsars, list) or not pulsars:
        raise ValueError(f"{path}: empty or missing 'pulsars' list")
    for p in pulsars:
        if (
            not isinstance(p.get("name"), str)
            or not isinstance(p.get("period_s"), (int, float))
            or not isinstance(p.get("dm"), (int, float))
            or p["period_s"] <= 0
        ):
            raise ValueError(
                f"{path}: bad catalogue entry {p!r} (want name, "
                "period_s > 0, dm)"
            )
    return pulsars


def harmonic_identify(
    p_cand: float,
    p_ref: float,
    *,
    max_harm: int = 16,
    tol: float = 2e-3,
) -> tuple[int, int, float] | None:
    """Identify ``p_cand ~= (num/den) * p_ref`` over the reduced
    rational ladder with num, den <= max_harm. Returns the
    lowest-error ``(num, den, frac_err)`` or None. ``den > 1`` rows
    are harmonics (the candidate spins faster than the reference),
    ``num > 1`` sub-harmonics."""
    if p_cand <= 0 or p_ref <= 0:
        return None
    best: tuple[int, int, float] | None = None
    r = p_cand / p_ref
    for den in range(1, max_harm + 1):
        # only the nearest numerators for this denominator can win
        for num in {
            max(1, math.floor(r * den)), math.ceil(r * den),
        }:
            if num > max_harm or math.gcd(num, den) != 1:
                continue
            pred = num / den
            err = abs(r - pred) / pred
            if err <= tol and (best is None or err < best[2]):
                best = (num, den, err)
    return best


def match_candidate(
    period: float,
    dm: float,
    catalogue: list[dict],
    *,
    max_harm: int = 16,
    period_tol: float = 2e-3,
    dm_tol: float = 2.0,
    dm_tol_frac: float = 0.05,
) -> dict | None:
    """Best catalogue match for one candidate, or None.

    The DM gate is ``max(dm_tol, dm_tol_frac * psr_dm)`` — absolute at
    low DM (trial grids are coarse there), fractional at high DM.
    Among DM-compatible pulsars the lowest-fractional-error rung wins.
    """
    best: dict | None = None
    for psr in catalogue:
        gate = max(float(dm_tol), float(dm_tol_frac) * float(psr["dm"]))
        dm_err = abs(float(dm) - float(psr["dm"]))
        if dm_err > gate:
            continue
        rung = harmonic_identify(
            float(period), float(psr["period_s"]),
            max_harm=max_harm, tol=period_tol,
        )
        if rung is None:
            continue
        num, den, err = rung
        if best is None or err < best["period_frac_err"]:
            best = {
                "psr": str(psr["name"]),
                "psr_period": float(psr["period_s"]),
                "psr_dm": float(psr["dm"]),
                "harmonic": f"{num}/{den}",
                "period_frac_err": float(err),
                "dm_err": float(dm_err),
            }
    return best
