"""Campaign-level dedup + multi-beam coincidence vetoing.

Two sifting passes over the joined candidate set:

- **harmonic/DM dedup across observations** — the per-observation
  distillers already folded harmonics *within* one observation; a
  campaign re-detects the same source in many observations (and at
  different harmonics when the S/N ladder differs). Greedy
  association, strongest candidate first: anything harmonically
  related within a DM gate joins the leader's catalogue row, so the
  survey catalogue carries one row per sky source with its detection
  history.

- **multi-beam coincidence veto** — terrestrial RFI enters many beams
  at once, a real pulsar enters one (or a neighbouring few). The veto
  re-uses the port's coincidence op
  (:func:`peasoup_tpu_torch.ops.coincidence.coincidence_mask`) over a
  (beam, period-DM cell) S/N matrix built from the database: cells
  where ``beam_thresh`` or more distinct beams exceed the threshold
  are flagged RFI.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..device import resolve_device
from ..ops.coincidence import coincidence_mask
from .crossmatch import harmonic_identify

log = logging.getLogger("peasoup_tpu_torch.sift.dedup")


def packed_position_deg(
    raj: float, dej: float
) -> tuple[float, float]:
    """Sigproc packed ``HHMMSS.s`` / ``DDMMSS.s`` header position ->
    ``(ra_deg, dec_deg)``."""
    sign = -1.0 if dej < 0 else 1.0
    a = abs(float(raj))
    hh = int(a // 10000)
    mm = int((a - hh * 10000) // 100)
    ss = a - hh * 10000 - mm * 100
    d = abs(float(dej))
    dd = int(d // 10000)
    dmm = int((d - dd * 10000) // 100)
    dss = d - dd * 10000 - dmm * 100
    return (
        (hh + mm / 60.0 + ss / 3600.0) * 15.0,
        sign * (dd + dmm / 60.0 + dss / 3600.0),
    )


def sky_separation_deg(
    ra1: float, dec1: float, ra2: float, dec2: float
) -> float:
    """Great-circle angular separation (haversine) in degrees."""
    r1, d1, r2, d2 = (
        math.radians(v) for v in (ra1, dec1, ra2, dec2)
    )
    s = (
        math.sin((d2 - d1) / 2.0) ** 2
        + math.cos(d1) * math.cos(d2)
        * math.sin((r2 - r1) / 2.0) ** 2
    )
    return math.degrees(2.0 * math.asin(min(1.0, math.sqrt(s))))


def _row_position_deg(c: dict) -> tuple[float, float] | None:
    """A row's sky position in degrees, or None when the observation
    recorded none (rows without positions are never position-gated)."""
    raj, dej = c.get("src_raj"), c.get("src_dej")
    if raj is None or dej is None:
        return None
    return packed_position_deg(float(raj), float(dej))


def position_gate_ok(a: dict, b: dict, pos_tol_deg: float) -> bool:
    """Whether two rows may associate under the sky-position gate: a
    disabled gate (``pos_tol_deg <= 0``) or a missing position on
    either side always passes; otherwise the great-circle separation
    must stay within tolerance — a harmonic coincidence between
    antipodal pointings is not one pulsar."""
    if pos_tol_deg <= 0:
        return True
    pa, pb = _row_position_deg(a), _row_position_deg(b)
    if pa is None or pb is None:
        return True
    return sky_separation_deg(*pa, *pb) <= pos_tol_deg


def dedup_candidates(
    cands: list[dict],
    *,
    max_harm: int = 8,
    period_tol: float = 2e-3,
    dm_tol: float = 2.0,
    pos_tol_deg: float = 0.0,
) -> list[dict]:
    """Associate harmonically-related candidates across observations.

    ``cands`` rows need ``id``, ``job_id``, ``period`` (the effective
    one — opt_period when folded), ``dm``, ``snr``, and optionally
    ``src_raj``/``src_dej`` (sigproc packed) for the sky-position gate
    (``pos_tol_deg > 0``: members beyond that separation from the
    leader never merge; rows without positions always pass). Returns
    one group dict per distinct source: ``leader`` (the highest-S/N
    member),
    ``members`` (every absorbed row, leader included), ``n_obs``
    (distinct observations), ``job_ids`` and, when the leader absorbed
    a non-fundamental detection, the member's ladder identity.
    """
    order = sorted(
        cands, key=lambda c: (-float(c.get("snr") or 0.0), c["id"])
    )
    claimed: set = set()
    groups: list[dict] = []
    for lead in order:
        if lead["id"] in claimed:
            continue
        claimed.add(lead["id"])
        members = [dict(lead, harmonic="1/1")]
        for other in order:
            if other["id"] in claimed:
                continue
            if abs(float(other["dm"]) - float(lead["dm"])) > dm_tol:
                continue
            if not position_gate_ok(lead, other, pos_tol_deg):
                continue
            rung = harmonic_identify(
                float(other["period"]), float(lead["period"]),
                max_harm=max_harm, tol=period_tol,
            )
            if rung is None:
                continue
            num, den, _ = rung
            claimed.add(other["id"])
            members.append(dict(other, harmonic=f"{num}/{den}"))
        job_ids = sorted({m["job_id"] for m in members})
        groups.append(
            {
                "leader": lead,
                "members": members,
                "n_obs": len(job_ids),
                "job_ids": job_ids,
            }
        )
    return groups


def _cell_key(
    period: float, dm: float, period_tol: float, dm_cell: float
) -> tuple[int, int]:
    """Quantise (period, DM) into a coincidence cell: log-period bins
    of width ~2*period_tol (two detections of one signal land within a
    bin or its neighbour; the veto is statistical, not exact), linear
    DM bins of dm_cell."""
    return (
        int(round(math.log(max(period, 1e-9)) / (2.0 * period_tol))),
        int(round(dm / max(dm_cell, 1e-6))),
    )


def multibeam_veto(
    cands: list[dict],
    *,
    snr_thresh: float = 6.0,
    beam_thresh: int = 4,
    period_tol: float = 2e-3,
    dm_cell: float = 2.0,
    device: str | torch.device = "cuda",
) -> set:
    """Candidate ids vetoed as multi-beam RFI.

    ``cands`` rows need ``id``, ``period``, ``dm``, ``snr`` and
    ``beam`` (observation provenance; rows with no beam recorded are
    never vetoed). Builds the (beam, cell) best-S/N matrix and keeps
    cells where :func:`coincidence_mask`, run on ``device`` (the card
    unless the caller asks for the CPU), says fewer than ``beam_thresh``
    beams fired."""
    device = resolve_device(device)

    beams = sorted(
        {int(c["beam"]) for c in cands if c.get("beam")}
    )
    if len(beams) < max(2, int(beam_thresh)):
        return set()  # veto needs enough distinct beams to vote
    beam_row = {b: i for i, b in enumerate(beams)}
    cells: dict[tuple[int, int], list[dict]] = {}
    for c in cands:
        if not c.get("beam"):
            continue
        key = _cell_key(
            float(c["period"]), float(c["dm"]), period_tol, dm_cell
        )
        cells.setdefault(key, []).append(c)
    if not cells:
        return set()
    keys = sorted(cells)
    mat = np.zeros((len(beams), len(keys)), dtype=np.float32)
    for j, key in enumerate(keys):
        for c in cells[key]:
            i = beam_row[int(c["beam"])]
            mat[i, j] = max(mat[i, j], float(c.get("snr") or 0.0))
    keep = coincidence_mask(
        torch.from_numpy(mat).to(device),
        float(np.float32(snr_thresh)),
        int(beam_thresh),
    ).cpu().numpy()
    vetoed: set = set()
    for j, key in enumerate(keys):
        if keep[j] < 0.5:
            vetoed.update(c["id"] for c in cells[key])
    if vetoed:
        log.info(
            "multi-beam veto: %d candidates in %d cells flagged RFI "
            "(>= %d of %d beams above S/N %.1f)",
            len(vetoed), int((keep < 0.5).sum()), beam_thresh,
            len(beams), snr_thresh,
        )
    return vetoed
