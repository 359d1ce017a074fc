"""Golden-recall comparator: our candidates vs the reference CUDA run (the
port's copy of the JAX package's tools/recall.py, over the port's
tools/parsers.py).

The reference ships a golden end-to-end run of tutorial.fil
(``example_output/{overview.xml,candidates.peasoup}`` in the reference's
checkout: 10 candidates from `peasoup -i tutorial.fil --dm_end 250
--acc_start -5 --acc_end 5 --npdmp 10 -p`). This module matches two
candidate tables field by field with explicit tolerances and reports
per-golden-candidate deltas, so "matching the reference" is a
measurement, not a claim.

Matching semantics: a golden candidate is *recalled* when our list has
an entry whose spin frequency agrees within `freq_tol` (relative, the
reference's own --freq_tol default is 1e-4; we default looser to absorb
distill path differences) and whose DM agrees within `dm_tol` (the DM
trial lists are generated by the same tolerance walk so trial values
coincide to float precision).  Acceleration, harmonic level, and S/N
deltas are reported but gated separately: small numeric differences can
legitimately shift which (acc, nh) member of a candidate's association
cluster the distillers crown as the winner (distiller.hpp:31 sorts by
S/N and absorbs the rest).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .parsers import OverviewFile

# the golden overview, relative to a checkout of the reference
GOLDEN_OVERVIEW = "example_output/overview.xml"


@dataclass
class CandidateMatch:
    """Best match in our list for one golden candidate."""

    golden_idx: int
    golden_period: float
    golden_dm: float
    golden_acc: float
    golden_nh: int
    golden_snr: float
    matched: bool
    our_idx: int = -1
    our_rank: int = -1  # position in our S/N-sorted list
    dfreq_rel: float = np.inf
    ddm: float = np.inf
    dacc: float = np.inf
    dnh: int = 0
    dsnr_rel: float = np.inf


@dataclass
class RecallReport:
    recall: float
    n_golden: int
    n_ours: int
    matches: list = field(default_factory=list)
    snr_ok_frac: float = 0.0  # matched AND S/N within snr_rtol

    def summary(self) -> str:
        lines = [
            f"golden recall: {self.recall:.0%} "
            f"({sum(m.matched for m in self.matches)}/{self.n_golden} golden "
            f"candidates recovered from our {self.n_ours})",
            " idx  P_golden[s]    dm      acc  nh   snr   | matched "
            "rank dfreq_rel   ddm    dacc  dnh  dsnr_rel",
        ]
        for m in self.matches:
            if m.matched:
                tail = (
                    f"yes    {m.our_rank:3d} {m.dfreq_rel:9.2e} "
                    f"{m.ddm:6.3f} {m.dacc:6.2f} {m.dnh:4d} {m.dsnr_rel:+8.3f}"
                )
            else:
                tail = "NO"
            lines.append(
                f"  {m.golden_idx:2d} {m.golden_period:.9f} {m.golden_dm:7.2f} "
                f"{m.golden_acc:6.2f} {m.golden_nh:3d} {m.golden_snr:6.1f} | {tail}"
            )
        return "\n".join(lines)


def _as_table(cands) -> np.ndarray:
    """Accept an OverviewFile, a path, or a recarray with the CAND fields."""
    if isinstance(cands, str):
        cands = OverviewFile(cands)
    if isinstance(cands, OverviewFile):
        cands = cands.candidates
    return cands


def match_golden(
    ours,
    golden=GOLDEN_OVERVIEW,
    freq_tol: float = 1e-3,
    dm_tol: float = 0.05,
    snr_rtol: float = 0.25,
) -> RecallReport:
    """Match our candidate table against the golden one.

    ours/golden: overview.xml path, OverviewFile, or candidate recarray.
    """
    ours = _as_table(ours)
    golden = _as_table(golden)

    our_p = ours["period"].astype(np.float64)
    our_f = 1.0 / our_p
    matches = []
    for gi, g in enumerate(golden):
        gf = 1.0 / float(g["period"])
        dfreq = np.abs(our_f / gf - 1.0)
        ddm = np.abs(ours["dm"].astype(np.float64) - float(g["dm"]))
        ok = (dfreq < freq_tol) & (ddm < dm_tol)
        m = CandidateMatch(
            golden_idx=gi,
            golden_period=float(g["period"]),
            golden_dm=float(g["dm"]),
            golden_acc=float(g["acc"]),
            golden_nh=int(g["nh"]),
            golden_snr=float(g["snr"]),
            matched=bool(ok.any()),
        )
        if m.matched:
            cand_idx = np.flatnonzero(ok)
            # best = closest in frequency, ties broken by S/N
            best = cand_idx[np.lexsort((-ours["snr"][cand_idx], dfreq[cand_idx]))][0]
            m.our_idx = int(best)
            m.our_rank = int(best)  # our tables are written S/N-sorted
            m.dfreq_rel = float(dfreq[best])
            m.ddm = float(ours["dm"][best] - g["dm"])
            m.dacc = float(ours["acc"][best] - g["acc"])
            m.dnh = int(ours["nh"][best]) - int(g["nh"])
            m.dsnr_rel = float(ours["snr"][best] / g["snr"] - 1.0)
        matches.append(m)

    n_matched = sum(m.matched for m in matches)
    n_snr_ok = sum(
        m.matched and abs(m.dsnr_rel) < snr_rtol for m in matches
    )
    return RecallReport(
        recall=n_matched / max(len(matches), 1),
        n_golden=len(matches),
        n_ours=len(ours),
        matches=matches,
        snr_ok_frac=n_snr_ok / max(len(matches), 1),
    )
