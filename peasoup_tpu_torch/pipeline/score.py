"""Candidate scoring heuristics (reference: include/transforms/scorer.hpp).

Adds is_physical (period above the per-channel DM smear), is_adjacent
(assoc spans neighbouring DM trials), and the fraction of associated
hits (count- and S/N-weighted) inside the expected DM width of the
fundamental.
"""

from __future__ import annotations

from typing import List

from ..core.candidates import Candidate


class CandidateScorer:
    def __init__(self, tsamp: float, cfreq: float, foff: float, bw: float):
        ftop = cfreq + bw / 2.0
        fbottom = cfreq - bw / 2.0
        self.tdm_chan_partial = 8300.0 * foff / cfreq**3
        self.tdm_band_partial = 4150.0 * (1.0 / fbottom**2 - 1.0 / ftop**2)

    def score(self, cand: Candidate) -> None:
        cand.is_physical = bool(
            1.0 / cand.freq > cand.dm * self.tdm_chan_partial
        )
        # adjacency: any assoc at dm_idx +/- 1, or all at the same dm_idx
        idx = cand.dm_idx
        adjacent = False
        unique = True
        for a in cand.assoc:
            if a.dm_idx != idx:
                unique = False
            if a.dm_idx in (idx + 1, idx - 1):
                adjacent = True
                break
        cand.is_adjacent = bool(adjacent or unique)
        # delta-DM ratios (scorer.hpp:47-65)
        ddm = 1.0 / (cand.freq * self.tdm_band_partial)
        inside_count = total_count = 1
        inside_snr = total_snr = cand.snr
        for a in cand.assoc:
            total_count += 1
            total_snr += a.snr
            if abs(cand.dm - a.dm) <= ddm:
                inside_count += 1
                inside_snr += a.snr
        cand.ddm_count_ratio = inside_count / total_count
        cand.ddm_snr_ratio = inside_snr / total_snr

    def score_all(self, cands: List[Candidate]) -> None:
        for c in cands:
            self.score(c)
