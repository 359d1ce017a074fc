"""Candidate distillers: collapse harmonically/accelerationally/DM-related
detections onto their strongest member.

Reference: include/transforms/distiller.hpp. The algorithm sorts by S/N
descending (!IMPORTANT, distiller.hpp:31), then walks survivors in
order; each survivor's ``condition`` marks weaker related candidates
non-unique and (optionally) absorbs them into its ``assoc`` list.

Host-side by design: candidate counts are tiny relative to device work.
By default the sort and the survivor loop run in the native library
(peasoup_tpu_torch/native), whose sort replays the reference's unstable
std::sort, so exact S/N ties crown the reference's member;
``PEASOUP_NO_NATIVE=1`` selects the numpy loops below and a stable sort.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import native
from ..core.candidates import Candidate

SPEED_OF_LIGHT = 299792458.0


class BaseDistiller:
    """condition() implementations read the precomputed column arrays
    (self.freqs/accs/nhs) instead of walking the Candidate objects —
    the arrays are built once per distill() call, keeping the O(n^2)
    survivor loop in vectorised numpy."""

    def __init__(self, keep_related: bool):
        self.keep_related = keep_related
        self.freqs: np.ndarray | None = None
        self.accs: np.ndarray | None = None
        self.nhs: np.ndarray | None = None

    def condition(self, cands, idx, unique) -> None:
        raise NotImplementedError

    def _native(self):
        """(survivor mask, edge sources, edge targets) of the sorted
        columns from the native library."""
        raise NotImplementedError

    def distill(self, cands: List[Candidate]) -> List[Candidate]:
        size = len(cands)
        # The !IMPORTANT S/N-descending sort (distiller.hpp:31) is
        # std::sort, an unstable introsort whose arrangement of exactly
        # tied S/N values decides which member the distiller crowns: the
        # native library replays it. The pure-Python path sorts stably,
        # which is the same order for every distinct S/N.
        use_native = native.enabled()
        if use_native:
            perm = native.snr_sort_perm(np.array([c.snr for c in cands], dtype=np.float32))
            cands = [cands[i] for i in perm]
        else:
            cands = sorted(cands, key=lambda c: -c.snr)
        self.freqs = np.array([c.freq for c in cands], dtype=np.float64)
        self.accs = np.array([c.acc for c in cands], dtype=np.float64)
        self.nhs = np.array([c.nh for c in cands], dtype=np.int64)
        if use_native:
            unique, src, dst = self._native()
            if self.keep_related:
                for s, d in zip(src, dst):
                    cands[s].append(cands[d])
            return [c for c, u in zip(cands, unique) if u]
        unique = np.ones(size, dtype=bool)
        idx = 0
        while idx < size:
            if unique[idx]:
                self.condition(cands, idx, unique)
            idx += 1
        return [c for c, u in zip(cands, unique) if u]


class HarmonicDistiller(BaseDistiller):
    """Absorb candidates whose freq is a (fractional) harmonic of a
    stronger one (distiller.hpp:63-108)."""

    def __init__(self, tol: float, max_harm: int, keep_related: bool,
                 fractional_harms: bool = True):
        super().__init__(keep_related)
        self.tolerance = tol
        self.max_harm = int(max_harm)
        self.fractional_harms = fractional_harms

    def _native(self):
        return native.harmonic_distill(
            self.freqs, self.nhs, self.tolerance, self.max_harm,
            self.fractional_harms, self.keep_related,
        )

    def condition(self, cands, idx, unique) -> None:
        size = len(cands)
        if idx + 1 >= size:
            return
        fundi = self.freqs[idx]
        freqs = self.freqs[idx + 1 :]
        nhs = self.nhs[idx + 1 :]
        # hits counts matching (jj, kk) harmonic pairs per candidate: the
        # reference appends to assoc once PER MATCHING PAIR
        # (distiller.hpp:92-101), which feeds nassoc and the ddm ratios.
        if self.fractional_harms:
            max_denoms = np.exp2(nhs).astype(np.int64)
        else:
            max_denoms = np.ones(len(freqs), dtype=np.int64)
        max_kk = int(max_denoms.max()) if len(max_denoms) else 1
        # all kk at once per jj: ratio[k, i] = kk_k*freqs_i/(jj*fundi);
        # chunking over jj keeps the transient matrix at (max_kk, n)
        kk = np.arange(1, max_kk + 1)
        kk_valid = kk[:, None] <= max_denoms[None, :]
        hits = np.zeros(len(freqs), dtype=np.int64)
        for jj in range(1, self.max_harm + 1):
            ratio = (kk[:, None] * freqs[None, :]) / (jj * fundi)
            hits += (
                kk_valid
                & (ratio > 1 - self.tolerance)
                & (ratio < 1 + self.tolerance)
            ).sum(axis=0)
        for off in np.nonzero(hits)[0]:
            target = idx + 1 + off
            if self.keep_related:
                for _ in range(int(hits[off])):
                    cands[idx].append(cands[target])
            unique[target] = False


class AccelerationDistiller(BaseDistiller):
    """Absorb candidates within the frequency window swept by the
    acceleration difference (distiller.hpp:115-164).
    Note: +ve acceleration is away from the observer."""

    def __init__(self, tobs: float, tol: float, keep_related: bool):
        super().__init__(keep_related)
        self.tobs = tobs
        self.tobs_over_c = tobs / SPEED_OF_LIGHT
        self.tolerance = tol

    def _native(self):
        return native.accel_distill(
            self.freqs, self.accs, self.tobs_over_c, self.tolerance, self.keep_related
        )

    def condition(self, cands, idx, unique) -> None:
        size = len(cands)
        if idx + 1 >= size:
            return
        fundi_freq = self.freqs[idx]
        fundi_acc = self.accs[idx]
        edge = fundi_freq * self.tolerance
        freqs = self.freqs[idx + 1 :]
        accs = self.accs[idx + 1 :]
        delta_acc = fundi_acc - accs
        acc_freq = fundi_freq + delta_acc * fundi_freq * self.tobs_over_c
        upper_case = acc_freq > fundi_freq
        hit = np.where(
            upper_case,
            (freqs > fundi_freq - edge) & (freqs < acc_freq + edge),
            (freqs < fundi_freq + edge) & (freqs > acc_freq - edge),
        )
        for off in np.nonzero(hit)[0]:
            target = idx + 1 + off
            if self.keep_related:
                cands[idx].append(cands[target])
            unique[target] = False


class DMDistiller(BaseDistiller):
    """Plain frequency-ratio matching across DM trials
    (distiller.hpp:168-197)."""

    def __init__(self, tol: float, keep_related: bool):
        super().__init__(keep_related)
        self.tolerance = tol

    def _native(self):
        return native.dm_distill(self.freqs, self.tolerance, self.keep_related)

    def condition(self, cands, idx, unique) -> None:
        size = len(cands)
        if idx + 1 >= size:
            return
        fundi = self.freqs[idx]
        ratio = self.freqs[idx + 1 :] / fundi
        hit = (ratio > 1 - self.tolerance) & (ratio < 1 + self.tolerance)
        for off in np.nonzero(hit)[0]:
            target = idx + 1 + off
            if self.keep_related:
                cands[idx].append(cands[target])
            unique[target] = False
