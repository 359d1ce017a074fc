"""Candidate model (reference: include/data_types/candidates.hpp).

A Candidate carries the detection parameters plus a recursive ``assoc``
list of weaker detections absorbed by the distillers; folding adds
folded_snr / opt_period / fold. CandidatePOD is the 24-byte on-disk
record of candidates.peasoup (candidates.hpp:10-17).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# struct CandidatePOD {float dm; int dm_idx; float acc; int nh; float snr; float freq;}
CANDIDATE_POD_DTYPE = np.dtype(
    [
        ("dm", "<f4"),
        ("dm_idx", "<i4"),
        ("acc", "<f4"),
        ("nh", "<i4"),
        ("snr", "<f4"),
        ("freq", "<f4"),
    ]
)


@dataclass
class Candidate:
    dm: float = 0.0
    dm_idx: int = 0
    acc: float = 0.0
    nh: int = 0
    snr: float = 0.0
    freq: float = 0.0
    folded_snr: float = 0.0
    opt_period: float = 0.0
    is_adjacent: bool = False
    is_physical: bool = False
    ddm_count_ratio: float = 0.0
    ddm_snr_ratio: float = 0.0
    assoc: List["Candidate"] = field(default_factory=list)
    fold: Optional[np.ndarray] = None  # (nints, nbins) when folded

    @property
    def period(self) -> float:
        return 1.0 / self.freq

    def append(self, other: "Candidate") -> None:
        self.assoc.append(other)

    def count_assoc(self) -> int:
        return sum(1 + c.count_assoc() for c in self.assoc)

    def collect_pods(self) -> np.ndarray:
        """Flatten self + assoc tree into CandidatePOD records
        (candidates.hpp:78-84, depth-first, self first)."""
        pods: list[tuple] = []

        def walk(c: "Candidate") -> None:
            pods.append((c.dm, c.dm_idx, c.acc, c.nh, c.snr, c.freq))
            for a in c.assoc:
                walk(a)

        walk(self)
        return np.array(pods, dtype=CANDIDATE_POD_DTYPE)


@dataclass
class FdasCandidate(Candidate):
    """A periodicity candidate of the Fourier-domain acceleration search
    (pipeline/fdas.py) with its (f-dot, f-ddot) trial beside the base
    fields (the JAX package's core/candidates.py:FdasCandidate).

    ``acc`` holds the equivalent line-of-sight acceleration ``-fdot * c /
    f``, so the distillers, the folder and the writers treat an FDAS
    detection like a time-domain one; fdot and fddot keep the native
    Fourier-domain parameters (overview.xml writes them as extra
    candidate fields)."""

    fdot: float = 0.0  # Hz/s at the detection frequency
    fddot: float = 0.0  # Hz/s^2 (0 unless the jerk plane is searched)
    z: float = 0.0  # matched template drift in bins over the observation
    w: float = 0.0  # matched template curvature in bins


@dataclass
class SinglePulseCandidate:
    """One clustered single-pulse detection in the DM-time plane: the
    peak detection (dm, time, width, snr) plus the cluster's extent in
    every search dimension, so one broad pulse detected at many (DM
    trial, width, sample) cells reports as one candidate with its
    footprint. The reference searches periodicity only; the row follows
    GPU single-pulse pipelines (Heimdall/GSP), as the JAX package's
    does."""

    dm: float = 0.0
    dm_idx: int = 0
    snr: float = 0.0
    time_s: float = 0.0  # peak boxcar START time (sample * tsamp)
    sample: int = 0  # peak boxcar start sample in the dedispersed series
    width: int = 1  # matched boxcar width (samples) at the peak
    width_idx: int = 0  # index into the run's width list
    members: int = 1  # events merged into this cluster
    # cluster extent (inclusive) over the friends-of-friends members
    dm_idx_lo: int = 0
    dm_idx_hi: int = 0
    sample_lo: int = 0
    sample_hi: int = 0
    width_lo: int = 1  # narrowest member width (samples)
    width_hi: int = 1  # widest member width (samples)


class CandidateCollection:
    def __init__(self, cands: Optional[List[Candidate]] = None):
        self.cands: List[Candidate] = list(cands) if cands else []

    def append(self, other) -> None:
        if isinstance(other, CandidateCollection):
            self.cands.extend(other.cands)
        else:
            self.cands.extend(other)

    def __len__(self) -> int:
        return len(self.cands)

    def __iter__(self):
        return iter(self.cands)

    def __getitem__(self, i):
        return self.cands[i]


class SinglePulseCandidateCollection(CandidateCollection):
    """List container for SinglePulseCandidate (the base collection is
    type-agnostic; the subclass names the intent in signatures)."""
