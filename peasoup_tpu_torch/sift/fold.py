"""Survey folding: every campaign candidate through fixed-width batches.

The per-observation :class:`~peasoup_tpu_torch.pipeline.folder.MultiFolder`
folds the top handful of one observation's candidates. At campaign scale
the folding workload is the union over the whole database, thousands of
candidates over observations of several lengths. This folder (the JAX
package's sift/fold.py):

- derives each observation's fold geometry with the folder's own
  :func:`~peasoup_tpu_torch.pipeline.folder.fold_geometry`, so every
  candidate's result is bitwise the per-observation folder's
  (tests/test_torch_sift.py; on the card, chip_smoke.py phase 24);
- dereddens each needed (observation, DM trial) series once, on the
  device that holds the trials;
- packs candidates into fixed-width batches per shape bucket (the
  power-of-two series length) through
  :func:`~peasoup_tpu_torch.ops.survey_fold.survey_fold_batch`, padding
  the last batch by recycling its rows, then optimises every fold in
  batches of the same width;
- halves the batch and retries the same rows when the card runs out of
  memory, and raises at batch 1. Rows are independent, so the halved
  batches give the same bits. Each halving is a step of the
  ``sift.fold`` DegradationLadder, the ``device.oom`` fault seam fires at
  each batch, and each shape bucket records ``sift_fold_bucket``, as in
  the JAX package.

In a run of several processes,
:func:`peasoup_tpu_torch.parallel.multihost.run_survey_fold` deals the
observations round-robin to the processes, each folds its share with this
folder, and the outcomes are exchanged.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..obs.log import get_logger
from ..obs.telemetry import current as current_telemetry
from ..ops.fold import fold_bins_np
from ..ops.fold_optimise import FoldOptimiser
from ..ops.resample import accel_factor
from ..ops.survey_fold import survey_fold_batch
from ..pipeline.folder import _deredden_tim, fold_geometry
from ..pipeline.search import _is_oom, _release
from ..resilience import DegradationLadder, faults

log = get_logger("sift.fold")


@dataclasses.dataclass
class FoldCandidate:
    """One candidate to fold: ``dm_row`` indexes the observation's
    ``trials``; ``key`` is the caller's identity for it (the database's
    candidate id), carried through to the outcome."""

    key: object
    period: float
    acc: float
    dm_row: int


@dataclasses.dataclass
class FoldObservation:
    """One observation's fold input: dedispersed trials (u8, one row per
    needed DM: a tensor, folded on its device, or numpy, folded on the
    CPU) and the candidates that refer to them."""

    job_id: str
    trials: object  # (nrows, >= trials_nsamps) u8
    trials_nsamps: int
    tsamp: float
    cands: List[FoldCandidate] = dataclasses.field(default_factory=list)


class SurveyFolder:
    """Batched cross-observation folding in fixed-width batches."""

    # the per-observation folder's physicality gates
    min_period = 1e-3
    max_period = 10.0

    def __init__(self, nbins: int = 64, nints: int = 16, batch: int = 64) -> None:
        self.nbins = int(nbins)
        self.nints = int(nints)
        self.batch = int(batch)
        self.optimiser = FoldOptimiser(self.nbins, self.nints)
        # each shape bucket of the last pass: its series length, candidates
        # and the batch width it finished at
        self.buckets: list[dict] = []

    def _plan(self, observations: List[FoldObservation]):
        """Foldable candidates by shape bucket: {size: [(obs_idx, cand)]},
        and each observation's fold geometry."""
        geoms = []
        buckets: dict[int, list] = {}
        for oi, obs in enumerate(observations):
            geom = fold_geometry(obs.trials_nsamps, obs.tsamp)
            geoms.append(geom)
            for cand in obs.cands:
                if not self.min_period < cand.period < self.max_period:
                    continue
                if not 0 <= cand.dm_row < len(obs.trials):
                    continue
                buckets.setdefault(geom[0], []).append((oi, cand))
        return buckets, geoms

    def fold_outcomes(self, observations: List[FoldObservation]) -> list[dict]:
        """Fold + optimise every foldable candidate. Returns one outcome
        per candidate: ``key``, ``job_id``, ``opt_sn``, ``opt_period``,
        ``opt_fold`` (nints, nbins), ``opt_prof``, ``period``, ``tobs``."""
        tel = current_telemetry()
        buckets, geoms = self._plan(observations)
        self.buckets = []
        ladder = DegradationLadder("sift.fold", ("batch_shrink",))
        batch = self.batch
        all_folds: list[torch.Tensor] = []
        all_meta: list[tuple] = []  # (obs_idx, cand, tobs)
        for size in sorted(buckets):
            entries = buckets[size]
            # each needed (obs, dm_row) dereddened once; the cache lives for
            # the bucket only, so the device holds one bucket's series
            xd_cache: dict[tuple[int, int], torch.Tensor] = {}
            keys = []
            afs = np.empty(len(entries), dtype=np.float32)
            used = self.nints * (size // self.nints)
            bins = np.empty((len(entries), used), dtype=np.int32)
            for i, (oi, cand) in enumerate(entries):
                _, tsamp32, _, pos5, pos25 = geoms[oi]
                ck = (oi, cand.dm_row)
                if ck not in xd_cache:
                    tim = observations[oi].trials[cand.dm_row]
                    if isinstance(tim, np.ndarray):
                        tim = torch.from_numpy(tim)
                    xd_cache[ck] = _deredden_tim(tim, size=size, pos5=pos5, pos25=pos25)
                keys.append(ck)
                # (a*tsamp) is an f32 product in the reference's launcher;
                # accel_factor replays it (the folder's idiom)
                afs[i] = accel_factor(np.asarray([cand.acc]), tsamp32).astype(np.float32)[0]
                bins[i] = fold_bins_np(size, tsamp32, cand.period, self.nbins, self.nints)
            dev = xd_cache[keys[0]].device

            lo = 0
            while lo < len(entries):
                hi = min(lo + batch, len(entries))
                n = hi - lo
                # fixed batch width: the last batch recycles its own rows
                # (dropped below); rows are independent
                pad_idx = np.arange(batch) % n + lo
                try:
                    faults.fire("device.oom", context=f"sift.fold:{size}:{lo}")
                    folds = survey_fold_batch(
                        torch.stack([xd_cache[keys[j]] for j in pad_idx]),
                        torch.from_numpy(afs[pad_idx]).to(dev),
                        torch.from_numpy(bins[pad_idx]).to(dev),
                        nbins=self.nbins, nints=self.nints,
                    )[:n]
                except Exception as exc:
                    if not _is_oom(exc):
                        raise
                    if batch <= 1:
                        ladder.exhausted(batch=batch, error=f"{exc!s:.200}")
                        raise
                    log.warning("survey fold out of memory at batch %d (bucket %d, "
                                "row %d): halving to %d", batch, size, lo, batch // 2)
                    ladder.step("batch_shrink", batch_old=batch, batch_new=batch // 2,
                                error=f"{exc!s:.200}")
                    batch //= 2
                    _release(dev)
                    continue  # the same rows at the smaller batch
                all_folds.append(folds)
                all_meta.extend((oi, cand, geoms[oi][2]) for oi, cand in entries[lo:hi])
                lo = hi
            del xd_cache
            self.buckets.append({"size": int(size), "candidates": len(entries),
                                 "batch": int(batch)})
            tel.event("sift_fold_bucket", size=int(size), candidates=len(entries),
                      batch=int(batch))

        if not all_meta:
            return []
        folds = torch.cat(all_folds)
        periods = np.asarray([c.period for _, c, _ in all_meta], dtype=np.float64)
        tobs = np.asarray([t for _, _, t in all_meta], dtype=np.float64)

        # optimise in the same fixed batch width (recycled-row padding)
        outcomes: list[dict] = []
        lo = 0
        while lo < len(all_meta):
            hi = min(lo + batch, len(all_meta))
            n = hi - lo
            pad_idx = np.arange(batch) % n + lo
            results = self.optimiser.optimise(
                folds[torch.from_numpy(pad_idx).to(folds.device)],
                periods[pad_idx], tobs[pad_idx],
            )[:n]
            for (oi, cand, t), res in zip(all_meta[lo:hi], results):
                outcomes.append({
                    "key": cand.key,
                    "job_id": observations[oi].job_id,
                    "opt_sn": res["opt_sn"],
                    "opt_period": res["opt_period"],
                    "opt_fold": res["opt_fold"],
                    "opt_prof": res["opt_prof"],
                    # consumers gate how far to trust the period refinement
                    # on how many pulses the observation spans
                    "period": float(cand.period),
                    "tobs": float(t),
                })
            lo = hi
        return outcomes
