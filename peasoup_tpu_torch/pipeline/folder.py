"""Fold + optimise the top candidates (the reference's MultiFolder,
include/transforms/folder.hpp:337-442).

Candidates are grouped by DM trial; each needed trial is dereddened
once on the device that holds the dedispersed trials, then all of that
trial's candidates are resampled and folded in one batch, and every fold
across all groups is optimised in a single FoldOptimiser pass — versus
the reference's strictly sequential per-candidate fold+optimise loop.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.candidates import Candidate
from ..ops.fold import fold_bins_np, fold_time_series
from ..ops.fold_optimise import NBINS, NINTS, FoldOptimiser
from ..ops.rednoise import whiten_fseries
from ..ops.resample import accel_factor, resample_accel_quadratic
from ..plan.fft_plan import prev_power_of_two


def _deredden_tim(tim: torch.Tensor, *, size: int, pos5: int, pos25: int) -> torch.Tensor:
    """u8 trial -> dereddened f32 time series, scaled like the
    reference's unnormalised inverse FFT (x size) so fold amplitudes
    match the CUDA output files (folder.hpp:382-389)."""
    fser = whiten_fseries(tim[:size], pos5=pos5, pos25=pos25)
    return torch.fft.irfft(fser, n=size, dim=-1) * size


def fold_geometry(
    trials_nsamps: int,
    tsamp: float,
    pos5_freq: float = 0.05,
    pos25_freq: float = 0.5,
) -> tuple[int, float, float, int, int]:
    """(size, tsamp_f32, tobs, pos5, pos25) for one observation's fold:
    the power-of-two truncation, the f32 tsamp/tobs roundings and the
    whitening band edges of the reference."""
    size = prev_power_of_two(trials_nsamps)
    tsamp32 = float(np.float32(tsamp))
    tobs = float(np.float32(size) * np.float32(tsamp))
    bin_width = 1.0 / (size * tsamp32)
    return (
        size, tsamp32, tobs,
        int(pos5_freq / bin_width), int(pos25_freq / bin_width),
    )


class MultiFolder:
    min_period = 1e-3
    max_period = 10.0

    def __init__(
        self,
        trials,  # (ndm, nsamps) u8 dedispersed trials: a tensor, numpy
        # in host RAM, or ShardedRows over several devices (rows move to
        # ``device`` as they are folded)
        tsamp: float,
        pos5_freq: float = 0.05,
        pos25_freq: float = 0.5,
        device: torch.device | None = None,
        dm_offset: int = 0,  # global dm_idx of trials[0]: a process of a
        # multi-process run holds its own DM slice only, and folds the
        # candidates of that slice (the others' owners fold theirs)
    ):
        self.trials = trials
        self.dm_offset = dm_offset
        self.device = device if device is not None else trials.device
        # the reference folds with the f32 tsamp member (timeseries.hpp:54;
        # the fold's phase-bin assignment is sensitive to it at the 1e-8
        # level) and tobs = nsamps*tsamp is a uint*float f32 product
        # (folder.hpp:358)
        (
            self.nsamps, self.tsamp, self.tobs, self.pos5, self.pos25
        ) = fold_geometry(trials.shape[1], tsamp, pos5_freq, pos25_freq)
        self.optimiser = FoldOptimiser()

    def fold_n(self, cands: List[Candidate], n: int) -> List[Candidate]:
        return self.apply_outcomes(cands, self.fold_outcomes(cands, n))

    @staticmethod
    def apply_outcomes(
        cands: List[Candidate], outcomes: list[dict]
    ) -> List[Candidate]:
        """Write fold outcomes back onto the candidate list and re-sort by
        max(snr, folded_snr) (folder.hpp:25-31,433)."""
        for res in outcomes:
            ci = res["cand_idx"]
            cands[ci].folded_snr = res["opt_sn"]
            cands[ci].opt_period = res["opt_period"]
            cands[ci].fold = res["opt_fold"]
        return sorted(cands, key=lambda c: -max(c.snr, c.folded_snr))

    def fold_outcomes(self, cands: List[Candidate], n: int) -> list[dict]:
        """Fold + optimise the foldable top-``n`` candidates whose DM trial
        lies in this folder's trials, returning one outcome dict per
        candidate (keyed back by ``cand_idx``); a multi-process run
        exchanges these."""
        dm_map: dict[int, list[int]] = {}
        for ii in range(min(n, len(cands))):
            local_dm = cands[ii].dm_idx - self.dm_offset
            if (self.min_period < 1.0 / cands[ii].freq < self.max_period
                    and 0 <= local_dm < len(self.trials)):
                dm_map.setdefault(local_dm, []).append(ii)
        if not dm_map:
            return []
        dev = self.device
        used = NINTS * (self.nsamps // NINTS)
        folds, periods, cand_idx = [], [], []
        for dm_idx, cand_ids in dm_map.items():
            tim = torch.as_tensor(self.trials[dm_idx]).to(dev)
            xd = _deredden_tim(
                tim, size=self.nsamps, pos5=self.pos5, pos25=self.pos25,
            )
            # (a*tsamp) is an f32 product in the reference's launcher
            # (float a, float tsamp, kernels.cu:367); accel_factor replays it
            afs = accel_factor(
                np.asarray([cands[ci].acc for ci in cand_ids]), self.tsamp
            ).astype(np.float32)
            xr = resample_accel_quadratic(xd, torch.from_numpy(afs).to(dev))
            group_periods = [1.0 / cands[ci].freq for ci in cand_ids]
            flat_bins = np.stack([
                fold_bins_np(self.nsamps, self.tsamp, p, NBINS, NINTS)
                for p in group_periods
            ])
            folds.append(
                fold_time_series(
                    xr[:, :used], torch.from_numpy(flat_bins).to(dev),
                    nbins=NBINS, nints=NINTS,
                )
            )
            periods.extend(group_periods)
            cand_idx.extend(cand_ids)
        results = self.optimiser.optimise(
            torch.cat(folds), np.asarray(periods, dtype=np.float64), self.tobs
        )
        return [
            {
                "cand_idx": ci,
                "opt_sn": res["opt_sn"],
                "opt_period": res["opt_period"],
                "opt_fold": res["opt_fold"],
            }
            for ci, res in zip(cand_idx, results)
        ]
