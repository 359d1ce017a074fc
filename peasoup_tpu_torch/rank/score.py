"""Batched scoring: fold products -> features -> scores.

The JAX package's rank/score.py: fixed-width batches padded by recycling
rows, as the survey folder dispatches its folds, on the caller's device.
When the card runs out of memory the feature batch halves and the same
rows are retried (raised at batch 1); feature rows are independent, so
the halved batches give the same bits (tests/test_torch_rank.py). Each
halving is a step of the ``rank.features`` DegradationLadder, and the
``device.oom`` fault seam fires at each batch, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..obs.log import get_logger
from ..ops.candidate_features import DM_CURVE_POINTS, NFEATURES, candidate_features_batch
from ..pipeline.search import _is_oom, _release
from ..resilience import DegradationLadder, faults
from .model import RankModel

log = get_logger("rank.score")


def neutral_dm_curve(n: int) -> np.ndarray:
    """A flat DM curve for candidates scored without one (no raw data left
    to refold): zero contrast, zero peakedness, so the DM features go
    silent instead of inventing a verdict."""
    return np.zeros((n, DM_CURVE_POINTS), dtype=np.float32)


def extract_features(
    prof: np.ndarray,  # (N, nbins) f32
    subints: np.ndarray,  # (N, nints, nbins) f32
    dm_curve: np.ndarray,  # (N, DM_CURVE_POINTS) f32
    *,
    batch: int = 64,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Feature matrix (N, NFEATURES) through fixed pad-recycled batches of
    :func:`candidate_features_batch` on ``device``, halving the batch when
    the card runs out of memory."""
    n_total = len(prof)
    if n_total == 0:
        return np.empty((0, NFEATURES), dtype=np.float32)
    dev = resolve_device(device)
    batch = max(1, int(batch))
    ladder = DegradationLadder("rank.features", ("batch_shrink",))
    out: list[np.ndarray] = []
    lo = 0
    while lo < n_total:
        hi = min(lo + batch, n_total)
        n = hi - lo
        pad_idx = np.arange(batch) % n + lo
        try:
            faults.fire("device.oom", context=f"rank.features:{lo}")
            feats = candidate_features_batch(
                torch.from_numpy(prof[pad_idx]).to(dev),
                torch.from_numpy(subints[pad_idx]).to(dev),
                torch.from_numpy(dm_curve[pad_idx]).to(dev),
            )[:n].cpu().numpy()
        except Exception as exc:
            if not _is_oom(exc):
                raise
            if batch <= 1:
                ladder.exhausted(batch=batch, error=f"{exc!s:.200}")
                raise
            log.warning("features out of memory at batch %d (row %d): halving to %d",
                        batch, lo, batch // 2)
            ladder.step("batch_shrink", batch_old=batch, batch_new=batch // 2,
                        error=f"{exc!s:.200}")
            batch //= 2
            _release(dev)
            continue  # the same rows at the smaller batch
        out.append(feats)
        lo = hi
    return np.concatenate(out, axis=0)


def score_feature_matrix(model: RankModel, feats: np.ndarray, *, batch: int = 64,
                         device: str | torch.device = "cuda") -> np.ndarray:
    """Calibrated probabilities over a feature matrix, in the same fixed
    pad-recycled batch width."""
    n_total = len(feats)
    if n_total == 0:
        return np.empty((0,), dtype=np.float64)
    batch = max(1, int(batch))
    raw = np.empty(n_total, dtype=np.float64)
    lo = 0
    while lo < n_total:
        hi = min(lo + batch, n_total)
        n = hi - lo
        pad_idx = np.arange(batch) % n + lo
        raw[lo:hi] = model.predict_raw(feats[pad_idx], device)[:n]
        lo = hi
    return model.calibrate(raw)


def score_fold_products(
    model: RankModel,
    prof: np.ndarray,
    subints: np.ndarray,
    dm_curve: np.ndarray | None = None,
    *,
    batch: int = 64,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """The full pass: ``(features, calibrated_scores)``."""
    if dm_curve is None:
        dm_curve = neutral_dm_curve(len(prof))
    feats = extract_features(
        np.asarray(prof, dtype=np.float32),
        np.asarray(subints, dtype=np.float32),
        np.asarray(dm_curve, dtype=np.float32),
        batch=batch, device=device,
    )
    return feats, score_feature_matrix(model, feats, batch=batch, device=device)
