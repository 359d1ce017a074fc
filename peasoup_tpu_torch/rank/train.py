"""Deterministic training + calibration on injected ground truth: the
JAX package's rank/train.py.

Labelled fold products are synthesised with numpy from a seed
(persistent gaussian pulses peaking at their own DM for pulsars;
zero-DM-peaked, intermittent or broadband structure for RFI; pure noise),
their features extracted on the caller's device, the small MLP trained by
seeded full-batch gradient descent with momentum (``torch.autograd`` on
the JAX package's loss, in f32), and an isotonic-style
(pool-adjacent-violators) calibration fitted so scores read as
comparable probabilities.

Same seed and device, same artifact and fingerprint. Against the JAX
package the synthetic set is identical (numpy), the initial weights are
identical, and the trained weights agree to the tolerance
tests/test_torch_rank.py states: the two frameworks round their sums
differently, and many steps of descent carry that on.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import resolve_device
from ..ops.candidate_features import (
    DM_CURVE_FRACTIONS,
    FEATURE_NAMES,
    NFEATURES,
)
from .model import (
    MODEL_SCHEMA,
    MODEL_VERSION,
    RankModel,
    model_fingerprint,
    score_tier,
)
from .score import extract_features, score_feature_matrix

log = logging.getLogger("peasoup_tpu_torch.rank.train")


# --------------------------------------------------------------------------
# the injected ground-truth set
# --------------------------------------------------------------------------

def _circular_pulse(nbins: int, phase: float, width: float) -> np.ndarray:
    """A wrapped gaussian pulse over phase bins."""
    bins = np.arange(nbins, dtype=np.float64) / nbins
    d = np.abs(bins - phase)
    d = np.minimum(d, 1.0 - d) * nbins
    return np.exp(-0.5 * (d / max(width, 0.5)) ** 2)


def synth_fold_products(
    n: int,
    seed: int,
    *,
    nbins: int = 64,
    nints: int = 16,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list[str]]:
    """``(prof, subints, dm_curve, labels, kinds)`` for ``n`` injected
    examples: ~40% pulsars (label 1), ~40% RFI foils, ~20% noise
    (label 0). The DM curve carries the fold significance at
    :data:`DM_CURVE_FRACTIONS` of the candidate DM — pulsars peak at
    their own DM, terrestrial foils at zero."""
    rng = np.random.default_rng(seed)
    fr = np.asarray(DM_CURVE_FRACTIONS, dtype=np.float64)
    ndm = len(fr)
    subints = np.empty((n, nints, nbins), dtype=np.float32)
    dm_curve = np.empty((n, ndm), dtype=np.float32)
    labels = np.zeros(n, dtype=np.int32)
    kinds: list[str] = []
    for i in range(n):
        u = rng.uniform()
        noise = rng.normal(0.0, 1.0, size=(nints, nbins))
        if u < 0.4:
            kind = "pulsar"
        elif u < 0.6:
            kind = "rfi_zerodm"
        elif u < 0.8:
            kind = "rfi_broad"
        else:
            kind = "noise"
        kinds.append(kind)
        if kind == "pulsar":
            labels[i] = 1
            phase = rng.uniform()
            width = rng.uniform(1.0, nbins / 10.0)
            amp = rng.uniform(4.0, 25.0)
            shape = _circular_pulse(nbins, phase, width)
            per = amp * rng.uniform(0.6, 1.4, size=nints)
            sub = noise + per[:, None] * shape[None, :]
            sigma = rng.uniform(0.25, 0.5)
            curve = amp * np.exp(-(((1.0 - fr) / sigma) ** 2))
            curve = curve + rng.normal(0.0, 0.5, size=ndm)
        elif kind == "rfi_zerodm":
            # impulsive terrestrial interference: bright in a random
            # subset of subints, fold significance peaking at DM 0
            phase = rng.uniform()
            width = rng.uniform(0.8, nbins / 8.0)
            amp = rng.uniform(5.0, 30.0)
            shape = _circular_pulse(nbins, phase, width)
            mask = rng.uniform(size=nints) < rng.uniform(0.1, 0.45)
            if not mask.any():
                mask[int(rng.integers(nints))] = True
            per = amp * rng.uniform(0.5, 2.0, size=nints) * mask
            sub = noise + per[:, None] * shape[None, :]
            sigma = rng.uniform(0.2, 0.45)
            curve = amp * np.exp(-((fr / sigma) ** 2))
            curve = curve + rng.normal(0.0, 0.5, size=ndm)
        elif kind == "rfi_broad":
            # broadband periodic interference (mains hum): a slow
            # sinusoidal profile in every subint, flat-to-zero-DM curve
            amp = rng.uniform(2.0, 8.0)
            phase = rng.uniform(0.0, 2.0 * np.pi)
            cyc = int(rng.integers(1, 3))
            wave = amp * np.sin(
                2.0 * np.pi * cyc * np.arange(nbins) / nbins + phase
            )
            sub = noise + wave[None, :] * rng.uniform(
                0.7, 1.3, size=(nints, 1)
            )
            curve = amp * (1.0 - 0.5 * fr) + rng.normal(
                0.0, 0.8, size=ndm
            )
        else:
            sub = noise
            curve = rng.normal(0.0, 1.0, size=ndm)
        subints[i] = sub.astype(np.float32)
        dm_curve[i] = curve.astype(np.float32)
    prof = subints.mean(axis=1).astype(np.float32)
    return prof, subints, dm_curve, labels, kinds


# --------------------------------------------------------------------------
# metrics + calibration
# --------------------------------------------------------------------------

def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney AUC with average ranks for ties."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int((labels == 1).sum())
    n_neg = int((labels == 0).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # average ranks over tied score groups
    uniq, inv, cnt = np.unique(
        scores, return_inverse=True, return_counts=True
    )
    if len(uniq) != len(scores):
        sums = np.zeros(len(uniq))
        np.add.at(sums, inv, ranks)
        ranks = (sums / cnt)[inv]
    r_pos = ranks[labels == 1].sum()
    return float(
        (r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    )


def isotonic_calibration(
    raw: np.ndarray, labels: np.ndarray
) -> tuple[list[float], list[float]]:
    """Pool-adjacent-violators fit of P(pulsar | raw score), returned
    as monotone piecewise-linear breakpoints ``(x, y)`` spanning
    [0, 1] for ``np.interp``."""
    order = np.argsort(raw, kind="stable")
    x = np.asarray(raw, dtype=np.float64)[order]
    y = np.asarray(labels, dtype=np.float64)[order]
    vals: list[float] = []
    wts: list[float] = []
    xmid: list[float] = []
    for xi, yi in zip(x, y):
        vals.append(float(yi))
        wts.append(1.0)
        xmid.append(float(xi))
        while len(vals) > 1 and vals[-2] >= vals[-1]:
            w = wts[-2] + wts[-1]
            v = (vals[-2] * wts[-2] + vals[-1] * wts[-1]) / w
            xm = (xmid[-2] * wts[-2] + xmid[-1] * wts[-1]) / w
            vals[-2:] = [v]
            wts[-2:] = [w]
            xmid[-2:] = [xm]
    xs: list[float] = [0.0]
    ys: list[float] = [float(np.clip(vals[0], 0.0, 1.0))]
    for xm, v in zip(xmid, vals):
        xc = float(np.clip(xm, 0.0, 1.0))
        vc = float(np.clip(v, 0.0, 1.0))
        if xc <= xs[-1] + 1e-9:
            continue
        xs.append(xc)
        ys.append(max(vc, ys[-1]))
    if xs[-1] < 1.0:
        xs.append(1.0)
        ys.append(ys[-1])
    return xs, ys


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _train_weights(
    feats: np.ndarray,
    labels: np.ndarray,
    *,
    seed: int,
    hidden: int,
    steps: int,
    lr: float,
    device: torch.device,
) -> dict:
    """Seeded full-batch gradient descent with momentum on the BCE loss,
    in f32 on ``device``: the JAX package's loss, initialisation and
    update, its gradient taken by ``torch.autograd``."""
    mean = feats.mean(axis=0).astype(np.float32)
    scale = (feats.std(axis=0) + 1e-6).astype(np.float32)
    z = torch.as_tensor(((feats - mean) / scale).astype(np.float32), device=device)
    yv = torch.as_tensor(np.asarray(labels, dtype=np.float32), device=device)
    rng = np.random.default_rng(seed)
    params = [
        torch.as_tensor(
            rng.normal(0.0, 1.0 / np.sqrt(NFEATURES),
                       size=(NFEATURES, hidden)).astype(np.float32), device=device),
        torch.zeros(hidden, dtype=torch.float32, device=device),
        torch.as_tensor(
            rng.normal(0.0, 1.0 / np.sqrt(hidden), size=hidden).astype(np.float32),
            device=device),
        torch.zeros((), dtype=torch.float32, device=device),
    ]

    def loss(p):
        w1, b1, w2, b2 = p
        h = torch.tanh(z @ w1 + b1[None, :])
        logit = h @ w2 + b2
        # numerically stable BCE with logits + a touch of weight decay
        bce = torch.mean(
            torch.clamp(logit, min=0.0) - logit * yv
            + torch.log1p(torch.exp(-torch.abs(logit)))
        )
        l2 = torch.sum(w1 * w1) + torch.sum(w2 * w2)
        return bce + 1e-4 * l2

    vel = [torch.zeros_like(p) for p in params]
    last = float("nan")
    for _ in range(steps):
        ps = [p.detach().requires_grad_(True) for p in params]
        value = loss(ps)
        grads = torch.autograd.grad(value, ps)
        last = value.detach()
        with torch.no_grad():
            vel = [0.9 * v - lr * g for v, g in zip(vel, grads)]
            params = [p + v for p, v in zip(params, vel)]
    w1, b1, w2, b2 = (p.detach().cpu().numpy().astype(np.float64) for p in params)
    return {
        "norm_mean": [float(v) for v in mean],
        "norm_scale": [float(v) for v in scale],
        "w1": [[round(float(v), 8) for v in row] for row in w1],
        "b1": [round(float(v), 8) for v in b1],
        "w2": [round(float(v), 8) for v in w2],
        "b2": round(float(b2), 8),
        "final_loss": float(last),
    }


def train_model(
    *,
    seed: int = 42,
    n_examples: int = 1200,
    steps: int = 400,
    hidden: int = 16,
    lr: float = 0.05,
    nbins: int = 64,
    nints: int = 16,
    batch: int = 64,
    device: str | torch.device = "cuda",
) -> dict:
    """Train + calibrate on ``device``; returns the complete artifact
    document."""
    dev = resolve_device(device)
    prof, subints, dm_curve, labels, _ = synth_fold_products(
        n_examples, seed, nbins=nbins, nints=nints
    )
    feats = extract_features(prof, subints, dm_curve, batch=batch, device=dev)
    fit = _train_weights(
        feats, labels, seed=seed, hidden=hidden, steps=steps, lr=lr, device=dev
    )
    final_loss = fit.pop("final_loss")
    doc = {
        "schema": MODEL_SCHEMA,
        "version": MODEL_VERSION,
        "seed": int(seed),
        "nfeatures": NFEATURES,
        "feature_names": list(FEATURE_NAMES),
        "hidden": int(hidden),
        **fit,
        "calibration": {"x": [0.0, 1.0], "y": [0.0, 1.0]},
        "train": {
            "n_examples": int(n_examples),
            "steps": int(steps),
            "lr": float(lr),
            "auc": 0.0,
            "nbins": int(nbins),
            "nints": int(nints),
        },
    }
    # calibrate on the training set's raw scores, then record the
    # (calibrated) training AUC in the provenance block
    doc["fingerprint"] = model_fingerprint(doc)
    model = RankModel(doc)
    raw = np.concatenate(
        [
            model.predict_raw(feats[lo : lo + batch], dev)
            for lo in range(0, len(feats), batch)
        ]
    )
    xs, ys = isotonic_calibration(raw, labels)
    doc["calibration"] = {
        "x": [round(v, 8) for v in xs],
        "y": [round(v, 8) for v in ys],
    }
    doc["train"]["auc"] = round(roc_auc(labels, raw), 6)
    doc["fingerprint"] = model_fingerprint(doc)
    log.info(
        "trained rank model: %d examples, %d steps, loss %.4f, "
        "train AUC %.4f", n_examples, steps, final_loss,
        doc["train"]["auc"],
    )
    return doc


def evaluate_model(
    model: RankModel,
    *,
    seed: int = 20260806,
    n_examples: int = 600,
    batch: int = 64,
    device: str | torch.device = "cuda",
) -> dict:
    """Score a held-out injected ground-truth set (a different seed
    than training) and tally ROC AUC + tier placement — the numbers
    ``peasoup-rank eval`` gates on."""
    tr = model.doc.get("train", {})
    prof, subints, dm_curve, labels, kinds = synth_fold_products(
        n_examples, seed,
        nbins=int(tr.get("nbins", 64)), nints=int(tr.get("nints", 16)),
    )
    feats = extract_features(prof, subints, dm_curve, batch=batch, device=device)
    scores = score_feature_matrix(model, feats, batch=batch, device=device)
    tiers = np.asarray([score_tier(float(p)) for p in scores])
    is_pulsar = labels == 1
    is_foil = np.asarray([k.startswith("rfi") for k in kinds])
    n_pulsar = int(is_pulsar.sum())
    n_foil = int(is_foil.sum())
    return {
        "auc": roc_auc(labels, scores),
        "n_examples": int(n_examples),
        "n_pulsar": n_pulsar,
        "n_foil": n_foil,
        "seed": int(seed),
        "fingerprint": model.fingerprint,
        "pulsar_tier1_frac": (
            float((tiers[is_pulsar] == 1).mean()) if n_pulsar else 0.0
        ),
        "foil_tier1_frac": (
            float((tiers[is_foil] == 1).mean()) if n_foil else 0.0
        ),
        "median_pulsar_score": (
            float(np.median(scores[is_pulsar])) if n_pulsar else 0.0
        ),
        "median_foil_score": (
            float(np.median(scores[is_foil])) if n_foil else 0.0
        ),
    }
