"""The rank model artifact: a small MLP scorer as checked-in JSON.

One JSON document carries everything prediction needs (feature
standardisation, MLP weights, the isotonic-style calibration map, the
feature names it was trained against, provenance and a content
fingerprint), validated against ``model.schema.json`` on every load, so
a hand-edited or truncated artifact fails loudly. The port ships its own
copy of the JAX package's ``model.json`` and ``model.schema.json`` beside
this module; the shipped artifact has the same fingerprint in both
packages (``peasoup_tpu.rank_model`` names the file format they share).
The forward pass runs as torch on the caller's device
(:func:`~peasoup_tpu_torch.ops.candidate_features.score_apply`); the
calibration is a monotone piecewise-linear map applied on the host.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..obs.schema import SchemaError, validate
from ..ops.candidate_features import FEATURE_NAMES, NFEATURES, score_apply

MODEL_SCHEMA = "peasoup_tpu.rank_model"
MODEL_VERSION = 1

_HERE = os.path.dirname(os.path.abspath(__file__))
_SCHEMA_PATH = os.path.join(_HERE, "model.schema.json")

#: The shipped artifact (trained by ``peasoup-rank train``; its ROC on
#: the injected ground-truth set is held by ``peasoup-rank eval``).
DEFAULT_MODEL_PATH = os.path.join(_HERE, "model.json")

#: Calibrated-probability thresholds for the triage tiers: tier 1 is
#: "review first", tier 3 is "bulk". Stored per row in the sift DB so
#: the report/portal can count and sort without the model.
SCORE_TIER1 = 0.85
SCORE_TIER2 = 0.5


def score_tier(p: float) -> int:
    """Triage tier of one calibrated score (1 best, 3 worst)."""
    if p >= SCORE_TIER1:
        return 1
    if p >= SCORE_TIER2:
        return 2
    return 3


def model_fingerprint(doc: dict) -> str:
    """Content hash over the canonical artifact (fingerprint field
    excluded) — stamped into every scored sift row so a catalogue
    always names the exact model that ranked it."""
    payload = {k: doc[k] for k in sorted(doc) if k != "fingerprint"}
    digest = hashlib.sha256(
        json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()
    return f"sha256:{digest[:16]}"


def validate_model_doc(doc: dict) -> None:
    """Schema + consistency checks; raises ``ValueError`` on a bad
    artifact (wrapping the schema validator's error)."""
    with open(_SCHEMA_PATH) as f:
        schema = json.load(f)
    try:
        validate(doc, schema)
    except SchemaError as exc:
        raise ValueError(f"bad rank model artifact: {exc}") from exc
    if tuple(doc["feature_names"]) != FEATURE_NAMES:
        raise ValueError(
            "rank model artifact was trained against different "
            f"features {doc['feature_names']} (this build has "
            f"{list(FEATURE_NAMES)})"
        )
    if doc["fingerprint"] != model_fingerprint(doc):
        raise ValueError(
            "rank model artifact fingerprint mismatch (edited or "
            "corrupted file)"
        )
    hidden = int(doc["hidden"])
    w1 = doc["w1"]
    if len(w1) != NFEATURES or any(len(r) != hidden for r in w1):
        raise ValueError("rank model w1 shape mismatch")
    if (
        len(doc["b1"]) != hidden
        or len(doc["w2"]) != hidden
        or len(doc["norm_mean"]) != NFEATURES
        or len(doc["norm_scale"]) != NFEATURES
    ):
        raise ValueError("rank model weight shape mismatch")
    cal = doc["calibration"]
    if len(cal["x"]) != len(cal["y"]) or len(cal["x"]) < 2:
        raise ValueError("rank model calibration map malformed")
    if any(b < a for a, b in zip(cal["y"], cal["y"][1:])):
        raise ValueError("rank model calibration map not monotone")


class RankModel:
    """A loaded, validated artifact ready to score feature matrices."""

    def __init__(self, doc: dict) -> None:
        validate_model_doc(doc)
        self.doc = doc
        self.fingerprint = doc["fingerprint"]
        f32 = np.float32
        self.norm_mean = np.asarray(doc["norm_mean"], dtype=f32)
        self.norm_scale = np.asarray(doc["norm_scale"], dtype=f32)
        self.w1 = np.asarray(doc["w1"], dtype=f32)
        self.b1 = np.asarray(doc["b1"], dtype=f32)
        self.w2 = np.asarray(doc["w2"], dtype=f32)
        self.b2 = f32(doc["b2"])
        self.cal_x = np.asarray(doc["calibration"]["x"], dtype=np.float64)
        self.cal_y = np.asarray(doc["calibration"]["y"], dtype=np.float64)

    @classmethod
    def from_file(cls, path: str | None = None) -> "RankModel":
        path = path or DEFAULT_MODEL_PATH
        try:
            with open(path) as f:
                doc = json.load(f)
        except OSError as exc:
            raise ValueError(
                f"cannot read rank model artifact {path}: {exc}"
            ) from exc
        except json.JSONDecodeError as exc:
            raise ValueError(
                f"rank model artifact {path} is not JSON: {exc}"
            ) from exc
        return cls(doc)

    # --- prediction ---------------------------------------------------
    def predict_raw(self, feats: np.ndarray,
                    device: str | torch.device = "cuda") -> np.ndarray:
        """Uncalibrated MLP probabilities for a feature matrix, computed in
        f32 on ``device`` (the card unless the caller asks for the CPU)."""
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

        raw = score_apply(
            t(feats), t(self.norm_mean), t(self.norm_scale), t(self.w1),
            t(self.b1), t(self.w2), t(self.b2),
        )
        return raw.cpu().numpy().astype(np.float64)

    def calibrate(self, raw: np.ndarray) -> np.ndarray:
        """Monotone piecewise-linear calibration (isotonic fit stored
        as breakpoints): raw MLP probability -> comparable-across-
        observations probability."""
        return np.interp(np.asarray(raw, dtype=np.float64),
                         self.cal_x, self.cal_y)

    def predict(self, feats: np.ndarray,
                device: str | torch.device = "cuda") -> np.ndarray:
        return self.calibrate(self.predict_raw(feats, device))

    # --- persistence --------------------------------------------------
    def save(self, path: str) -> None:
        save_model_doc(self.doc, path)


def save_model_doc(doc: dict, path: str) -> None:
    """Re-fingerprint, validate and atomically write an artifact."""
    doc = dict(doc)
    doc["fingerprint"] = model_fingerprint(doc)
    validate_model_doc(doc)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
