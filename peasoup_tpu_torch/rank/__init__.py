"""Candidate ranking: calibrated scores over sift fold products (the JAX
package's rank/).

- :mod:`.model` — the artifact (load/save/validate, fingerprint,
  calibrated prediction, score tiers);
- :mod:`.score` — the batched scoring loop (pad-recycled fixed
  batches, halved when the card runs out of memory);
- :mod:`.train` — seeded training, isotonic calibration and the
  injected-ground-truth ROC evaluation (``peasoup-rank eval``).
"""

from .model import DEFAULT_MODEL_PATH, RankModel, score_tier

__all__ = ["DEFAULT_MODEL_PATH", "RankModel", "score_tier"]
