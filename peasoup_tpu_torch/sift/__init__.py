"""peasoup-sift: survey-scale batched folding and candidate sifting over
the campaign candidate database (the JAX package's sift/):

- :mod:`.fold` — fixed-width batched folding of every database candidate
  across observations (:mod:`peasoup_tpu_torch.ops.survey_fold`);
- :mod:`.crossmatch` — known-pulsar cross-match with harmonic ladders;
- :mod:`.dedup` — campaign-level harmonic/DM dedup and the multi-beam
  coincidence veto;
- :mod:`.repeats` — repeat single-pulse association and RRAT periods;
- :mod:`.service` — the ``peasoup-sift run`` orchestration writing the
  ``sift_*`` tables;
- :mod:`.report` — the self-contained HTML survey report.
"""

from .service import SiftConfig, SiftRun

__all__ = ["SiftConfig", "SiftRun"]
