"""Fourier-domain acceleration search (FDAS): the port's copy of the JAX
package's peasoup_tpu/fdas.

Template banks over (f-dot, f-ddot) evaluated as batched frequency-domain
correlations of one dereddened spectrum per DM trial (the PRESTO
correlation formulation; arXiv:1912.12807 runs this search shape at survey
scale).

- :mod:`peasoup_tpu_torch.fdas.templates`: the host-side finite-duration
  response bank and the geometry formulas (template width, overlap-save
  segment).
- :mod:`peasoup_tpu_torch.ops.fdas`: the correlation, interbin power,
  harmonic sums and peaks of a (DM block x template batch) tile in torch
  and cuFFT.
- :mod:`peasoup_tpu_torch.pipeline.fdas`: the driver.
"""

from .templates import (  # noqa: F401
    FdasTemplateBank,
    auto_segment,
    build_template_bank,
    template_half_width,
)
