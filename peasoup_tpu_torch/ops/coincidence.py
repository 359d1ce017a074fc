"""Multibeam coincidence matching.

Reference: coincidence_kernel counts, per sample, how many beams exceed a
threshold; the output mask is 1 where fewer than ``beam_thresh`` beams
fired (src/kernels.cu:1073-1100). Beams lie on the leading axis and the
count is a sum over it (the JAX package's ops/coincidence.py, one device).
"""

from __future__ import annotations

import torch


def coincidence_mask(beams: torch.Tensor, thresh: float, beam_thresh: int) -> torch.Tensor:
    """beams (B, N) -> (N,) f32 mask, 1.0 = keep (not multibeam RFI)."""
    count = torch.sum(beams > thresh, dim=0)
    return (count < beam_thresh).to(torch.float32)
