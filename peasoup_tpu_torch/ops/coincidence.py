"""Multibeam coincidence matching.

Reference: coincidence_kernel counts, per sample, how many beams exceed a
threshold; the output mask is 1 where fewer than ``beam_thresh`` beams
fired (src/kernels.cu:1073-1100). Beams lie on the leading axis and the
count is a sum over it (the JAX package's ops/coincidence.py). When the
beams are split over devices, each shard counts its own beams and the
counts are summed across shards (the JAX package's psum over the mesh's
beam axis; parallel/coincidence.py:sharded_coincidence).
"""

from __future__ import annotations

import torch


def coincidence_mask(
    beams: torch.Tensor, thresh: float, beam_thresh: int, reduce=None,
) -> torch.Tensor:
    """beams (B, N) -> (N,) f32 mask, 1.0 = keep (not multibeam RFI).
    Under sharding, ``reduce`` maps this shard's (N,) exceed-count to the
    sum over every shard."""
    count = torch.sum(beams > thresh, dim=0)
    if reduce is not None:
        count = reduce(count)
    return (count < beam_thresh).to(torch.float32)
