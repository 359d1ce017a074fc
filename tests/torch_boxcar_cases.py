"""The boxcar kernel's edge cases, shared by the host emulation of its
blocks (test_torch_kernel_host.py) and the card's test (test_torch_cuda.py):
prefix sums of normalised noise with a bright pulse, built on the CPU by
the port's own normalisation and padding, and each case's edge. Imports
neither JAX nor the JAX package."""

import numpy as np
import torch

from peasoup_tpu_torch.ops import singlepulse as sp
from peasoup_tpu_torch.ops.streaming import stream_geometry

STREAM_CHUNK, STREAM_DEC = 16384, 32  # peasoup-stream's defaults

CASES = (
    "stream_window",  # the stream's window (hold + chunk), fewer DM trials
    "nvalid_mid_tile",
    "nvalid_zero",
    "odd_widths",  # none a multiple of 4 but 12
    "ties",  # flat stretches: every width's boxcar 0
    "signed_zeros",
    "widest_bank",  # the widest boxcar a 14-chunk ring holds a tile of
    "short_tpad",  # tpad below 8,192: one full tile and a short one
)


def boxcar_case(case: str):
    """(csum (rows, tpad + wext) f32 numpy, widths, scales, nvalid, tpad)."""
    rng = np.random.default_rng(CASES.index(case) + 11)
    rows, nsamps = 5, 20000
    widths = sp.default_widths(12)
    if case == "stream_window":
        rows = 6
        nsamps = stream_geometry(widths, STREAM_CHUNK, STREAM_DEC) + STREAM_CHUNK
    if case == "odd_widths":
        widths = (1, 3, 5, 7, 12)
    if case == "widest_bank":
        rows, nsamps, widths = 2, 70001, (1, 2, 5, 4099, 48126)
    if case == "short_tpad":
        rows, nsamps, widths = 4, 5000, sp.default_widths(5)
    x = rng.normal(size=(rows, nsamps)).astype(np.float32)
    x[1, nsamps // 3 : nsamps // 3 + 40] += 8.0
    if case == "ties":
        x[:, 100:5000] = 0.0
        x[2, 6000:9000:64] = 3.0
        x[3] = np.round(x[3])
    norm = sp.normalise_trials(torch.from_numpy(x))
    if case == "ties":
        norm[:, 100:5000] = 0.0
    tpad, _ = sp.plan_pad(nsamps)
    csum = sp.prefix_sum_padded(norm, tpad, sp.width_extent(widths)).numpy()
    nvalid = nsamps
    if case == "signed_zeros":
        # -0 and +0 prefix sums side by side: (-0 - +0) * s = -0, (+0 - -0)
        # * s = +0, and tiny differences that round to a signed zero
        csum[:, 200:6000] = np.where(np.arange(5800) % 3 == 0, -0.0, 0.0)
        csum[1, 7000:9000] = np.where(np.arange(2000) % 2, -1e-45, 1e-45)
        csum[2, 3000:3100] = -0.0
    if case == "nvalid_mid_tile":
        nvalid = nsamps - 1500
    if case == "nvalid_zero":
        nvalid = 0
    csum = np.ascontiguousarray(csum, np.float32)
    return csum, widths, sp.width_scales(widths), nvalid, tpad
