"""Kill-file (channel mask) and zap-file (birdie list) parsing.

Reference: killfile = one 0/1 per channel line (dedisperser.hpp:71-95);
zapfile = two columns "freq width" in Hz (birdiezapper.hpp:35-59).
"""

from __future__ import annotations

import os

import numpy as np


def read_killfile(path: str | os.PathLike, nchans: int) -> np.ndarray:
    """Return an int killmask of shape (nchans,) with 1 = keep.

    Like the reference, a size mismatch degrades to an all-pass mask with
    a warning rather than an error (dedisperser.hpp:86-93).
    """
    values = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            values.append(int(float(line.split()[0])))
            if len(values) >= nchans:
                break
    if len(values) != nchans:
        import warnings

        warnings.warn(
            f"killmask is not the same size as nchans ({len(values)} != {nchans}); ignoring"
        )
        return np.ones(nchans, dtype=np.int32)
    return np.asarray(values, dtype=np.int32)


def read_zapfile(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """Return (freqs, widths) float arrays parsed from a birdie list."""
    freqs, widths = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                freqs.append(float(parts[0]))
                widths.append(float(parts[1]))
    return np.asarray(freqs, dtype=np.float64), np.asarray(widths, dtype=np.float64)
