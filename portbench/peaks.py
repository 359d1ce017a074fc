"""The card's published peaks, the denominator of every roofline share.

NVIDIA's data sheet for the H100 SXM at its 700 W limit: 67 TFLOP/s in
float32 outside the tensor cores and 3.35 TB/s of HBM3. A card may be
set below 700 W and then runs slower under load, so every share is
printed with the card's power limit as ``nvidia-smi`` reads it.
"""

from __future__ import annotations

import subprocess

# (substring of torch.cuda.get_device_name(), f32 FLOP/s, bytes/s)
PEAKS = (
    ("H100", 67e12, 3.35e12),
)


def peaks(device_name: str) -> tuple[float, float] | None:
    """(FLOP/s, bytes/s) of a card by name, or None for a card not listed."""
    for frag, flops, bw in PEAKS:
        if frag.lower() in (device_name or "").lower():
            return flops, bw
    return None


def power_limit_w(index: int = 0) -> float | None:
    """The card's power limit in watts, read by ``nvidia-smi``; None where
    it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
