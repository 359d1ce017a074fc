"""Each hand-written kernel's operations and bytes as a function of its
launch shape, one file a kernel (``roofline/<kernel>.py``: its device
``SYMBOLS``, the last launched once a wrapper launch, and ``count(shape,
config) -> (operations, bytes)``, ``config`` the cell's configuration),
and the share of the roofline a kernel reaches.

The counts follow one rule: each input byte read once and each output
byte written once, whatever the kernel reads again; where the work
depends on the data, what these inputs need, and no more. The least time
the card could take is the larger of operations over the peak FLOP/s and
bytes over the peak bandwidth (``peaks.py``).

A share is one card's roofline over card-time: the launches are counted
over the process (``kernels.launch_shapes``) and a kernel's seconds are
summed over every card it ran on (``trace.py``), so a cell on several
cards reads its cards' least time together over their time together, as
a cell on one reads that card's.
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def kernels() -> list[str]:
    """Every kernel with a count, by its file's name."""
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def load(kernel: str):
    return importlib.import_module(f"{__name__}.{kernel}")


def symbols() -> dict[str, tuple]:
    return {k: tuple(load(k).SYMBOLS) for k in kernels()}


def bound_seconds(kernel: str, shapes: dict, peak: tuple[float, float],
                  config: dict | None = None) -> tuple[float, str]:
    """The least time the launches ``shapes`` ({shape: launches}) of
    ``kernel`` could take on a card of ``peak`` (FLOP/s, bytes/s) in a
    cell of configuration ``config``, and which of the two bounds it."""
    mod = load(kernel)
    t_ops = t_bytes = 0.0
    for shape, n in shapes.items():
        ops, nbytes = mod.count(tuple(shape), config)
        t_ops += n * ops / peak[0]
        t_bytes += n * nbytes / peak[1]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
