"""DM-trial-sharded dedispersion over a device mesh: the JAX package's
parallel/sharded_dedisperse.py.

The reference dedisperses across all GPUs of a node
(``dedisp_create_plan_multi``, include/transforms/dedisperser.hpp:25-31).
Here the DM-trial axis is laid out on the mesh's 'dm' axis: the delay
table is padded to a multiple of the shard count with copies of its last
row (as the JAX package pads it), each shard's device receives the u8
filterbank once, and each shard launches the dedisperse kernel
(csrc/dedisperse.cu) on its own contiguous slice of the table. The trials
stay where they were made, as :class:`ShardedRows`; the search and the
folder read them there.

Under a profiler each copy of the filterbank to a device other than its
own is the span ``Shard-Copy`` (utils/trace.py), and adds the bytes it
moves to the counter ``shard.copy_bytes``; a shard on the filterbank's
own device copies nothing and records neither. The span's stream seconds
are read on the filterbank's device: a copy between cards runs on the
source card's current stream, which the receiving card's stream waits
on, so events there bracket the copy alone.

Bitwise :func:`~peasoup_tpu_torch.ops.dedisperse.dedisperse` on one
device: channel sums of <=8-bit samples are exact, so which device sums a
trial cannot change it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_context
from ..ops.dedisperse import _host, dedisperse
from ..utils import trace_count, trace_span
from .mesh import Mesh


class ShardedRows:
    """A (nrows, ncols) table held as contiguous row blocks of ``per`` rows,
    one block per shard, each on its shard's device. The last blocks may
    end in padding rows past ``nrows``, which no reader sees."""

    def __init__(self, parts: list[torch.Tensor], nrows: int):
        self.parts = parts
        self.nrows = int(nrows)
        self.per = int(parts[0].shape[0])
        self.ncols = int(parts[0].shape[1])

    @property
    def shape(self) -> tuple[int, int]:
        return self.nrows, self.ncols

    def __len__(self) -> int:
        return self.nrows

    def __getitem__(self, i: int) -> torch.Tensor:
        """Row ``i``, on its shard's device."""
        if not 0 <= i < self.nrows:
            raise IndexError(i)
        return self.parts[i // self.per][i % self.per]

    def rows(self, lo: int, hi: int, device: torch.device) -> torch.Tensor:
        """Rows [lo, hi) on ``device``: a view of one shard's block when
        they lie in it on that device, else gathered there (the JAX
        package's make_row_gather)."""
        pieces = []
        while lo < hi:
            s = lo // self.per
            end = min(hi, (s + 1) * self.per)
            pieces.append(self.parts[s][lo - s * self.per : end - s * self.per])
            lo = end
        if not pieces:
            return self.parts[0][:0].to(device)
        if len(pieces) == 1 and pieces[0].device == device:
            return pieces[0]
        return torch.cat([p.to(device) for p in pieces])

    def gather(self, device: torch.device) -> torch.Tensor:
        """The whole table, padding rows included, on ``device``."""
        return torch.cat([p.to(device) for p in self.parts])


def shard_bounds(nrows: int, nshards: int) -> list[tuple[int, int]]:
    """[lo, hi) of each shard's real rows when ``nrows`` rows are padded to
    a multiple of ``nshards`` and split in contiguous blocks."""
    per = -(-nrows // nshards)
    return [(min(s * per, nrows), min((s + 1) * per, nrows)) for s in range(nshards)]


def dedisperse_sharded(
    fil_tc: torch.Tensor,
    delays,
    killmask,
    out_nsamps: int,
    mesh: Mesh,
    *,
    axis: str = "dm",
    scale: float = 1.0,
) -> ShardedRows:
    """Dedisperse every DM trial with the trial axis sharded over
    ``mesh``'s ``axis``. ``delays`` (D, C) and ``killmask`` (C,) are the
    plan's host arrays. D is padded up to a multiple of the shard count by
    repeating the last trial row; each shard makes ceil(D / n) trials (one
    kernel launch on a card). Returns the trials, D rows, as
    :class:`ShardedRows`."""
    devs = mesh.axis_devices(axis)
    delays = _host(delays, "delays")
    ndm = delays.shape[0]
    per = -(-ndm // len(devs))
    if per * len(devs) > ndm:
        delays = np.concatenate(
            [delays, np.repeat(delays[-1:], per * len(devs) - ndm, axis=0)]
        )
    copies: dict[torch.device, torch.Tensor] = {fil_tc.device: fil_tc}
    parts = []
    for s, dev in enumerate(devs):
        if dev not in copies:
            with trace_span("Shard-Copy", device=fil_tc.device):
                trace_count("shard.copy_bytes", fil_tc.numel() * fil_tc.element_size())
                copies[dev] = fil_tc.to(dev)
        with device_context(dev):
            parts.append(dedisperse(
                copies[dev], delays[s * per : (s + 1) * per], killmask, out_nsamps,
                scale=scale,
            ))
    return ShardedRows(parts, ndm)
