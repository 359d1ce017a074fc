"""DM-trial-sharded acceleration search over a device mesh: the JAX
package's parallel/sharded_search.py.

The reference runs one share-nothing worker per GPU over a dealt DM list
(src/pipeline_multi.cu:33-81,342-359). Here each shard of the mesh's 'dm'
axis holds its own DM trials' preprocessed series on its own device, and
a row batch of the search is split by shard: every shard's rows run the
port's batched chain (pipeline/accel_search.py:search_rows, its kernels
launched on that shard's device), all shards are dispatched before any
result is read back, and the cluster peaks come back to the host in
shard order, which is row order. There is no communication between
shards in the search itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_context
from ..pipeline.accel_search import AccelSearchPeaks, search_rows
from .mesh import Mesh
from .sharded_dedisperse import ShardedRows


def make_sharded_search_fn(
    mesh: Mesh,
    threshold: float,
    axis: str = "dm",
    *,
    fused_dft: bool = False,
    mega_harm: bool = True,
):
    """A function ``(jobs, windows, *, nharms, max_peaks) ->
    AccelSearchPeaks`` over the shards of ``axis``. ``jobs`` holds one
    entry per shard: None for a shard with no rows in this batch, else the
    arguments of :func:`search_rows` before ``windows``, (xd, row_dm,
    afs, mean, std), on the shard's device. The result is numpy, the rows
    of every shard concatenated in shard order. ``fused_dft`` and
    ``mega_harm`` are the chain's routes
    (pipeline/search.py:choose_routes)."""
    devices = mesh.axis_devices(axis)

    def sharded_search(jobs, windows, *, nharms: int, max_peaks: int) -> AccelSearchPeaks:
        if len(jobs) != len(devices):
            raise ValueError(f"{len(jobs)} jobs for {len(devices)} shards")
        out = []
        for dev, job in zip(devices, jobs):
            if job is None:
                continue
            with device_context(dev):
                out.append(search_rows(
                    *job, windows, threshold=threshold, nharms=nharms,
                    max_peaks=max_peaks, fused_dft=fused_dft, mega_harm=mega_harm,
                ))
        # every shard is queued before the first copy back waits
        return AccelSearchPeaks(*(
            np.concatenate([getattr(p, f).cpu().numpy() for p in out])
            for f in AccelSearchPeaks._fields
        ))

    return sharded_search


def place_trials(mesh: Mesh, trials, axis: str = "dm") -> ShardedRows:
    """A (D, N) trial block (a tensor or numpy) split in contiguous row
    blocks over ``axis``'s devices, D padded to a multiple of the shard
    count with copies of its last row."""
    t = torch.as_tensor(np.asarray(trials)) if isinstance(trials, np.ndarray) else trials
    devs = mesh.axis_devices(axis)
    per = -(-t.shape[0] // len(devs))
    if per * len(devs) > t.shape[0]:
        t = torch.cat([t, t[-1:].expand(per * len(devs) - t.shape[0], -1)])
    return ShardedRows(
        [t[s * per : (s + 1) * per].to(dev) for s, dev in enumerate(devs)], len(trials)
    )
