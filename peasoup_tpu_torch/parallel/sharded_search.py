"""DM-trial-sharded acceleration search over a device mesh: the JAX
package's parallel/sharded_search.py.

The reference runs one share-nothing worker per GPU over a dealt DM list
(src/pipeline_multi.cu:33-81,342-359). Here each shard of the mesh's 'dm'
axis holds its own DM trials' preprocessed series on its own device, and
a row batch of the search is split by shard: every shard's rows run the
port's batched chain (pipeline/accel_search.py:search_rows, its kernels
launched on that shard's device), and each shard's cluster peaks stay on
its device: the search (pipeline/search.py:PeasoupSearch._fetch_wave)
packs a round's batches of each shard and reads them back in one
transfer, every shard queued before the first waits. There is no
communication between shards in the search itself.

Under a profiler each shard's :func:`search_rows` call is the span
``Shard-Feed`` (utils/trace.py; the host's wall seconds feeding that
card, its stream seconds read there), and adds the batch's rows to the
shard's counter ``shard.rows.<i>``, so that the counters of a run sum to
its ``rows.dispatched``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_context
from ..pipeline.accel_search import AccelSearchPeaks, search_rows
from ..utils import trace_count, trace_span
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
    list[AccelSearchPeaks | None]`` over the shards of ``axis``. ``jobs``
    holds one entry per shard: None for a shard with no rows in this batch,
    else (xd, row_dm, afs, mean, std, row_bounds): the arguments of
    :func:`search_rows` before ``windows``, on the shard's device, and its
    ``row_bounds`` (row_dm's bounds known on the host, or None). The result
    holds each shard's peaks on its device (None where its job is None),
    nothing read back. ``fused_dft`` and ``mega_harm`` are the chain's
    routes (pipeline/search.py:choose_routes)."""
    devices = mesh.axis_devices(axis)
    row_counters = [f"shard.rows.{i}" for i in range(len(devices))]

    def sharded_search(jobs, windows, *, nharms: int,
                       max_peaks: int) -> list[AccelSearchPeaks | None]:
        if len(jobs) != len(devices):
            raise ValueError(f"{len(jobs)} jobs for {len(devices)} shards")
        out = []
        for dev, job, rows in zip(devices, jobs, row_counters):
            if job is None:
                out.append(None)
                continue
            *args, row_bounds = job
            with device_context(dev), trace_span("Shard-Feed", device=dev):
                trace_count(rows, len(args[1]))
                out.append(search_rows(
                    *args, windows, threshold=threshold, nharms=nharms,
                    max_peaks=max_peaks, fused_dft=fused_dft, mega_harm=mega_harm,
                    row_bounds=row_bounds,
                ))
        return out

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
