"""Device meshes: the JAX package's parallel/mesh.py over torch devices.

The reference's parallelism is one pthread per GPU pulling DM-trial
indices from a mutex-protected dispenser (src/pipeline_multi.cu:33-81).
Here a :class:`Mesh` lays devices out on named axes ('dm' for DM trials,
'beam' for multibeam ensembles, 'seq' for a series split over devices),
and work is dealt to them statically, in contiguous blocks, so a run is
deterministic.

An explicit device list may repeat a device: ``[cpu] * 8`` is the tests'
8-shard mesh on one CPU (the JAX package's tests force 8 virtual CPU
devices for the same purpose), ``[cuda:0] * 2`` two shards on one card.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """Devices on named axes: ``devices`` is an object array of
    torch.device whose dimensions are ``axis_names``; ``processes`` holds
    the rank of the process that owns each device (0 everywhere in one
    process)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple, processes=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if processes is None:
            processes = np.zeros(devices.shape, dtype=np.int64)
        self.processes = np.asarray(processes, dtype=np.int64).reshape(devices.shape)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: one
        per shard of that axis."""
        pos = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[pos] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """This process's devices of ``device``'s type: every visible card
    for CUDA, the one CPU device otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def device_count(device: str | torch.device = "cuda") -> int:
    return len(local_devices(device))


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh; the default is every local device on one 'dm' axis.

    ``axes`` maps axis name -> size, e.g. {'beam': 2, 'dm': 4}. Sizes
    must multiply to the device count (-1 means "the rest").
    """
    devices = list(devices if devices is not None else local_devices())
    if axes is None:
        axes = {"dm": len(devices)}
    names = list(axes)
    sizes = [axes[n] for n in names]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} do not cover {len(devices)} devices"
        )
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(sizes), tuple(names))
