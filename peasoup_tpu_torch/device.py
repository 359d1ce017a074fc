"""Device selection and the checks every kernel wrapper makes.

A kernel wrapper takes its plain torch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises. The checks below
are what it raises on.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a torch.device; asking for CUDA where there is none
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every one lies
    on one CUDA device; anything else raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on more than one device: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """A kernel operand must have this dtype and rank and be contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_ptr(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def device_context(device: torch.device):
    """``device`` as the current CUDA device for the duration (a kernel is
    launched on the current device, and its stream must belong to it), or
    nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()
