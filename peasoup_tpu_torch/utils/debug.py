"""Debug buffer dumps.

Reference: ``Utils::dump_device_buffer`` / ``dump_host_buffer``
(include/utils/utils.hpp:62-80) copy a device buffer to the host and
write its raw bytes to a file for offline numpy comparison. Here a
tensor on any device (or any array-like) dumps the same way; read back
with ``np.fromfile(path, dtype=...)``.
"""

from __future__ import annotations

import numpy as np
import torch


def dump_buffer(arr, path: str) -> None:
    """Write the raw little-endian bytes of ``arr`` (a tensor on any
    device, or a host array) to ``path``: the reference's dump format."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    host = np.asarray(arr)
    if host.dtype.byteorder == ">":
        host = host.astype(host.dtype.newbyteorder("<"))
    with open(path, "wb") as f:
        f.write(host.tobytes())
