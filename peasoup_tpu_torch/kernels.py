"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``_build/`` (beside this file, ignored by git) and loaded
with ``ctypes``; every pointer and the stream pass as ``c_void_p``.
A library's file name carries a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is reused. :func:`build`
compiles several sources at once, one ``nvcc`` process each.

Each C entry returns ``cudaGetLastError()`` after its launch, and
:func:`launch` raises when it is not 0. :data:`launches` counts the
launches of each kernel, and :data:`launch_shapes` how often each launch
shape was used; :func:`launch` is the only place either grows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

# no --use_fast_math (IEEE division and sqrt), and no FMA contraction, so
# every kernel replays its plain version's f32 expression trees
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# kernel name -> (C symbol, argtypes); every entry ends with the stream
_ENTRIES = {
    "dedisperse": ("dedisperse_u8", [_P, _P, _P, _P, _L, _I, _I, _L, _F, _I, _P]),
    "resample": ("resample_rows", [_P, _P, _P, _P, _L, _L, _P]),
    "specchain": ("specchain", [_P, _P, _P, _P, _P, _P, _P, _L, _L, _P]),
    "interbin": (
        "untwist_interbin_normalise", [_P, _P, _P, _P, _P, _P, _L, _L, _L, _P],
    ),
    "harmpeaks": (
        "harmpeaks",
        [_P, _L, _L, _I, _I, _P, _P, _F, _I, _I, _P, _P, _P, _P, _P],
    ),
}
KERNELS = tuple(_ENTRIES)

launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
launch_shapes: dict[str, Counter] = {name: Counter() for name in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
        launch_shapes[name].clear()


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        source(name).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Returns the build wall time in
    seconds per kernel built (0.0 for one already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    times: dict[str, float] = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            times[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            ),
            tmp, target, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: {out.decode(errors='replace')}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return times


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = _ENTRIES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(name: str, *args, shape: tuple) -> None:
    """Call kernel ``name``'s C entry (which launches on the stream given
    as its last argument) and count the launch under its ``shape`` (the
    sizes the wrapper passes); raise on a CUDA error."""
    fn = getattr(_load(name), _ENTRIES[name][0])
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    launch_shapes[name][shape] += 1
