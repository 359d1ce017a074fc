"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``_build/`` (beside this file, ignored by git) and loaded
with ``ctypes``; every pointer and the stream pass as ``c_void_p``.
A library's file name carries a hash of its source, of the headers
under ``csrc/`` (``*.cuh``, which sources share) and of the flags, so an
edited source or header is rebuilt and an unchanged one is reused. :func:`build`
compiles several sources at once, one ``nvcc`` process each.

Each C entry returns ``cudaGetLastError()`` after its launch, or a
negative code where it refuses arguments its wrapper leaves it to check
(:data:`REFUSALS`), and :func:`launch` raises when it is not 0. :data:`launches` counts the
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
    "dedisperse": (
        "dedisperse_u8", [_P, _L, _I, _P, _I, _P, _P, _I, _I, _I, _P, _I, _L, _F, _I, _P],
    ),
    "resample": ("resample_rows", [_P, _P, _P, _P, _L, _L, _P]),
    "specchain": ("specchain", [_P, _P, _P, _P, _P, _P, _P, _L, _L, _P]),
    "interbin": (
        "untwist_interbin_normalise", [_P, _P, _P, _P, _P, _P, _L, _L, _L, _P],
    ),
    "dftspec": ("dft_untwist_interbin", [_P] * 6 + [_L, _I, _L, _P]),
    "peaks": (
        "cluster_peaks_multi",
        [_P] * 6 + [_L, _L, _I, _I, _P, _P, _F, _I, _I, _P, _L, _P, _P, _P, _P, _P],
    ),
    "harmpeaks": (
        "harmpeaks",
        [_P, _L, _L, _I, _I, _P, _P, _F, _I, _I, _P, _P, _L, _P, _P, _P, _P, _P],
    ),
    "boxcar": ("boxcar_best", [_P, _P, _P, _I, _L, _L, _L, _L, _P, _P, _P]),
    "spchain": (
        "boxcar_dec_best", [_P, _P, _P, _I, _L, _L, _L, _L, _I, _P, _P, _P, _P],
    ),
}
KERNELS = tuple(_ENTRIES)

# (kernel, negative return code) -> why its entry refused the arguments
_RING = ("the widest boxcar's window does not fit the kernel's shared-memory ring "
         "(widths up to ~53k samples); use narrower widths")
_ROWS = "the prefix-sum rows 16-byte aligned and a multiple of 4 samples long"
REFUSALS = {
    ("spchain", -1): _RING,
    ("spchain", -2): f"tpad must be a multiple of 512 and of dec, and {_ROWS}",
    ("boxcar", -1): _RING,
    ("boxcar", -2): f"tpad must be a multiple of 512, and {_ROWS}",
}

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
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        source(name).read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
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
    if procs:
        # the run's telemetry counts the libraries it built (its manifest's
        # "jit" section stays empty: nothing is compiled per shape)
        from .obs.telemetry import current

        current().incr("kernels.library_builds", len(procs))
    return times


def _resources(fn, variants) -> dict[str, dict[str, int]]:
    """Registers a thread, local memory a thread (spills) and static shared
    memory a block of each of a kernel's template variants, as the runtime
    reports them for the loaded binary (``cudaFuncGetAttributes``, through
    the library's ``<kernel>_attributes(variant, ...)``)."""
    fn.argtypes = [_I] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = _I
    out = {}
    for variant, label in variants:
        vals = [ctypes.c_int(0) for _ in range(3)]
        rc = fn(variant, *(ctypes.byref(v) for v in vals))
        if rc != 0:
            raise RuntimeError(f"{fn.__name__} returned CUDA error {rc}")
        out[label] = dict(zip(("registers", "local_bytes", "static_shared_bytes"),
                              (v.value for v in vals)))
    return out


def boxcar_resources(lib: ctypes.CDLL | None = None) -> dict[str, dict[str, int]]:
    """:func:`_resources` of the boxcar kernel, for its contiguous ring and
    its wrapping one. ``lib``: another build of ``boxcar.cu`` (default: the
    port's)."""
    return _resources((lib or _load("boxcar")).boxcar_attributes,
                      ((0, "contiguous ring"), (1, "wrapping ring")))


def dedisperse_resources(lib: ctypes.CDLL | None = None) -> dict[str, dict[str, int]]:
    """:func:`_resources` of the dedisperse kernel, for its variant past 256
    kept channels (32-bit sums beside the 16-bit lanes) and the one below.
    ``lib``: another build of ``dedisperse.cu`` (default: the port's)."""
    return _resources((lib or _load("dedisperse")).dedisperse_attributes,
                      ((1, "past 256 channels"), (0, "to 256 channels")))


def dedisperse_wide_staging(log_chunk: int, nchans: int, x_ptr: int) -> bool:
    """Whether the dedisperse kernel stages the chunks of an input at
    address ``x_ptr`` with 16-byte loads, as its C entry decides it
    (``dedisp_map.cuh:wide_staging``, through ``dedisperse_wide_staging``)."""
    fn = _load("dedisperse").dedisperse_wide_staging
    fn.argtypes = [_I, _I, _P]
    fn.restype = _I
    return bool(fn(log_chunk, nchans, x_ptr))


def build_variants(name: str, builds: dict, tmp: str) -> dict[str, ctypes.CDLL]:
    """Builds of kernel ``name`` outside the port's own (for probes that
    measure variants): ``builds`` maps a label to (source, macros), a
    ``.cu`` file compiled against ``csrc/``'s headers and the macros nvcc
    defines for it. One nvcc a build, all started together, each library
    written into the directory ``tmp``. Returns the loaded libraries by
    label, each with the kernel's C entry typed as :func:`launch` types it."""
    nvcc = _nvcc()
    procs = {
        label: subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(f"-D{m}" for m in macros), "-I", str(CSRC),
             "-o", os.path.join(tmp, f"{label}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for label, (src, macros) in builds.items()
    }
    symbol, argtypes = _ENTRIES[name]
    libs = {}
    for label, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on build {label} of {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(tmp, f"{label}.so"))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[label] = lib
    return libs


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


def load(names=KERNELS) -> None:
    """Build (where missing) and load every named kernel's library, so no
    later launch waits for ``nvcc``."""
    build(names)
    for name in names:
        _load(name)


def launch(name: str, *args, shape: tuple) -> None:
    """Call kernel ``name``'s C entry (which launches on the stream given
    as its last argument) and count the launch under its ``shape`` (the
    sizes the wrapper passes); raise on a CUDA error."""
    fn = getattr(_load(name), _ENTRIES[name][0])
    rc = fn(*args)
    if rc < 0:
        raise ValueError(f"{name} kernel refused {shape}: {REFUSALS.get((name, rc), rc)}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    launch_shapes[name][shape] += 1
