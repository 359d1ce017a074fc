"""The port's native host library: the candidate distillers and the
reference's S/N sort in C++ (``host_kernels.cpp``), built with g++ at
first use and loaded with ctypes.

``PEASOUP_NO_NATIVE`` set to any non-empty value selects the pure-Python
distillers (pipeline/distill.py, and the per-trial loop of
pipeline/search.py); :func:`enabled` is then false. Otherwise the library
builds or :func:`load` raises with the compiler's message: there is no
quiet fallback.

The library is built into ``_build/`` beside the CUDA kernels (ignored by
git), under a name hashed from the source and the flags, through a
temporary file moved into place, so processes that build at once never
load a half-written file. :data:`calls` counts the calls of each entry
point; nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).with_name("host_kernels.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

calls: Counter = Counter()
_lib: ctypes.CDLL | None = None

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_L, _D, _I = ctypes.c_int64, ctypes.c_double, ctypes.c_int32

# C symbol -> (argtypes, restype)
_ENTRIES = {
    "ps_harmonic_distill": ([_f64p, _i32p, _L, _D, _I, _I, _I, _u8p, _i32p, _i32p, _L], _L),
    "ps_harmonic_distill_seg": ([_f64p, _i32p, _i64p, _L, _D, _I, _I, _u8p], None),
    "ps_accel_distill": ([_f64p, _f64p, _L, _D, _D, _I, _u8p, _i32p, _i32p, _L], _L),
    "ps_accel_distill_seg": ([_f64p, _f64p, _i64p, _L, _D, _D, _u8p, _i32p, _i32p, _L], _L),
    "ps_dm_distill": ([_f64p, _L, _D, _I, _u8p, _i32p, _i32p, _L], _L),
    "ps_snr_sort_perm": ([_f32p, _L, _i32p], None),
    "ps_snr_sort_perm_seg": ([_f32p, _i64p, _L, _i32p], None),
}


def enabled() -> bool:
    """False when ``PEASOUP_NO_NATIVE`` selects the pure-Python path."""
    return not os.environ.get("PEASOUP_NO_NATIVE")


def library_path() -> Path:
    cxx = os.environ.get("CXX", "g++")
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join((cxx, *CXX_FLAGS)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libpeasoup_host-{digest}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path. Raises
    with the compiler's output when the build fails."""
    target = library_path()
    if target.exists():
        return target
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(
            f"{cxx} not found: the native distil library cannot be built "
            "(set PEASOUP_NO_NATIVE=1 for the pure-Python distillers)"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"native distil library build failed:\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for symbol, (argtypes, restype) in _ENTRIES.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def _call(symbol: str, *args):
    calls[symbol] += 1
    return getattr(load(), symbol)(*args)


def snr_sort_perm(snrs: np.ndarray) -> np.ndarray:
    """The reference's candidate sort as a permutation: libstdc++
    std::sort (unstable introsort) on (snr, index) pairs with the
    ``x.snr > y.snr`` comparator of distiller.hpp:11-13."""
    snrs = np.ascontiguousarray(snrs, dtype=np.float32)
    perm = np.empty(len(snrs), dtype=np.int32)
    _call("ps_snr_sort_perm", snrs, len(snrs), perm)
    return perm


def snr_sort_perm_seg(snrs: np.ndarray, seg_off: np.ndarray) -> np.ndarray:
    """:func:`snr_sort_perm` of each segment [seg_off[s], seg_off[s+1]),
    as global row ids."""
    snrs = np.ascontiguousarray(snrs, dtype=np.float32)
    seg_off = np.ascontiguousarray(seg_off, dtype=np.int64)
    perm = np.empty(len(snrs), dtype=np.int32)
    _call("ps_snr_sort_perm_seg", snrs, seg_off, len(seg_off) - 1, perm)
    return perm


def _run_distill(symbol: str, args: tuple, n: int):
    """Run a distill entry point, growing the edge buffer on overflow.
    Returns (survivor mask, edge sources, edge targets)."""
    cap = max(4 * n, 1024)
    while True:
        src = np.empty(cap, np.int32)
        dst = np.empty(cap, np.int32)
        unique = np.empty(n, np.uint8)
        n_edges = _call(symbol, *args, unique, src, dst, cap)
        if n_edges <= cap:
            return unique.astype(bool), src[:n_edges], dst[:n_edges]
        cap = int(n_edges)


def harmonic_distill(freqs, nhs, tol, max_harm, fractional, keep_related):
    """One S/N-sorted candidate list's harmonic distil
    (distiller.hpp:63-108): (survivor mask, edge sources, edge targets)."""
    freqs = np.ascontiguousarray(freqs, dtype=np.float64)
    nhs = np.ascontiguousarray(nhs, dtype=np.int32)
    n = len(freqs)
    return _run_distill(
        "ps_harmonic_distill",
        (freqs, nhs, n, tol, max_harm, int(fractional), int(keep_related)), n,
    )


def harmonic_distill_seg(freqs, nhs, seg_off, tol, max_harm, fractional) -> np.ndarray:
    """The harmonic distil of every segment (an accel trial) in one call;
    rows S/N-sorted within each segment. Returns the survivor mask."""
    freqs = np.ascontiguousarray(freqs, dtype=np.float64)
    nhs = np.ascontiguousarray(nhs, dtype=np.int32)
    seg_off = np.ascontiguousarray(seg_off, dtype=np.int64)
    unique = np.empty(len(freqs), np.uint8)
    _call("ps_harmonic_distill_seg", freqs, nhs, seg_off, len(seg_off) - 1, tol,
          max_harm, int(fractional), unique)
    return unique.astype(bool)


def accel_distill(freqs, accs, tobs_over_c, tol, keep_related):
    """One S/N-sorted candidate list's acceleration distil
    (distiller.hpp:115-164)."""
    freqs = np.ascontiguousarray(freqs, dtype=np.float64)
    accs = np.ascontiguousarray(accs, dtype=np.float64)
    n = len(freqs)
    return _run_distill(
        "ps_accel_distill", (freqs, accs, n, tobs_over_c, tol, int(keep_related)), n
    )


def accel_distill_seg(freqs, accs, seg_off, tobs_over_c, tol):
    """The acceleration distil of every segment (a DM trial) in one call;
    rows S/N-sorted within each segment. Edges carry global row ids."""
    freqs = np.ascontiguousarray(freqs, dtype=np.float64)
    accs = np.ascontiguousarray(accs, dtype=np.float64)
    seg_off = np.ascontiguousarray(seg_off, dtype=np.int64)
    return _run_distill(
        "ps_accel_distill_seg",
        (freqs, accs, seg_off, len(seg_off) - 1, tobs_over_c, tol), len(freqs),
    )


def dm_distill(freqs, tol, keep_related):
    """One S/N-sorted candidate list's DM distil (distiller.hpp:168-197)."""
    freqs = np.ascontiguousarray(freqs, dtype=np.float64)
    n = len(freqs)
    return _run_distill("ps_dm_distill", (freqs, n, tol, int(keep_related)), n)
