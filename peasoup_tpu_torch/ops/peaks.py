"""Candidate peak extraction: thresholding and peak clustering.

Reference: device_find_peaks compacts (index, snr) pairs above threshold
(Thrust copy_if, src/kernels.cu:384-416); the host then clusters
neighbours within ``min_gap`` bins (PeakFinder::identify_unique_peaks,
include/transforms/peakfinder.hpp:27-56), with the quirk that
``lastidx`` advances only on a new maximum. The search window
[start_idx, limit) mirrors find_candidates (peakfinder.hpp:82-84).

:func:`find_harmonic_cluster_peaks` runs harmonic summing, thresholding
and clustering of every level in one call: the hand-written harmpeaks
kernel (csrc/harmpeaks.cu: sums and a crossing mask over the whole card,
then one warp walks each row's level) for CUDA tensors, the plain version
:func:`find_harmonic_cluster_peaks_plain` (harmonic_sums +
find_peaks_device + cluster_peaks_device) for CPU tensors.
:func:`find_cluster_peaks_multi` thresholds and clusters levels formed
apart (the search's ``PEASOUP_MEGA_HARM=0`` route): the peaks kernel
(csrc/peaks.cu: a crossing mask over the whole card, then harmpeaks' walk)
for CUDA tensors, :func:`find_cluster_peaks_multi_plain` for CPU tensors.
:func:`compact_peaks_device` and :func:`pack_chunk_results` gather the
valid cluster slots of many cells into one ragged stream on the device, so
the search reads a round's results back in one transfer.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..device import check, on_cpu, stream_ptr
from .harmonics import harmonic_sums

# the harmpeaks and peaks kernels' bin indices stay in int32, and their
# first phases take tiles of 1,024 bins (csrc/levels.cuh: kTile)
HARMPEAKS_MAX_BINS = 1 << 26
HARMPEAKS_TILE = 1024


def find_peaks_device(
    spec: torch.Tensor,  # (cells, nbins) spectrum or harmonic sum
    threshold: float,
    start_idx: torch.Tensor,  # (cells,) first bin to consider
    limit: torch.Tensor,  # (cells,) one-past-last bin
    *,
    max_peaks: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Threshold crossings ``s > threshold`` inside [start, limit) of each
    cell, ascending. Returns (idxs (cells, K) i64 padded with nbins, snrs
    (cells, K) f32 padded with 0, counts (cells,) i64, every crossing
    counted). With ``max_peaks`` K is max_peaks and the first max_peaks
    crossings are kept, the JAX package's semantics (its
    ops/peaks.py:find_peaks_device): the key -index of each crossing, the
    K largest in order, so nothing is read back to the host. Without it K
    is the largest count (at least 1), which the host reads."""
    cells, nbins = spec.shape
    i = torch.arange(nbins, device=spec.device)
    thr = torch.tensor(threshold, dtype=torch.float32, device=spec.device)
    mask = (i >= start_idx[:, None]) & (i < limit[:, None]) & (spec > thr)
    counts = mask.sum(dim=-1)
    if max_peaks is not None:
        k = min(max_peaks, nbins)
        none = -nbins - 1
        key = torch.where(mask, -i.to(torch.int32), none)
        kv, ki = torch.topk(key, k, dim=-1, sorted=True)
        valid = kv > none
        idxs = torch.where(valid, ki, nbins)
        snrs = torch.where(valid, torch.gather(spec, 1, ki), 0.0)
        if k < max_peaks:
            idxs = torch.nn.functional.pad(idxs, (0, max_peaks - k), value=nbins)
            snrs = torch.nn.functional.pad(snrs, (0, max_peaks - k))
        return idxs, snrs, counts
    k = max(int(counts.max()) if cells else 0, 1)
    cell, idx = mask.nonzero(as_tuple=True)  # row-major: ascending per cell
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(cell.numel(), device=spec.device) - starts[cell]
    idxs = torch.full((cells, k), nbins, dtype=torch.int64, device=spec.device)
    snrs = torch.zeros((cells, k), dtype=torch.float32, device=spec.device)
    idxs[cell, pos] = idx
    snrs[cell, pos] = spec[cell, idx]
    return idxs, snrs, counts


def cluster_peaks_device(
    idxs: torch.Tensor,  # (cells, K) ascending crossings, padded with nbins
    snrs: torch.Tensor,  # (cells, K) f32
    counts: torch.Tensor,  # (cells,) valid crossings per cell
    *,
    nbins: int,
    min_gap: int = 30,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """identify_unique_peaks over every cell at once: one walk along the
    crossing axis with all cells in parallel, and one trailing step that
    closes the last open cluster. Returns (cluster idxs (cells, K)
    padded with nbins, cluster snrs (cells, K) padded with 0, cluster
    count (cells,))."""
    cells, k = idxs.shape
    dev = idxs.device
    open_ = torch.zeros(cells, dtype=torch.bool, device=dev)
    cpeak = torch.zeros(cells, dtype=torch.float32, device=dev)
    cpeakidx = torch.zeros(cells, dtype=torch.int64, device=dev)
    lastidx = torch.zeros(cells, dtype=torch.int64, device=dev)
    cursor = torch.zeros(cells, dtype=torch.int64, device=dev)
    cidx = torch.full((cells, k + 1), nbins, dtype=torch.int64, device=dev)
    csnr = torch.zeros((cells, k + 1), dtype=torch.float32, device=dev)
    for j in range(k + 1):
        if j < k:
            idx, snr = idxs[:, j], snrs[:, j]
            valid = counts > j
        else:  # flush the open clusters
            idx, snr = lastidx, cpeak
            valid = torch.zeros_like(open_)
        close = open_ & (~valid | (idx - lastidx >= min_gap))
        # a cell that closes no cluster writes to column k, which no
        # cluster reaches (a cell holds at most k), so nothing syncs
        at = torch.where(close, cursor, k)[:, None]
        cidx.scatter_(1, at, cpeakidx[:, None])
        csnr.scatter_(1, at, cpeak[:, None])
        cursor = cursor + close
        start = (~open_ | close) & valid
        take = start | (open_ & ~close & valid & (snr > cpeak))
        cpeak = torch.where(take, snr, cpeak)
        cpeakidx = torch.where(take, idx, cpeakidx)
        lastidx = torch.where(take, idx, lastidx)
        open_ = (open_ & valid) | start
    return cidx[:, :k], csnr[:, :k], cursor


def compact_peaks_device(
    idxs: torch.Tensor,  # (..., mp) cluster slots
    snrs: torch.Tensor,  # (..., mp) f32
    ccounts: torch.Tensor,  # (...) valid slots per cell (may exceed mp)
    *,
    total_pad: int,
) -> torch.Tensor:
    """The valid (idx, snr) slots of every cell in one ragged stream, for
    one device-to-host transfer: a flat (2*total_pad,) int32, the first
    total_pad words the idxs and the rest the snrs' bits, each cell's first
    min(ccount, mp) slots in order, cells in C order, zeros past the total
    (the JAX package's ops/peaks.py:compact_peaks_device, word for word).
    The gather map is made on the device from the counts, so nothing is
    read back to size it."""
    mp = idxs.shape[-1]
    dev = idxs.device
    cc = torch.clamp(ccounts.reshape(-1).to(torch.int64), max=mp)
    if cc.numel() == 0:
        return torch.zeros(2 * total_pad, dtype=torch.int32, device=dev)
    ends = torch.cumsum(cc, 0)
    pos = torch.arange(total_pad, device=dev)
    cell = torch.searchsorted(ends, pos, right=True).clamp_(max=cc.numel() - 1)
    within = (pos - (ends - cc)[cell]).clamp_(0, mp - 1)
    stacked = torch.stack([
        idxs.reshape(-1).to(torch.int32),
        snrs.reshape(-1).to(torch.float32).view(torch.int32),
    ])
    out = torch.where(pos < ends[-1], stacked[:, cell * mp + within], 0)
    return out.reshape(-1)


def pack_chunk_results(
    idxs: torch.Tensor,
    snrs: torch.Tensor,
    counts: torch.Tensor,
    ccounts: torch.Tensor,
    *,
    total_pad: int,
) -> torch.Tensor:
    """One transfer's payload, int32: [raw counts | cluster counts | the
    ragged stream of :func:`compact_peaks_device` at ``total_pad``] (the JAX
    package's ops/peaks.py:pack_chunk_results)."""
    return torch.cat([
        counts.reshape(-1).to(torch.int32),
        ccounts.reshape(-1).to(torch.int32),
        compact_peaks_device(idxs, snrs, ccounts, total_pad=total_pad),
    ])


def _clamped_windows(windows, nbins: int, nlev: int) -> np.ndarray:
    w = np.asarray(windows, dtype=np.int32).reshape(-1, 2).copy()
    if w.shape[0] != nlev:
        raise ValueError("windows must cover nharms+1 levels")
    # the pad past the true nbins is garbage: no window may reach it
    w[:, 1] = np.minimum(w[:, 1], nbins)
    return w


def find_cluster_peaks_multi_plain(
    levels,
    windows,
    *,
    threshold: float,
    max_peaks: int,
    scales: tuple,
    min_gap: int = 30,
    nbins: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`find_cluster_peaks_multi`:
    find_peaks_device + cluster_peaks_device on every scaled level."""
    nlev = len(levels)
    rows = levels[0].shape[0]
    dev = levels[0].device
    nbins = levels[0].shape[-1] if nbins is None else nbins
    w = torch.from_numpy(_clamped_windows(windows, nbins, nlev)).to(dev)
    scaled = [
        lv[:, :nbins] * torch.tensor(sc, dtype=torch.float32, device=dev)
        for lv, sc in zip(levels, scales)
    ]
    flat = torch.stack(scaled, dim=1).reshape(rows * nlev, nbins)
    lo = w[:, 0].to(torch.int64).repeat(rows)
    hi = w[:, 1].to(torch.int64).repeat(rows)
    ri, rs, counts = find_peaks_device(flat, threshold, lo, hi)
    ci, cs, cc = cluster_peaks_device(ri, rs, counts, nbins=nbins, min_gap=min_gap)
    k = ci.shape[1]
    if k < max_peaks:
        ci = torch.nn.functional.pad(ci, (0, max_peaks - k), value=nbins)
        cs = torch.nn.functional.pad(cs, (0, max_peaks - k))
    return (
        ci[:, :max_peaks].to(torch.int32).reshape(rows, nlev, max_peaks),
        cs[:, :max_peaks].reshape(rows, nlev, max_peaks),
        counts.to(torch.int32).reshape(rows, nlev),
        cc.to(torch.int32).reshape(rows, nlev),
    )


def find_cluster_peaks_multi(
    levels,  # nlev (rows, npad) f32 level rows, level 0 the spectrum
    windows,  # (nlev, 2) int [start, limit) per level
    *,
    threshold: float,
    max_peaks: int,
    scales: tuple,  # per-level factors applied before the threshold
    min_gap: int = 30,
    nbins: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Threshold + cluster walk of every level. Returns (idxs (rows, nlev,
    max_peaks) i32 padded with nbins, snrs f32 padded with 0, raw counts
    (rows, nlev) i32, cluster counts (rows, nlev) i32). ``nbins`` is the
    true bin count: windows are clamped to it, so the padding past it
    (garbage in block-aligned harmonic sums) never crosses. Clusters past
    ``max_peaks`` are counted and dropped. CUDA tensors go through the
    peaks kernel (bitwise equal to the plain version), CPU tensors through
    :func:`find_cluster_peaks_multi_plain`."""
    nlev = len(levels)
    if not 0 < nlev <= 6:
        raise ValueError("levels must hold 1..6 level arrays")
    if len(scales) != nlev:
        raise ValueError("scales must cover every level")
    if on_cpu(*levels):
        return find_cluster_peaks_multi_plain(
            levels, windows, threshold=threshold, max_peaks=max_peaks,
            scales=scales, min_gap=min_gap, nbins=nbins,
        )
    for h, lv in enumerate(levels):
        check(lv, f"levels[{h}]", torch.float32, 2)
        if lv.shape != levels[0].shape:
            raise ValueError("every level must have the shape of level 0")
    rows, npad = levels[0].shape
    nbins = npad if nbins is None else nbins
    if not 0 < nbins <= npad:
        raise ValueError(f"nbins={nbins} outside the row of {npad}")
    if npad >= HARMPEAKS_MAX_BINS or npad % 4:
        raise ValueError(
            f"the peaks kernel takes rows of a multiple of 4 bins below "
            f"{HARMPEAKS_MAX_BINS}, not {npad}"
        )
    if any(lv.data_ptr() % 16 for lv in levels):
        raise ValueError("the peaks kernel reads 16-byte aligned level rows")
    dev = levels[0].device
    # windows and scales go to the kernels by value, from host memory
    w = np.ascontiguousarray(_clamped_windows(windows, nbins, nlev))
    sc = np.asarray(scales, dtype=np.float32)
    idxs = torch.empty((rows, nlev, max_peaks), dtype=torch.int32, device=dev)
    snrs = torch.empty((rows, nlev, max_peaks), dtype=torch.float32, device=dev)
    counts = torch.empty((rows, nlev), dtype=torch.int32, device=dev)
    ccounts = torch.empty((rows, nlev), dtype=torch.int32, device=dev)
    # the kernel's scratch: the crossing mask, one bit a bin and level,
    # ldm words a level over tiles of HARMPEAKS_TILE bins (harmpeaks' layout)
    ldm = 32 * (-(-npad // HARMPEAKS_TILE))
    mask = torch.empty(rows * nlev * ldm, dtype=torch.int32, device=dev)
    ptrs = [lv.data_ptr() for lv in levels] + [None] * (6 - nlev)
    kernels.launch(
        "peaks", *ptrs, rows, npad, nbins, nlev, w.ctypes.data, sc.ctypes.data,
        float(np.float32(threshold)), min_gap, max_peaks, mask.data_ptr(), ldm,
        idxs.data_ptr(), snrs.data_ptr(), counts.data_ptr(), ccounts.data_ptr(),
        stream_ptr(dev), shape=(rows, npad, nlev, max_peaks),
    )
    return idxs, snrs, counts, ccounts


def find_harmonic_cluster_peaks_plain(
    spec: torch.Tensor,
    windows,
    *,
    nharms: int,
    threshold: float,
    max_peaks: int,
    scales: tuple,
    min_gap: int = 30,
    nbins: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`find_harmonic_cluster_peaks`."""
    nbins = spec.shape[-1] if nbins is None else nbins
    s = spec[:, :nbins]
    return find_cluster_peaks_multi_plain(
        [s, *harmonic_sums(s, nharms=nharms, scaled=False)], windows,
        threshold=threshold, max_peaks=max_peaks, scales=scales,
        min_gap=min_gap, nbins=nbins,
    )


def find_harmonic_cluster_peaks(
    spec: torch.Tensor,  # (rows, npad) f32 normalised spectrum, padded
    windows,  # (nharms+1, 2) int [start, limit) per level
    *,
    nharms: int,
    threshold: float,
    max_peaks: int,
    scales: tuple,  # per-level factors, level 0 first
    min_gap: int = 30,
    nbins: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Harmonic sums + threshold + cluster walk of every level. Returns
    (idxs (rows, nlev, max_peaks) i32 padded with nbins, snrs f32 padded
    with 0, raw counts (rows, nlev) i32, cluster counts (rows, nlev) i32);
    nlev = nharms + 1. ``nbins`` is the true bin count: windows are
    clamped to it, so the padding past it never crosses. Clusters past
    ``max_peaks`` are counted and dropped."""
    if not 0 < nharms <= 5:
        raise ValueError("nharms must be in 1..5")
    if len(scales) != nharms + 1:
        raise ValueError("scales must cover nharms+1 levels")
    if on_cpu(spec):
        return find_harmonic_cluster_peaks_plain(
            spec, windows, nharms=nharms, threshold=threshold,
            max_peaks=max_peaks, scales=scales, min_gap=min_gap, nbins=nbins,
        )
    check(spec, "spec", torch.float32, 2)
    rows, npad = spec.shape
    nbins = npad if nbins is None else nbins
    if not 0 < nbins <= npad:
        raise ValueError(f"nbins={nbins} outside the row of {npad}")
    if npad >= HARMPEAKS_MAX_BINS:
        raise ValueError(f"harmpeaks takes rows of fewer than {HARMPEAKS_MAX_BINS} bins")
    nlev = nharms + 1
    dev = spec.device
    # windows and scales go to the kernels by value, from host memory
    w = np.ascontiguousarray(_clamped_windows(windows, nbins, nlev))
    sc = np.asarray(scales, dtype=np.float32)
    idxs = torch.empty((rows, nlev, max_peaks), dtype=torch.int32, device=dev)
    snrs = torch.empty((rows, nlev, max_peaks), dtype=torch.float32, device=dev)
    counts = torch.empty((rows, nlev), dtype=torch.int32, device=dev)
    ccounts = torch.empty((rows, nlev), dtype=torch.int32, device=dev)
    # the kernel's scratch, in one allocation, over tiles of HARMPEAKS_TILE
    # bins: the crossing mask (one bit a bin and level, ldm words a level)
    # and the values of the first crossings of each level in each span of
    # 128 bins (8 slots, 2 ldm a level)
    ldm = 32 * (-(-npad // HARMPEAKS_TILE))
    scratch = torch.empty(rows * nlev * 3 * ldm, dtype=torch.int32, device=dev)
    mask = scratch.data_ptr()
    vals = mask + 4 * rows * nlev * ldm
    kernels.launch(
        "harmpeaks", spec.data_ptr(), rows, npad, nbins, nharms, w.ctypes.data,
        sc.ctypes.data, float(np.float32(threshold)), min_gap, max_peaks,
        mask, vals, ldm, idxs.data_ptr(), snrs.data_ptr(),
        counts.data_ptr(), ccounts.data_ptr(), stream_ptr(dev),
        shape=(rows, npad, nharms, max_peaks),
    )
    return idxs, snrs, counts, ccounts
