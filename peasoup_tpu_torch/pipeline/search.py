"""The host side of the search: the reference's `peasoup` main + Worker loop
(reference: src/pipeline_multi.cu:262-419, 83-254) on one or more CUDA
devices.

The DM trials are dedispersed on the device and stay there (or in host
RAM, below). Blocks of DM trials are preprocessed together, and their
(DM, accel) trials run as row batches of the acceleration chain
(pipeline/accel_search.py), sized from the device's free memory. Each
round of DM blocks runs as one wave, the JAX package's host-to-device
protocol: every row batch is dispatched with nothing read back, and each
shard's cluster peaks are compacted on its device and fetched in one
transfer at the round's end (ops/peaks.py:pack_chunk_results; the
batches whose clusters overflowed their slots are dispatched again). On
the host, candidate building, distilling and scoring run on small
arrays, as in the reference: the per-DM distil in the native library
(peasoup_tpu_torch/native, built with g++ at first use), or in Python
where ``PEASOUP_NO_NATIVE=1`` asks for it.

With npdmp > 0 the top candidates are folded and optimised
(pipeline/folder.py) from the dedispersed trials the search kept.

The spectrum and peaks routes of the acceleration chain are decided once
per run (:func:`choose_routes`), as the JAX package decides them on a
TPU whose kernel probes pass; its switches ``PEASOUP_FUSED_DFT=0`` (or
``PEASOUP_FUSED_FFT=0``) and ``PEASOUP_MEGA_HARM=0`` turn the fused
routes off here too.

Dedispersion takes the JAX package's engines: the dedisperse kernel,
two-stage subband dedispersion (``subbands > 0``, its stages as scans or,
with ``subband_matmul``, as banded contractions) or the banded-matmul
engine (``dedisp_engine="matmul"``), the last two plain torch
(ops/dedisperse.py). Trials whose block would pass
``TRIALS_DEVICE_LIMIT`` bytes stay in host RAM and upload a DM block at a
time. With ``checkpoint_file`` the per-DM results are saved after each DM
block and restored on the next run, which searches only what is missing
and skips dedispersion when nothing is (and nothing is folded). An
out-of-memory error on the card steps down the JAX package's memory
ladder, the rungs a card has: halve the DM block (and its row batches)
while it can, then free the card's trials, dedisperse again into host
RAM through the dedisperse kernel (segment by segment) and size the
blocks afresh; past that it raises. Each step is recorded as the JAX
package records it (the ``search.memory`` DegradationLadder, the
``oom_*`` events), and the ``device.oom`` fault seam fires at each
attempt.

The run records the JAX package's telemetry through the ambient
RunTelemetry (obs/telemetry.py; a no-op unless a CLI activated one): its
stages, gauges and events (``device_plan``, ``accel_dedupe``,
``wave_plan``, ``max_peaks_escalated``, ``checkpoint_resume``, ...), and
its stages run under the JAX package's named scopes as spans
(utils/trace.py:trace_span; ``torch.profiler.record_function`` scopes
while a profiler records, tools/scope_trace.py). Under a profiler the run
is the root span ``Search``, whose table also holds the port's own spans
(``Upload``, ``Whitening``, ``Wave-Fetch``, ``Fetch``, ``Search-Host``,
its three ``Distil-*`` parts, ``Distilling``, ``Scoring``) and counters
(``upload.bytes``, ``whitening.trials``, ``wave.*``, ``rows.*``,
``distil.*``), apart from the telemetry. ``progress_bar`` draws a
ProgressBar on stderr over the DM waves.

The DM trials are sharded over the devices :func:`_pick_devices` picks
(every local card up to ``max_num_threads``, as the reference runs one
worker per GPU; ``shard_devices`` or an explicit ``devices=`` list
otherwise): each shard dedisperses a contiguous 1/n of them with the
dedisperse kernel on its device (parallel/sharded_dedisperse.py) and
searches its own blocks there (parallel/sharded_search.py). With
``run(dm_slice=(lo, hi), finalize=False)`` a process of a multi-process
run searches its slice of the global DM list only
(parallel/multihost.py:run_search merges the slices and passes
:meth:`PeasoupSearch.finalize` its fold exchange).

With ``tune`` (``--tune``), no ``subbands`` and no ``dedisp_engine``, the
dedispersion plan of the observation's shape bucket comes from the
per-device tuning cache, measured on the card on a cold bucket
(perf/tuning.py, the JAX package's pipeline/search.py:540-599): a subband
plan sets the subband count, smear and stages, and the DM-scaled per-trial
smear budgets the planner grouped under, rebuilt on this observation's own
DM list; a matmul plan runs the banded-matmul engine; the plan's
``dedisp_block`` sizes the host-RAM segments, its ``dm_block`` caps the
automatic DM block (the memory ladder still halves it) where ``dm_block``
is 0, and its ``accel_bucket`` replaces the default one. A failed
measurement fails the run.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import native
from ..core.candidates import Candidate
from ..device import device_context, resolve_device
from ..io.masks import read_killfile, read_zapfile
from ..io.sigproc import Filterbank
from ..obs.log import get_logger
from ..obs.telemetry import current as current_telemetry
from ..obs.trace import job_span
from ..ops.dedisperse import (
    dedisperse, dedisperse_host, dedisperse_matmul, dedisperse_subband,
    fil_to_device, output_scale,
)
from ..ops.dftspec import dftspec_supported
from ..ops.peaks import compact_peaks_device, pack_chunk_results
from ..ops.resample import accel_factor, choose_block, select_span
from ..ops.zap import birdie_mask
from ..parallel.mesh import local_devices, make_mesh
from ..parallel.sharded_dedisperse import ShardedRows, dedisperse_sharded, shard_bounds
from ..plan.accel_plan import AccelerationPlan
from ..plan.dm_plan import DMPlan
from ..plan.fft_plan import choose_fft_size
from ..plan.search_plan import SearchPlan, from_arrays
from ..resilience import DegradationLadder, check_revoke, faults, is_resource_exhausted
from ..utils import ProgressBar, trace_count, trace_span
from .accel_search import AccelSearchPeaks, padded_bins, preprocess_block
from .checkpoint import SearchCheckpoint
from .distill import AccelerationDistiller, DMDistiller, HarmonicDistiller
from .folder import MultiFolder
from .score import CandidateScorer

log = get_logger("search")


@dataclass
class SearchConfig:
    """Mirrors CmdLineOptions with the reference's defaults
    (include/utils/cmdline.hpp:69-209), and the JAX package's
    SearchConfig field for field. ``subband_matmul`` runs the subband stages as banded contractions
    (the JAX package has no flag for it either); ``dedisp_block`` sizes
    the segments of trials dedispersed into host RAM. ``max_num_threads``
    caps the cards the DM trials are sharded over and ``shard_devices``
    forces a shard count (:func:`_pick_devices`). ``tune`` resolves the
    dedispersion plan from the tuning cache at ``tuning_cache`` (""
    = perf/tuning.py:default_cache_path). The JAX package's TPU knobs
    (use_pallas, use_pallas_peaks) have no effect here, and accel_bucket
    only pads the deduped results."""

    outdir: str = "."
    killfilename: str = ""
    zapfilename: str = ""
    max_num_threads: int = 14
    limit: int = 1000
    size: int = 0  # fft size; 0 = prev power of two
    dm_start: float = 0.0
    dm_end: float = 100.0
    dm_tol: float = 1.10
    dm_pulse_width: float = 64.0
    acc_start: float = 0.0
    acc_end: float = 0.0
    acc_tol: float = 1.10
    acc_pulse_width: float = 64.0
    boundary_5_freq: float = 0.05
    boundary_25_freq: float = 0.5
    nharmonics: int = 4
    npdmp: int = 0
    min_snr: float = 9.0
    min_freq: float = 0.1
    max_freq: float = 1100.0
    max_harm: int = 16
    freq_tol: float = 1e-4
    verbose: bool = False
    progress_bar: bool = False
    max_peaks: int = 128  # cluster slots per (trial, level); chunks whose
    # cluster count overflows are re-dispatched at the next power of two
    dedisp_block: int = 16
    subbands: int = 0
    subband_smear: float = 1.0
    subband_snr_loss: float = 0.1
    tune: bool = False
    dedisp_engine: str = ""
    subband_matmul: bool = False
    tuning_cache: str = ""
    accel_bucket: int = 16
    dedupe_accel: bool = True  # search one representative of accel
    # trials whose rounded resample-shift maps coincide (bitwise the
    # same output, device work / class size)
    hbm_bytes: int = 0  # device memory budget override; 0 = ask the device
    dm_block: int = 0  # DM trials per preprocessed block; 0 = auto
    checkpoint_file: str = ""
    use_pallas: bool = True
    use_pallas_peaks: bool = True
    shard_devices: int = 0


@dataclass(frozen=True)
class DedispKnobs:
    """The dedispersion and search knobs of a run: the config's, or where
    ``tune`` resolved a plan, the plan's (:meth:`PeasoupSearch.resolve_knobs`)."""

    subbands: int
    subband_smear: float
    subband_matmul: bool
    engine: str  # "" = the dedisperse kernel, "matmul" = the banded matmul
    dedisp_block: int  # DM trials a host-RAM segment of dedisperse_host
    budgets: np.ndarray | None  # DM-scaled per-trial smear budgets, or None
    dm_block: int  # the tuned cap on the automatic DM block; 0 = none
    accel_bucket: int

    @classmethod
    def of(cls, cfg) -> "DedispKnobs":
        return cls(subbands=cfg.subbands, subband_smear=cfg.subband_smear,
                   subband_matmul=cfg.subband_matmul, engine=cfg.dedisp_engine,
                   dedisp_block=cfg.dedisp_block, budgets=None, dm_block=0,
                   accel_bucket=cfg.accel_bucket)


@dataclass
class SearchResult:
    candidates: list
    dm_list: np.ndarray
    acc_list_dm0: np.ndarray
    timers: dict
    nsamps: int
    size: int
    n_accel_trials: int = 0  # DM x accel trials, deduped ones included
    # the run's span table (utils/trace.py:RunTable), None where no
    # profiler recorded
    trace: object = None


@dataclass
class PartialSearchResult:
    """A search stopped after the per-DM distills: what finalize needs."""

    cands: list  # per-DM-trial candidates
    dm_list: np.ndarray
    acc_list_dm0: np.ndarray
    timers: dict
    nsamps: int
    size: int
    n_accel_trials: int
    t_total_start: float
    trials: object = None  # (ndm, out_nsamps) u8 (a tensor, numpy in host
    # RAM or ShardedRows), kept for folding when npdmp > 0
    dm_offset: int = 0  # global dm_idx of trials[0] (a process's DM slice)


def _offset_dm_idx(cands: list, lo: int) -> None:
    """Shift local dm_idx to global, through the assoc trees."""
    seen: set[int] = set()
    stack = list(cands)
    while stack:
        c = stack.pop()
        if id(c) in seen:
            continue
        seen.add(id(c))
        c.dm_idx += lo
        stack.extend(c.assoc)


def _level_windows(
    size: int, nharms: int, min_freq: float, max_freq: float, tsamp: float
) -> np.ndarray:
    """[start_idx, limit) per harmonic level (peakfinder.hpp:78-84)."""
    size_spec = size // 2 + 1
    tobs = np.float32(size) * np.float32(tsamp)
    bin_width = 1.0 / float(tobs)
    nyquist = bin_width * size_spec
    orig_size = 2.0 * (size_spec - 1.0)
    rows = []
    for nh in range(nharms + 1):
        max_bin = int((max_freq / bin_width) * 2.0**nh)
        limit = min(size_spec, max_bin)
        start = int(orig_size * (min_freq / nyquist) * 2.0**nh)
        rows.append((start, limit))
    return np.asarray(rows, dtype=np.int32)


def _densify_ragged(
    vi: np.ndarray, vs: np.ndarray, cc: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand a per-DM ragged peak stream back to dense (nlev, padded,
    mx) slot arrays (cells C-order, slots in order)."""
    flat_cc = cc.reshape(-1).astype(np.int64)
    mx = max(int(flat_cc.max()) if flat_cc.size else 0, 1)
    idxs = np.zeros((flat_cc.size, mx), np.int64)
    snrs = np.zeros((flat_cc.size, mx), np.float64)
    ends = np.cumsum(flat_cc)
    cell = np.repeat(np.arange(flat_cc.size), flat_cc)
    within = np.arange(int(flat_cc.sum()), dtype=np.int64) - np.repeat(
        ends - flat_cc, flat_cc
    )
    idxs[cell, within] = vi
    snrs[cell, within] = vs
    return (
        idxs.reshape(*cc.shape, mx),
        snrs.reshape(*cc.shape, mx),
        cc,
    )


def _accel_pad(n: int, bucket: int) -> int:
    """Padded accel-column count for an accel list of length n: a
    multiple of ``bucket``, or 4 for lists of at most 4 trials (the JAX
    package's tile shapes; here it only sizes the expanded result)."""
    if n <= 4:
        return 4
    return int(math.ceil(n / bucket) * bucket)


def _expand_accel_results(vi, vs, cc, emap, padded_full):
    """Replicate a deduped dispatch's ragged per-(lvl, accel) results
    onto the full accel list (map-equivalent trials share their
    representative's spectrum bitwise). Stream cell order is C-order
    over (nlev, n_dispatch), level-major."""
    nlev, nd = cc.shape
    flat = cc.astype(np.int64).reshape(-1)
    ends = np.cumsum(flat)
    starts = ends - flat
    a_count = len(emap)
    # output cells (lvl-major over the FULL accel list) -> source cells
    src_cells = (
        np.arange(nlev, dtype=np.int64)[:, None] * nd
        + np.asarray(emap, dtype=np.int64)[None, :]
    ).ravel()
    src_counts = flat[src_cells]
    cc_full = np.zeros((nlev, padded_full), dtype=cc.dtype)
    cc_full[:, :a_count] = src_counts.reshape(nlev, a_count)
    n_out = int(src_counts.sum())
    # per output entry: its source index = start of its source cell +
    # offset within the cell
    cell_of = np.repeat(np.arange(src_cells.size), src_counts)
    out_cell_start = np.concatenate([[0], np.cumsum(src_counts)[:-1]])
    within = np.arange(n_out, dtype=np.int64) - out_cell_start[cell_of]
    src = starts[src_cells][cell_of] + within
    return vi[src], vs[src], cc_full


def _distill_per_trial(plan, accel_lists, results, harm_finder, acc_still) -> list:
    """The per-DM distil in Python, the path ``PEASOUP_NO_NATIVE=1``
    selects: one Candidate per cluster, the harmonic distil of each accel
    trial, then the acceleration distil of each DM trial's survivors.
    ``results`` holds each DM trial's (bins, snrs, counts (nlev, A'))
    cluster stream. Returns the survivors, DM ascending."""
    out: list[Candidate] = []
    for dm_idx, (dm, (vi, vs, cc)) in enumerate(zip(plan.dm_list, results)):
        accs = accel_lists[dm_idx]
        idxs, snrs, ccounts = _densify_ragged(vi, vs, cc)
        accel_trial_cands: list[Candidate] = []
        for a_idx in range(len(accs)):
            acc = float(accs[a_idx])
            trial_cands: list[Candidate] = []
            for lvl in range(plan.nharms + 1):
                n_found = int(ccounts[lvl, a_idx])
                trial_cands.extend(
                    Candidate(
                        dm=float(dm), dm_idx=dm_idx, acc=acc, nh=lvl,
                        snr=float(s),
                        freq=float(np.float32(np.float32(b) * plan.factors[lvl])),
                    )
                    for b, s in zip(
                        idxs[lvl, a_idx, :n_found], snrs[lvl, a_idx, :n_found]
                    )
                )
            accel_trial_cands.extend(harm_finder.distill(trial_cands))
        out.extend(acc_still.distill(accel_trial_cands))
    return out


def _distill_segmented(plan, accel_lists, results, harm_finder, acc_still) -> list:
    """The per-DM distil in two native calls, as the JAX package's default
    host path runs it (pipeline/search.py:_distill_trials_segmented there):
    the rows of every cluster of the run are built with numpy, in the order
    (DM asc, accel asc, level asc, stream order) of the per-trial loop,
    every accel trial is sorted (the reference's std::sort) and
    harmonic-distilled in one segmented call, the survivors of each DM
    trial sorted again and acceleration-distilled in a second, and
    Candidate objects are made for those rows only, with the winner ->
    absorbed edges building the assoc trees. Same arguments and result as
    :func:`_distill_per_trial`. With ``PEASOUP_TIE_CAPTURE`` set, the rows
    and segments are first written to that .npz for tools/tie_mc.py. The
    three parts run as the spans ``Distil-Rows``, ``Distil-Native`` and
    ``Distil-Objects`` (utils/trace.py)."""
    with trace_span("Distil-Rows"):
        rows = _distil_rows(plan, accel_lists, results, harm_finder, acc_still)
        trace_count("distil.rows_in", len(rows[1]))
    with trace_span("Distil-Native"):
        picked = _distil_native(*rows, harm_finder, acc_still)
    with trace_span("Distil-Objects"):
        out = _distil_objects(plan, *picked)
        trace_count("distil.candidates_out", len(out))
    return out


def _distil_rows(plan, accel_lists, results, harm_finder, acc_still) -> tuple:
    """The rows of :func:`_distill_segmented`: (freqs, S/N, level, accel
    index and DM index of each row, the accel trials' segment offsets, the
    accel table (DM, accel index) -> m/s^2)."""
    nlev = plan.nharms + 1
    factors = np.asarray(plan.factors, dtype=np.float32)
    ndm = len(results)
    g_freq, g_snr, g_lvl, g_a, g_dm, g_segc = [], [], [], [], [], []
    for dm_idx, (vi, vs, cc) in enumerate(results):
        n_acc = len(accel_lists[dm_idx])
        padded = cc.shape[1]
        flat_cc = cc.reshape(-1).astype(np.int64)
        starts = np.cumsum(flat_cc) - flat_cc
        # the cells (a, lvl), a-major, of the (lvl, a) counts
        a_cell = np.repeat(np.arange(n_acc, dtype=np.int64), nlev)
        lvl_cell = np.tile(np.arange(nlev, dtype=np.int64), n_acc)
        cellidx = lvl_cell * padded + a_cell
        csel = flat_cc[cellidx]
        n = int(csel.sum())
        seg_e = np.cumsum(csel)
        src = np.repeat(starts[cellidx], csel) + (
            np.arange(n, dtype=np.int64) - np.repeat(seg_e - csel, csel)
        )
        lvl_rows = np.repeat(lvl_cell, csel)
        # f32(f32(idx) * f32 factor): the reference's int * float product
        # (peakfinder.hpp:90), widened to f64 after
        g_freq.append(
            (vi[src].astype(np.float32) * factors[lvl_rows]).astype(np.float64)
        )
        g_snr.append(vs[src].astype(np.float64))
        g_lvl.append(lvl_rows.astype(np.int32))
        g_a.append(np.repeat(a_cell, csel))
        g_dm.append(np.full(n, dm_idx, dtype=np.int64))
        g_segc.append(csel.reshape(n_acc, nlev).sum(axis=1))
    freqs_all = np.concatenate(g_freq)
    snr_all = np.concatenate(g_snr)
    lvl_all = np.concatenate(g_lvl)
    a_all = np.concatenate(g_a)
    dm_all = np.concatenate(g_dm)
    seg_counts = np.concatenate(g_segc).astype(np.int64)
    seg_off = np.concatenate([[0], np.cumsum(seg_counts)]).astype(np.int64)
    max_a = max((len(a) for a in accel_lists[:ndm]), default=1)
    acc_tab = np.zeros((ndm, max(max_a, 1)))
    for d, accs in enumerate(accel_lists[:ndm]):
        acc_tab[d, : len(accs)] = accs
    if os.environ.get("PEASOUP_TIE_CAPTURE"):
        # tie-stability capture (tools/tie_mc.py): the raw pre-sort rows
        # and segment structure, everything needed to replay the whole
        # distil chain offline under S/N perturbations, in the JAX
        # package's keys and dtypes
        np.savez(
            os.environ["PEASOUP_TIE_CAPTURE"],
            freqs=freqs_all, snr=snr_all, lvl=lvl_all, a=a_all.astype(np.int32),
            seg_counts=seg_counts,
            dm_of_seg=np.repeat(np.arange(ndm, dtype=np.int64),
                                [len(accel_lists[d]) for d in range(ndm)]),
            acc_tab=acc_tab, dm_list=plan.dm_list,
            harm_tol=harm_finder.tolerance, harm_max=harm_finder.max_harm,
            harm_frac=harm_finder.fractional_harms,
            acc_tobs_over_c=acc_still.tobs_over_c, acc_tol=acc_still.tolerance,
            freq_tol=harm_finder.tolerance, max_harm=harm_finder.max_harm,
        )
    return freqs_all, snr_all, lvl_all, a_all, dm_all, seg_off, acc_tab


def _distil_native(freqs_all, snr_all, lvl_all, a_all, dm_all, seg_off, acc_tab,
                   harm_finder, acc_still) -> tuple:
    """The two segmented native calls of :func:`_distill_segmented`: the
    acceleration-distilled rows (DM index, accel, level, S/N, freq), which
    of them survive, and the winner -> absorbed edges."""
    ndm = acc_tab.shape[0]
    # the harmonic distil of every accel trial (segment), rows S/N-sorted
    # by the reference's std::sort within each
    order = native.snr_sort_perm_seg(snr_all.astype(np.float32), seg_off)
    unique = native.harmonic_distill_seg(
        freqs_all[order], lvl_all[order], seg_off, harm_finder.tolerance,
        harm_finder.max_harm, harm_finder.fractional_harms,
    )
    surv = order[unique]  # row ids, in (segment, S/N desc) order
    trace_count("distil.harmonic_survivors", len(surv))
    s_dm = dm_all[surv]
    s_snr = snr_all[surv]

    # the acceleration distil of every DM trial (segment): its accel
    # trials' survivors in that order, sorted again
    seg_dm = np.searchsorted(s_dm, np.arange(ndm + 1)).astype(np.int64)
    order2 = surv[native.snr_sort_perm_seg(s_snr.astype(np.float32), seg_dm)]
    d_dm, d_freq, d_snr = dm_all[order2], freqs_all[order2], snr_all[order2]
    d_lvl, d_acc = lvl_all[order2], acc_tab[dm_all[order2], a_all[order2]]
    unique2, esrc, edst = native.accel_distill_seg(
        d_freq, d_acc, seg_dm, acc_still.tobs_over_c, acc_still.tolerance
    )
    return d_dm, d_acc, d_lvl, d_snr, d_freq, unique2, esrc, edst


def _distil_objects(plan, d_dm, d_acc, d_lvl, d_snr, d_freq, unique2, esrc, edst) -> list:
    """The Candidate objects of :func:`_distill_segmented`'s rows, the
    absorbed ones appended to their winners, the survivors returned."""
    dm_vals = plan.dm_list
    rows = [
        Candidate(
            dm=float(dm_vals[d_dm[r]]), dm_idx=int(d_dm[r]), acc=float(d_acc[r]),
            nh=int(d_lvl[r]), snr=float(d_snr[r]), freq=float(d_freq[r]),
        )
        for r in range(len(d_dm))
    ]
    for s_, t_ in zip(esrc, edst):
        rows[s_].append(rows[t_])
    return [c for c, u in zip(rows, unique2) if u]


def _freq_factor(size: int, nh: int, tsamp: float) -> np.float32:
    """Bin index -> frequency for level nh, replaying the reference's
    f32 rounding points exactly: ``float tobs = size*get_tsamp()``,
    ``float bin_width = 1.0/tobs`` (pipeline_multi.cu:118-119), then
    PeakFinder's ``float nyquist = bin_width*size`` and ``float factor``
    (peakfinder.hpp:77-89). The candidate's stored f32 freq is
    ``f32(f32(idx) * factor)``."""
    size_spec = size // 2 + 1
    tobs = np.float32(size) * np.float32(tsamp)
    bin_width = np.float32(1.0 / np.float64(tobs))
    nyquist = np.float32(np.float64(bin_width) * np.float64(size_spec))
    return np.float32(
        1.0 / np.float64(size_spec) * np.float64(nyquist) / 2.0**nh
    )


def _dedupe_identity_accels(
    accel_lists, tsamp: float, size: int
) -> tuple[list, list]:
    """Collapse accel trials whose resamples are provably BITWISE
    EQUAL into one representative per equivalence class per DM.

    resample reads src = i + rn(af * quad(i)) with quad and the product
    each rounded once to f32 (ops/resample.py). Two trials whose entire
    rounded SHIFT MAPS i -> rn(f32(af)*quad[i]) coincide read identical
    sources, so their spectra, peaks, and candidates are bitwise
    identical; searching one representative and replicating its results
    on the host is output-identical to brute force. The IDENTITY class
    (map == 0 everywhere, exactly when |f32(af * max|quad|)| <= 0.5 by
    rn's monotonicity — rn(0.5) = 0 under round-half-even) is the
    common case (a +-5 m/s^2 grid at 2^17 samples), handled without
    building maps.

    Class detection: quad <= 0 everywhere, so
    maps are pointwise monotone in af and classes are CONTIGUOUS in
    af-sorted order — adjacent-pair comparison finds them all. Exact
    screens keep it cheap: equal f32 afs share a map trivially;
    differing rints at the max-|quad| bin mean the maps differ there
    (rint is odd, so rint(af*max|quad|) determines that bin's value);
    and a 64-point strided probe of the maps rejects most remaining
    unequal pairs before the full O(size) compare.

    Returns (dispatch_lists, expand_maps): expand_maps[dm] is None when
    nothing deduped, else an int array mapping each FULL accel index to
    its dispatch-list index.
    """
    max_abs_quad = _max_abs_quad_f32(size)
    dispatch_lists: list = []
    expand_maps: list = []
    max_ident_af = np.float32(0.0)
    for accs in accel_lists:
        n = len(accs)
        afs32 = accel_factor(np.asarray(accs), tsamp).astype(np.float32)
        if n <= 1:
            dispatch_lists.append(accs)
            expand_maps.append(None)
            continue
        prods = afs32 * max_abs_quad  # one f32 rounding each
        if (np.abs(prods) <= np.float32(0.5)).all():
            # whole list is the identity class: no maps needed
            class_of = np.zeros(n, dtype=np.int64)
            max_ident_af = max(max_ident_af, np.abs(afs32).max())
        else:
            quad = _quad_f32(size)
            probe = quad[:: max(1, size // 64)]
            rmax = np.rint(prods)  # the (negated) map value at max|quad|
            order = np.argsort(afs32, kind="stable")
            class_of = np.empty(n, dtype=np.int64)
            cid = -1
            prev_j = -1
            prev_map = None
            for j in order:
                if prev_j < 0:
                    new = True
                elif afs32[j] == afs32[prev_j]:
                    new = False
                elif rmax[j] != rmax[prev_j] or not np.array_equal(
                    np.rint(afs32[j] * probe), np.rint(afs32[prev_j] * probe)
                ):
                    new = True
                    prev_map = None
                else:
                    if prev_map is None:
                        prev_map = np.rint(afs32[prev_j] * quad)
                    cur = np.rint(afs32[j] * quad)
                    new = not np.array_equal(cur, prev_map)
                    prev_map = cur
                if new:
                    cid += 1
                class_of[j] = cid
                prev_j = j
        # representative = FIRST member (original order) of each class
        first_of: dict[int, int] = {}
        for i in range(n):
            first_of.setdefault(int(class_of[i]), i)
        if len(first_of) == n:
            dispatch_lists.append(accs)
            expand_maps.append(None)
            continue
        keep = sorted(first_of.values())
        pos = {full_i: j for j, full_i in enumerate(keep)}
        expand_maps.append(
            np.asarray(
                [pos[first_of[int(class_of[i])]] for i in range(n)],
                dtype=np.int64,
            )
        )
        dispatch_lists.append(np.asarray([accs[i] for i in keep]))
    if max_ident_af > 0:
        # belt-and-braces for the map-free identity fast path: replay
        # the device's exact shift chain for the LARGEST deduped |af|
        # (monotonicity covers the rest) and verify every shift is zero
        shifts = np.rint(max_ident_af * _quad_f32(size))
        if shifts.any():
            raise RuntimeError(
                f"identity-dedupe invariant violated: af={max_ident_af!r} "
                f"has a nonzero resample shift (max |shift| = "
                f"{np.abs(shifts).max()})"
            )
    return dispatch_lists, expand_maps


@lru_cache(maxsize=8)
def _quad_f32(size: int) -> np.ndarray:
    """resample's f32-rounded quadratic index map: f32(i)*(f32(i)-f32(size))
    for all i (exactly the device computation, ops/resample.py)."""
    idx = np.arange(size, dtype=np.float32)
    quad = idx * (idx - np.float32(size))
    quad.setflags(write=False)  # cached: protect from caller mutation
    return quad


@lru_cache(maxsize=8)
def _max_abs_quad_f32(size: int) -> np.float32:
    return np.float32(np.abs(_quad_f32(size)).max())


def choose_routes(size: int, af_max: float) -> dict[str, bool]:
    """The acceleration chain's routes for FFT size ``size`` and largest
    |acceleration factor| ``af_max``, as the JAX package picks them
    (its pipeline/search.py:850-945, every probe passing):

    - ``fused_dft``, the dftspec kernel for the spectrum, where its
      geometry gate holds and the JAX package resamples by its packed
      select (a span of at most 64 samples that is at most 8 or has no
      Pallas resample block), unless ``PEASOUP_FUSED_DFT=0`` or
      ``PEASOUP_FUSED_FFT=0`` (which in the JAX package turns off the
      fused interbin step that the fused DFT builds on); otherwise cuFFT
      + the interbin kernel;
    - ``mega_harm``, the harmpeaks kernel for harmonic sums and peaks,
      unless ``PEASOUP_MEGA_HARM=0``; otherwise torch sums + the peaks
      kernel.
    """
    smax = select_span(af_max, size)
    fused_dft = (
        dftspec_supported(size, padded_bins(size))
        and smax > 0
        and (smax <= 8 or choose_block(af_max, size) == 0)
        and os.environ.get("PEASOUP_FUSED_DFT", "1") != "0"
        and os.environ.get("PEASOUP_FUSED_FFT", "1") != "0"
    )
    mega_harm = os.environ.get("PEASOUP_MEGA_HARM", "1") != "0"
    return dict(fused_dft=fused_dft, mega_harm=mega_harm)


# the card ran out of memory: the resilience taxonomy's one definition
# (torch.OutOfMemoryError, cuFFT's CUFFT_ALLOC_FAILED)
_is_oom = is_resource_exhausted


def _release(*devices: torch.device) -> None:
    """Return the allocator's cached blocks and cuFFT's plans to the cards
    before a retry of the memory ladder."""
    for device in set(devices):
        if device.type == "cuda":
            torch.backends.cuda.cufft_plan_cache[device.index or 0].clear()
            with device_context(device):
                torch.cuda.empty_cache()


def _pick_devices(device, cfg, devices=None) -> list[torch.device]:
    """The devices to shard the DM trials over (the JAX package's
    _pick_devices): an explicit ``devices`` list as given (it may repeat a
    device); ``cfg.shard_devices`` > 0 forces that many shards, local cards
    (capped at their count) from the first or, for an indexed card such as
    a process's ``cuda:LOCAL_RANK``, from that card on, wrapping round; on
    the CPU, shards of the one CPU device; otherwise an unindexed CUDA
    device means every local card up to ``cfg.max_num_threads`` (the
    reference's one worker per GPU up to -t, pipeline_multi.cu:276-277),
    and any other device itself."""
    if devices:
        return [resolve_device(d) for d in devices]
    device = resolve_device(device)
    if device.type == "cpu":
        return [device] * max(1, cfg.shard_devices)
    cards = local_devices("cuda")
    if cfg.shard_devices > 0:
        first = (device.index or 0) % len(cards)
        return (cards[first:] + cards[:first])[: min(cfg.shard_devices, len(cards))]
    if device.index is None:
        return cards[: max(1, min(len(cards), cfg.max_num_threads))]
    return [device]


def _trial_rows(trials, lo: int, hi: int, size: int, device: torch.device):
    """Rows [lo, hi) of the trials, their first ``size`` samples, on
    ``device``: from a tensor, host RAM or the shards that hold them."""
    if isinstance(trials, ShardedRows):
        return trials.rows(lo, hi, device)[:, :size]
    if isinstance(trials, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(trials[lo:hi, :size])).to(device)
    return trials[lo:hi, :size].to(device)


# the speculative size of a fetched stream: where a round starts, and the
# cap on what it learns (the JAX package's pipeline/search.py:432, :1983)
TOTAL_PAD_START = 4096
TOTAL_PAD_CAP = 1 << 16


def _pow2(n: int) -> int:
    """The power of two at or above ``n``, at least 64 (a stream's size)."""
    return 1 << max(6, int(np.ceil(np.log2(max(1, n)))))


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host table on ``dev`` with no wait for the host: on a card through
    pinned memory, non-blocking (the allocator keeps the pinned block until
    the copy has run)."""
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _fetch(packed: torch.Tensor) -> np.ndarray:
    """One device-to-host transfer of a packed result: the search's only
    read of its peaks (its callers open the span ``Fetch`` round it: the
    host blocked on the card, then the copy)."""
    trace_count("wave.fetches")
    trace_count("wave.fetch_bytes", packed.numel() * packed.element_size())
    return packed.cpu().numpy()


def _level_major(vi: np.ndarray, vs: np.ndarray, cc: np.ndarray):
    """A ragged stream of (row, level) cells in C order, ``cc`` (rows, nlev)
    their entry counts, put in (level, row) C order."""
    flat = cc.reshape(-1).astype(np.int64)
    starts = np.cumsum(flat) - flat
    order = np.arange(flat.size).reshape(cc.shape).T.reshape(-1)
    n = flat[order]
    src = np.repeat(starts[order] - (np.cumsum(n) - n), n) + np.arange(int(n.sum()))
    return vi[src], vs[src]


class PeasoupSearch:
    # bytes of device memory one (DM, accel) row of the acceleration
    # chain holds at its peak, and one DM trial of the preprocessing
    # block, per time sample of the FFT length (resample indices, the
    # series, its DFT, the spectrum, and their temporaries)
    ROW_BYTES_PER_SAMPLE = 64
    DM_BYTES_PER_SAMPLE = 64
    # trial blocks larger than this stay in host RAM (the JAX package's
    # limit: a third of the device memory, 4 GB where none is known)
    TRIALS_DEVICE_LIMIT = 4_000_000_000
    # the cluster slots a round's row batches may hold on the card before
    # they are fetched (the JAX package's WAVE_BUDGET: a twelfth of the
    # device memory, at least 250 MB; 1 GB where none is known)
    WAVE_BUDGET = 1_000_000_000

    def __init__(self, config: SearchConfig, device: str | torch.device = "cuda",
                 devices=None):
        self.config = config
        self.devices = _pick_devices(device, config, devices)
        self.device = self.devices[0]  # where the fold and the host copies go
        self.mesh = make_mesh({"dm": len(self.devices)}, devices=self.devices)
        # shards that share the busiest device share its memory budget
        self._share = max(self.devices.count(d) for d in self.devices)
        if native.enabled():
            native.load()  # the distil library builds here or the search raises
        # cluster slots learned from overflowing batches, so later rounds
        # dispatch once, and the size of the stream each fetch speculates
        # on, learned from the totals fetched (both carry over to later runs)
        self._learned_max_peaks = 0
        self._learned_total_pad = TOTAL_PAD_START
        limit = config.hbm_bytes
        if not limit and self.device.type == "cuda":
            limit = torch.cuda.mem_get_info(self.device)[1]
        if limit:
            self.TRIALS_DEVICE_LIMIT = int(limit) // 3
            self.WAVE_BUDGET = max(int(limit) // 12, 250_000_000)
        # DM trials the last run searched (the rest were restored)
        self.n_searched = 0
        # the tuned dedispersion plan of the last run (None without tune)
        # and the knobs the run took
        self.dedisp_plan = None
        self.knobs = DedispKnobs.of(config)

    def build_dm_plan(self, fil: Filterbank) -> DMPlan:
        cfg = self.config
        killmask = None
        if cfg.killfilename:
            killmask = read_killfile(cfg.killfilename, fil.nchans)
        return DMPlan.create(
            nsamps=fil.nsamps, nchans=fil.nchans, tsamp=fil.tsamp,
            fch1=fil.fch1, foff=fil.foff, dm_start=cfg.dm_start,
            dm_end=cfg.dm_end, pulse_width=cfg.dm_pulse_width,
            tol=cfg.dm_tol, killmask=killmask,
        )

    def _accel_plan(self, fil: Filterbank, size: int) -> AccelerationPlan:
        cfg = self.config
        # the reference passes foff as the accel plan's "bw": the width
        # term uses the CHANNEL width (pipeline_multi.cu:335-337)
        return AccelerationPlan(
            acc_lo=cfg.acc_start, acc_hi=cfg.acc_end, tol=cfg.acc_tol,
            pulse_width=cfg.acc_pulse_width, nsamps=size, tsamp=fil.tsamp,
            cfreq=fil.cfreq, bw=fil.foff,
        )

    def build_plan(self, fil: Filterbank) -> SearchPlan:
        """The search plan for this configuration and filterbank."""
        cfg = self.config
        dm_plan = self.build_dm_plan(fil)
        size = choose_fft_size(fil.nsamps, cfg.size)
        size_spec = size // 2 + 1
        tobs = float(np.float32(size) * np.float32(fil.tsamp))
        bin_width = float(np.float32(1.0 / tobs))
        if cfg.zapfilename:
            zapmask = birdie_mask(*read_zapfile(cfg.zapfilename), bin_width, size_spec)
        else:
            zapmask = np.zeros(size_spec, dtype=bool)
        acc_plan = self._accel_plan(fil, size)
        return from_arrays(
            dm_list=dm_plan.dm_list,
            delays=dm_plan.delay_samples(),
            killmask=dm_plan.killmask,
            out_nsamps=dm_plan.out_nsamps,
            size=size,
            accel_lists=[
                acc_plan.generate_accel_list(float(dm)) for dm in dm_plan.dm_list
            ],
            zapmask=zapmask,
            windows=_level_windows(
                size, cfg.nharmonics, cfg.min_freq, cfg.max_freq, fil.tsamp
            ),
            factors=[
                _freq_factor(size, nh, fil.tsamp)
                for nh in range(cfg.nharmonics + 1)
            ],
        )

    def _sync(self) -> None:
        for dev in set(self.devices):
            if dev.type == "cuda":
                # audit: ignore[PSA001] -- one sync a device at a stage's end, for the stage timers
                torch.cuda.synchronize(dev)

    def resolve_knobs(self, fil: Filterbank, plan: SearchPlan) -> DedispKnobs:
        """The run's knobs (the JAX package's pipeline/search.py:540-599):
        the config's; or with ``tune``, no ``subbands`` and no
        ``dedisp_engine``, those of the plan the tuning cache holds for the
        observation's bucket on this card, tuned there on a cold bucket
        (perf/tuning.py). Sets :attr:`dedisp_plan`."""
        cfg = self.config
        knobs = DedispKnobs.of(cfg)
        self.dedisp_plan = None
        if not cfg.tune or cfg.subbands != 0 or cfg.dedisp_engine:
            return knobs
        from ..perf.tuning import resolve_plan_for_filterbank

        dplan = resolve_plan_for_filterbank(
            fil, "search", cfg, cfg.tuning_cache or None, device=self.device
        )
        self.dedisp_plan = dplan
        changes = dict(dedisp_block=dplan.dedisp_block or cfg.dedisp_block)
        if dplan.engine == "subband":
            changes.update(subbands=dplan.subbands, subband_smear=dplan.subband_smear,
                           subband_matmul=cfg.subband_matmul or dplan.subband_matmul)
            if dplan.smear_dm_scaled and dplan.smear_loss_budget:
                # the per-trial budgets the planner grouped under, rebuilt
                # on this observation's own DM list (deterministic in the
                # geometry, so the cache holds only the loss fraction)
                from ..plan.dedisp_plan import dm_smear_budgets

                changes["budgets"] = dm_smear_budgets(
                    plan.dm_list, tsamp=fil.tsamp, fch1=fil.fch1, foff=fil.foff,
                    nchans=fil.nchans, pulse_width_us=cfg.dm_pulse_width,
                    max_snr_loss=dplan.smear_loss_budget, floor=dplan.subband_smear,
                )
        elif dplan.engine == "matmul":
            changes["engine"] = "matmul"
        # an explicit config value wins; the defaults take the card's winner
        if cfg.dm_block == 0 and dplan.dm_block:
            changes["dm_block"] = int(dplan.dm_block)
        if (cfg.accel_bucket == SearchConfig.__dataclass_fields__["accel_bucket"].default
                and dplan.accel_bucket):
            changes["accel_bucket"] = int(dplan.accel_bucket)
        tel = current_telemetry()
        tel.event("dedisp_plan", **dplan.summary())
        tel.set_context(dedisp_plan=dplan.summary())
        log.info("dedispersion plan: %s (subbands=%d, dedisp_block=%d, gain %.2fx, "
                 "predicted S/N loss %.3f, %s): %s", dplan.engine, dplan.subbands,
                 dplan.dedisp_block, dplan.gain, dplan.predicted_loss, dplan.source,
                 dplan.summary())
        return dataclasses.replace(knobs, **changes)

    def _memory_budget(self) -> int:
        """Bytes one shard's blocks may take on its device."""
        if self.config.hbm_bytes:
            return self.config.hbm_bytes // 2 // self._share
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            return int(free * 0.6) // self._share
        return 2_000_000_000 // self._share

    def run(
        self,
        fil: Filterbank,
        plan: SearchPlan | None = None,
        dm_slice: tuple[int, int] | None = None,
        finalize: bool = True,
    ) -> SearchResult | PartialSearchResult:
        """Full search of ``fil``; ``plan`` defaults to :meth:`build_plan`.
        With ``dm_slice=(lo, hi)`` only that contiguous block of the global
        DM-trial list is dedispersed and searched (candidates carry global
        dm_idx); with ``finalize=False`` the run stops after the per-DM
        distils and returns the PartialSearchResult a multi-process merge
        takes (parallel/multihost.py:run_search). The run is the root span
        ``Search`` (utils/trace.py): where a profiler records, the result
        carries the run's span table as ``trace``."""
        with trace_span("Search", root=True) as table:
            res = self._run(fil, plan, dm_slice, finalize)
        if table is not None and isinstance(res, SearchResult):
            res.trace = table
        return res

    def _run(self, fil, plan, dm_slice, finalize):
        cfg = self.config
        tel = current_telemetry()
        timers: dict[str, float] = {}
        t_total = time.perf_counter()

        t0 = time.perf_counter()
        tel.set_stage("plan")
        if plan is None:
            plan = self.build_plan(fil)
        if plan.nharms != cfg.nharmonics:
            raise ValueError("plan windows do not match config.nharmonics")
        global_ndm, dm_lo = plan.ndm, 0
        if dm_slice is not None:
            dm_lo = dm_slice[0]
            plan = plan.subset(*dm_slice)
        timers["plan"] = time.perf_counter() - t0
        size = plan.size
        acc_list_dm0 = self._accel_plan(fil, size).generate_accel_list(0.0)
        if plan.ndm == 0:
            # an empty slice (more processes than DM trials) contributes no
            # candidates and never touches the device
            part = PartialSearchResult(
                cands=[], dm_list=plan.dm_list, acc_list_dm0=acc_list_dm0,
                timers={**timers, **dict.fromkeys(
                    ("dedispersion", "search_device", "search_host", "searching"),
                    0.0)},
                nsamps=fil.nsamps, size=size, n_accel_trials=0,
                t_total_start=t_total,
                trials=np.zeros((0, plan.out_nsamps), dtype=np.uint8),
                dm_offset=dm_lo,
            )
            return self.finalize(fil, part) if finalize else part
        self.knobs = knobs = self.resolve_knobs(fil, plan)

        # the checkpoint store, loaded once before dedispersion: when every
        # trial is restored and nothing is folded, the trials are never read.
        # A slice's store is its own sibling file, local keys (checkpoint.py)
        ckpt = None
        per_dm: dict[int, tuple] = {}
        if cfg.checkpoint_file:
            ckpt = SearchCheckpoint(
                cfg.checkpoint_file,
                SearchCheckpoint.make_key(cfg, fil, size, global_ndm),
                slice_bounds=dm_slice,
            )
            per_dm = ckpt.load()
            if per_dm:
                log.info("resuming: %d/%d DM trials restored from %s",
                         len(per_dm), plan.ndm, cfg.checkpoint_file)
        skip_dedisp = (
            ckpt is not None and cfg.npdmp == 0 and plan.ndm > 0
            and all(d in per_dm for d in range(plan.ndm))
        )

        t0 = time.perf_counter()
        tel.set_stage("dedispersion")
        scale = output_scale(fil.nbits, int(plan.killmask.sum()))
        # sharded trials spread over the shards' devices
        n_cards = len(set(self.devices)) if knobs.subbands == 0 else 1
        trials_bytes = plan.ndm * plan.out_nsamps
        spill = trials_bytes > self.TRIALS_DEVICE_LIMIT * n_cards
        tel.event("device_plan", n_devices=len(self.devices),
                  sharded=len(self.devices) > 1, trials_spill=bool(spill),
                  trials_bytes=int(trials_bytes), ndm=int(plan.ndm))
        if skip_dedisp:
            log.info("resume fast path: every DM trial restored and npdmp=0; "
                     "dedispersion skipped")
            tel.event("resume_fast_path", ndm=int(plan.ndm))
            trials = np.zeros((0, plan.out_nsamps), dtype=np.uint8)
        else:
            with trace_span("Dedisperse"):
                trials = self._dedisperse(fil, plan, scale, spill)
        self._sync()
        timers["dedispersion"] = time.perf_counter() - t0
        tel.capture_device_memory("dedispersion")

        tobs = float(np.float32(size) * np.float32(fil.tsamp))
        # float bin_width = 1.0/tobs (pipeline_multi.cu:119)
        bin_width = float(np.float32(1.0 / tobs))
        geometry = dict(
            size=size,
            nsamps_valid=min(plan.out_nsamps, size),
            pos5=int(cfg.boundary_5_freq / bin_width),
            pos25=int(cfg.boundary_25_freq / bin_width),
        )
        tel.set_stage("searching")
        accel_lists = plan.accel_lists
        # trial totals published before the search, so the live heartbeat
        # can report progress against them
        tel.gauge("search.n_dm_trials", int(plan.ndm))
        tel.gauge("search.n_accel_trials", sum(len(a) for a in accel_lists))
        tel.gauge("search.fft_size", int(size))
        if cfg.dedupe_accel:
            dispatch_lists, expand = _dedupe_identity_accels(
                accel_lists, fil.tsamp, size
            )
        else:
            dispatch_lists, expand = list(accel_lists), [None] * plan.ndm
        if any(m is not None for m in expand):
            tel.event("accel_dedupe", dispatched=sum(len(a) for a in dispatch_lists),
                      full=sum(len(a) for a in accel_lists))
        if per_dm:
            tel.event("checkpoint_resume", restored=len(per_dm), ndm=int(plan.ndm))
        af_max = max(
            (float(np.abs(accel_factor(a, fil.tsamp)).max())
             for a in dispatch_lists if len(a)),
            default=0.0,
        )
        routes = choose_routes(size, af_max)
        log.info(
            "spectrum: %s; peaks: %s",
            "dftspec kernel" if routes["fused_dft"] else "cuFFT + interbin kernel",
            "harmpeaks kernel" if routes["mega_harm"]
            else "harmonic sums + peaks kernel",
        )

        t0 = time.perf_counter()
        trials = self._search_with_ladder(
            fil, plan, trials, scale, skip_dedisp, per_dm, ckpt,
            dispatch_lists, expand, geometry, routes,
        )
        if cfg.npdmp <= 0:
            trials = None  # only the folder reads the trials again
        self._sync()
        timers["search_device"] = time.perf_counter() - t0
        tel.capture_device_memory("search")

        t_host = time.perf_counter()
        tel.set_stage("search_host")
        with trace_span("Search-Host"):
            harm_finder = HarmonicDistiller(cfg.freq_tol, cfg.max_harm, keep_related=False)
            acc_still = AccelerationDistiller(tobs, cfg.freq_tol, keep_related=True)
            results = [per_dm.pop(dm_idx) for dm_idx in range(plan.ndm)]
            distil = _distill_segmented if native.enabled() else _distill_per_trial
            log.info("distil: %s", distil.__name__.lstrip("_"))
            cands = distil(plan, accel_lists, results, harm_finder, acc_still)
            if dm_lo:
                _offset_dm_idx(cands, dm_lo)
        timers["search_host"] = time.perf_counter() - t_host
        timers["searching"] = time.perf_counter() - t0
        tel.gauge("candidates.per_dm_distill", len(cands))

        part = PartialSearchResult(
            cands=cands,
            dm_list=plan.dm_list,
            acc_list_dm0=acc_list_dm0,
            timers=timers,
            nsamps=fil.nsamps,
            size=size,
            n_accel_trials=sum(len(a) for a in accel_lists),
            t_total_start=t_total,
            trials=trials,
            dm_offset=dm_lo,
        )
        return self.finalize(fil, part) if finalize else part

    def _dedisperse(self, fil: Filterbank, plan: SearchPlan, scale: float, spill: bool):
        """All DM trials, by the engine the run's knobs name (the JAX
        package's dispatch, its pipeline/search.py:689-736): sharded over
        the devices where there are several (the direct sum only), on the
        device, or in host RAM (numpy) where ``spill``."""
        knobs = self.knobs
        with trace_span("Upload", device=self.device):
            x = fil_to_device(fil, self.device)
        args = (x, plan.delays, plan.killmask, plan.out_nsamps)
        if len(self.devices) > 1 and knobs.subbands == 0 and not spill:
            log.info("dedispersion: dedisperse kernel on %d shards", len(self.devices))
            return dedisperse_sharded(*args, self.mesh, scale=scale)
        if knobs.subbands > 0:
            log.info("dedispersion: subband (nsub %d, max_smear %s%s, %s stages)%s",
                     knobs.subbands, knobs.subband_smear,
                     "" if knobs.budgets is None else ", DM-scaled budgets",
                     "matmul" if knobs.subband_matmul else "scan",
                     ", trials in host RAM" if spill else "")
            return dedisperse_subband(
                *args, nsub=knobs.subbands, max_smear=knobs.subband_smear,
                scale=scale, to_host=spill, use_matmul=knobs.subband_matmul,
                budgets=knobs.budgets,
            )
        if knobs.engine == "matmul" and not spill:
            log.info("dedispersion: banded matmul")
            return dedisperse_matmul(*args, scale=scale)
        if spill:
            log.info("dedispersion: dedisperse kernel, trials in host RAM")
            return dedisperse_host(*args, scale=scale, block=knobs.dedisp_block)
        log.info("dedispersion: dedisperse kernel")
        return dedisperse(*args, scale=scale)

    def _search_with_ladder(self, fil, plan, trials, scale, skip_dedisp, per_dm, ckpt,
                            dispatch_lists, expand, geometry, routes):
        """:meth:`_search_trials` under the JAX package's memory ladder
        (its pipeline/search.py:1117-1285, the ``search.memory``
        DegradationLadder), the rungs a card has: on an out-of-memory error,
        halve the DM block and its row batches and retry (the trials
        already searched are kept; rung ``dm_block_shrink``); at one trial
        and one row, free the device-resident trials, dedisperse again into
        host RAM (the dedisperse kernel segment by segment, the same bits)
        and size the blocks afresh (rung ``subband``: the JAX package's
        exact subbands serve only to put the trials in host RAM). Past that
        the ladder is exhausted and the error raised: the port has no
        ``cpu_backend`` rung, since on the card a search runs or raises.
        The ``device.oom`` fault seam fires at each attempt. Returns the
        trials the search ended with."""
        tel = current_telemetry()
        ladder = DegradationLadder(
            "search.memory", ("dm_block_shrink", "subband", "cpu_backend")
        )
        shrink, fell_host, retry = 1, False, False
        while True:
            if retry:
                _release(*self.devices)
            d_blk, row_blk = self._blocks(plan, geometry["size"], shrink)
            bounds = shard_bounds(plan.ndm, len(self.devices))
            tel.event(
                "wave_plan", n_waves=-(-max(hi - lo for lo, hi in bounds) // d_blk),
                n_chunks=sum(-(-(hi - lo) // d_blk) for lo, hi in bounds),
                shrink=shrink, max_dm_block=d_blk, backend="default",
            )
            try:
                faults.fire("device.oom", context=f"search:shrink{shrink}")
                self._search_trials(trials, plan, dispatch_lists, expand, fil.tsamp,
                                    geometry, routes, per_dm, ckpt, shrink)
                return trials
            except Exception as exc:
                if not _is_oom(exc):
                    raise
                retry = True
                if d_blk > 1 or row_blk > 1:
                    shrink *= 2
                    new_blk, new_row = self._blocks(plan, geometry["size"], shrink)
                    log.warning(
                        "device OOM at dm_block=%d (row batch %d); retrying with "
                        "half-size blocks (dm_block=%d, row batch %d): %.200s",
                        d_blk, row_blk, new_blk, new_row, exc,
                    )
                    tel.event("oom_shrink_retry", dm_block_old=d_blk,
                              dm_block_new=new_blk, shrink=shrink, error=f"{exc!s:.200}")
                    # shrinks after the host rung keep the event trail but
                    # not a ladder step (a ladder never climbs back up)
                    if ladder.current_rung in (None, "dm_block_shrink"):
                        ladder.step("dm_block_shrink", dm_block_old=d_blk,
                                    dm_block_new=new_blk, error=f"{exc!s:.200}")
                    continue
                if (fell_host or self.knobs.subbands > 0 or skip_dedisp
                        or isinstance(trials, np.ndarray)):
                    ladder.exhausted(dm_block=d_blk, error=f"{exc!s:.200}")
                    raise
                fell_host, shrink = True, 1
                log.warning(
                    "device OOM with dm_block at the floor; dedispersing again "
                    "into host RAM (dedisperse kernel, segment by segment): %.200s",
                    exc,
                )
                tel.event("oom_subband_fallback", nsub=0, engine="dedisperse_host",
                          dm_block=d_blk, error=f"{exc!s:.200}")
                ladder.step("subband", nsub=0, engine="dedisperse_host",
                            error=f"{exc!s:.200}")
            trials = None
            _release(*self.devices)
            with trace_span("Dedisperse"):
                with trace_span("Upload", device=self.device):
                    x = fil_to_device(fil, self.device)
                trials = dedisperse_host(
                    x, plan.delays, plan.killmask,
                    plan.out_nsamps, scale=scale, block=self.knobs.dedisp_block,
                )

    def _blocks(self, plan, size: int, shrink: int = 1) -> tuple[int, int]:
        """(DM trials a preprocessed block, rows a batch) of one shard, each
        divided by ``shrink`` (at least 1). The automatic DM block is capped
        by the tuned one (:attr:`knobs`)."""
        budget = self._memory_budget()
        auto = max(1, min(plan.ndm, budget // 2 // (self.DM_BYTES_PER_SAMPLE * size)))
        if self.knobs.dm_block:
            auto = min(auto, self.knobs.dm_block)
        d_blk = self.config.dm_block or auto
        row_blk = max(1, budget // 2 // (self.ROW_BYTES_PER_SAMPLE * size))
        return max(1, d_blk // shrink), max(1, row_blk // shrink)

    def _search_trials(self, trials, plan, dispatch_lists, expand, tsamp, geometry,
                       routes, per_dm, ckpt, shrink=1):
        """Search every dispatched (DM, accel) trial of the DM trials missing
        from ``per_dm`` on the acceleration chain's ``routes``
        (:func:`choose_routes`), and put each DM trial's ragged cluster
        stream there, (bins, snrs, counts (nlev, A)) over its full accel
        list (a deduped dispatch's results replicated onto its class): the
        valid cluster slots of every (level, accel) cell in C order, as the
        JAX package packs and checkpoints them. Each shard owns a
        contiguous 1/n of the DM trials (:func:`shard_bounds`, the sharded
        dedispersion's split) and searches them in blocks on its own
        device; the shards' k-th blocks run together as one wave
        (:meth:`_search_round`, parallel/sharded_search.py). DM blocks keep
        their places whatever was restored; a block with restored trials is preprocessed
        whole and only its missing trials' rows are searched. ``trials``
        elsewhere than a block's device (host RAM, another shard) move
        there a block at a time. ``ckpt`` saves after each round of
        blocks."""
        # parallel/sharded_search imports this package's chain
        from ..parallel.sharded_search import make_sharded_search_fn

        size = geometry["size"]
        d_blk, row_blk = self._blocks(plan, size, shrink)
        zaps = {d: torch.from_numpy(plan.zapmask).to(d) for d in set(self.devices)}
        search = make_sharded_search_fn(
            self.mesh, float(np.float32(self.config.min_snr)), **routes
        )
        bounds = shard_bounds(plan.ndm, len(self.devices))
        self.n_searched = 0
        tel = current_telemetry()
        rounds = range(0, max(hi - lo for lo, hi in bounds), d_blk)
        tel.set_progress(0, len(rounds), unit="chunks")
        progress = ProgressBar() if self.config.progress_bar else None
        if progress:
            progress.start()
        for wi, k in enumerate(rounds):
            with job_span("wave", wave=wi), trace_span("DM-Loop"):
                searched = self._search_round(trials, plan, dispatch_lists, expand,
                                              tsamp, geometry, per_dm, bounds, k, d_blk,
                                              row_blk, zaps, search)
            if searched:
                if ckpt is not None:
                    with job_span("checkpoint", wave=wi):
                        ckpt.save(per_dm)
                # the revoke seam: a preempt stops here, right after the
                # checkpoint save, so a resumed run restores exactly this state
                check_revoke("search.wave")
            tel.set_progress(wi + 1, len(rounds), unit="chunks")
            tel.incr("search.dm_trials_done",
                     sum(max(0, min(lo + k + d_blk, hi) - (lo + k)) for lo, hi in bounds))
            if progress:
                progress.update((wi + 1) / len(rounds))
        if progress:
            progress.stop()
        log.info("searched %d of %d DM trials (%d restored)", self.n_searched,
                 plan.ndm, plan.ndm - self.n_searched)

    def _search_round(self, trials, plan, dispatch_lists, expand, tsamp, geometry,
                      per_dm, bounds, k, d_blk, row_blk, zaps, search) -> bool:
        """The k-th DM block of every shard, searched as one wave (the JAX
        package's pipeline/search.py:_search_wave): every row batch of every
        shard's block is dispatched with nothing read back, its cluster
        slots kept on its device, and at the round's end each shard's
        batches are packed and fetched in one transfer (:meth:`_fetch_wave`),
        or earlier where the pending batches' slots would pass
        ``WAVE_BUDGET`` bytes. Each searched DM trial's results go into
        ``per_dm``. False where every trial of the round was restored."""
        cfg = self.config
        size = geometry["size"]
        blocks = []
        for (lo, hi), dev in zip(bounds, self.devices):
            lo, hi = lo + k, min(lo + k + d_blk, hi)
            todo = [d for d in range(lo, hi) if d not in per_dm]
            if not todo:
                blocks.append(None)
                continue
            with device_context(dev):
                tims = _trial_rows(trials, lo, hi, size, dev)
                with trace_span("Whitening", device=dev):
                    trace_count("whitening.trials", hi - lo)
                    xd, mean, std = preprocess_block(tims, zaps[dev], **geometry)
                del tims
            # the round's row tables, uploaded once and sliced per batch
            row_dm = np.concatenate(
                [np.full(len(dispatch_lists[d]), d - lo, np.int32) for d in todo])
            afs = np.concatenate(
                [accel_factor(dispatch_lists[d], tsamp).astype(np.float32) for d in todo])
            blocks.append(dict(
                todo=todo, dev=dev, xd=xd, mean=mean, std=std, row_dm=row_dm,
                row_dm_dev=_upload(row_dm, dev), afs=_upload(afs, dev), results=[],
            ))
        if not any(blocks):
            return False
        nlev = cfg.nharmonics + 1
        wave, wave_bytes = [], 0
        for r0 in range(0, max(len(b["row_dm"]) for b in blocks if b), row_blk):
            max_peaks = max(cfg.max_peaks, self._learned_max_peaks)
            jobs = [self._job(b, r0, row_blk) if b else None for b in blocks]
            # the batch's slots (idxs and snrs) while they wait on the card
            nbytes = sum(len(j[1]) for j in jobs if j) * nlev * max_peaks * 8
            if wave and wave_bytes + nbytes > self.WAVE_BUDGET:
                self._fetch_wave(blocks, wave, search, plan.windows)
                wave, wave_bytes = [], 0
            trace_count("rows.dispatched", sum(len(j[1]) for j in jobs if j))
            peaks = search(jobs, plan.windows, nharms=cfg.nharmonics, max_peaks=max_peaks)
            wave.append((jobs, peaks, max_peaks))
            wave_bytes += nbytes
        self._fetch_wave(blocks, wave, search, plan.windows)
        for b in blocks:
            if b:
                self._collect(b, plan, dispatch_lists, expand, per_dm)
                self.n_searched += len(b["todo"])
        return True

    @staticmethod
    def _job(block: dict, r0: int, row_blk: int):
        """The search_rows arguments of rows [r0, r0 + row_blk) of one
        shard's block on its device, slices of the round's tables, and the
        bounds of their DM trials from the host's copy; None past its last
        row."""
        host = block["row_dm"][r0 : r0 + row_blk]
        if not len(host):
            return None
        r1 = r0 + len(host)
        row_dm = block["row_dm_dev"][r0:r1]
        return (block["xd"], row_dm, block["afs"][r0:r1], block["mean"][row_dm],
                block["std"][row_dm], (int(host.min()), int(host.max())))

    def _learn_total(self, total: int) -> None:
        """Raise the speculative stream size to cover ``total`` entries,
        capped so that one busy round does not inflate every later fetch
        (the JAX package's rule)."""
        self._learned_total_pad = min(max(self._learned_total_pad, _pow2(total)),
                                      TOTAL_PAD_CAP)

    def _fetch_wave(self, blocks: list, wave: list, search, windows) -> None:
        """Read back the pending row batches ``wave`` ([(jobs, peaks of each
        shard, max_peaks)], in row order): each shard's batches packed on its
        device (:meth:`_pack`) and fetched in one transfer, every shard
        packed before the first fetch waits (:meth:`_unpack`). Each batch's
        (cluster counts (rows, nlev), idxs, snrs) goes to its block's
        results, in row order, and the speculation learns each shard's
        total. Runs as the span ``Wave-Fetch``."""
        with trace_span("Wave-Fetch"):
            trace_count("wave.rounds")
            packs = [None if b is None else self._pack(
                b["dev"], [(jobs[s], peaks[s], mp) for jobs, peaks, mp in wave
                           if peaks[s] is not None])
                for s, b in enumerate(blocks)]
            for s, (b, pack) in enumerate(zip(blocks, packs)):
                if pack is not None:
                    got = self._unpack(search, windows, s, len(blocks), b["dev"], *pack)
                    self._learn_total(sum(len(g[1]) for g in got))
                    b["results"].extend(got)

    def _pack(self, dev, batches: list) -> tuple:
        """(batches, their slot arrays concatenated, the packed payload at
        the learned speculative size) of one shard's ``batches`` [(job,
        peaks, max_peaks)], all dispatched at one max_peaks, or None where
        there are none."""
        if not batches:
            return None
        with device_context(dev):
            slots = [torch.cat([p[f] for _, p, _ in batches])
                     for f in range(len(AccelSearchPeaks._fields))]
            return batches, slots, pack_chunk_results(
                *slots, total_pad=self._learned_total_pad)

    def _unpack(self, search, windows, s: int, nshards: int, dev, batches: list,
                slots: list, packed: torch.Tensor) -> list:
        """Fetch one shard's packed batches in one transfer and return each
        batch's (cluster counts, idxs, snrs). Where the entries the batches
        that fit their slots need lie past the speculation, the stream is
        compacted again at their size (one transfer more). The batches
        whose clusters overflowed their slots are dispatched again together
        at the next power of two of the largest count (the reference sizes
        for 100000 up front, peakfinder.hpp:61), in groups within
        ``WAVE_BUDGET``, each group packed and fetched as one."""
        cfg = self.config
        nlev = cfg.nharmonics + 1
        max_peaks = batches[0][2]
        with trace_span("Fetch"):
            words = _fetch(packed)
        n = slots[3].numel()
        cc = words[n : 2 * n].reshape(-1, nlev)
        cc0 = np.minimum(cc, np.int32(max_peaks))
        ends = np.concatenate([[0], np.cumsum(cc0.sum(axis=1))])
        rows = np.concatenate([[0], np.cumsum([len(job[1]) for job, _, _ in batches])])
        worst = [int(cc[rows[i] : rows[i + 1]].max()) for i in range(len(batches))]
        need = max((int(ends[rows[i + 1]]) for i, w in enumerate(worst) if w <= max_peaks),
                   default=0)
        stream = words[2 * n :]
        if need > len(stream) // 2:  # the speculation missed: compact at the size needed
            with device_context(dev), trace_span("Fetch"):
                trace_count("wave.recompactions")
                stream = _fetch(compact_peaks_device(
                    slots[0], slots[1], slots[3], total_pad=_pow2(need)))
        self._learn_total(need)
        half = len(stream) // 2
        vi, vs = stream[:half], stream[half:].view(np.float32)
        out = [(cc0[rows[i] : rows[i + 1]], vi[ends[rows[i]] : ends[rows[i + 1]]],
                vs[ends[rows[i]] : ends[rows[i + 1]]]) for i in range(len(batches))]
        over = [i for i, w in enumerate(worst) if w > max_peaks]
        if not over:
            return out
        new = 1 << int(np.ceil(np.log2(max(worst[i] for i in over))))
        self._learned_max_peaks = max(self._learned_max_peaks, new)
        current_telemetry().event("max_peaks_escalated", old=int(max_peaks), new=int(new),
                                  observed=max(worst[i] for i in over))
        log.debug("cluster overflow: escalating max_peaks %d -> %d (observed %d), "
                  "%d of %d row batches again", max_peaks, new, max(worst), len(over),
                  len(batches))
        groups, nbytes = [[]], 0
        for i in over:
            b = (rows[i + 1] - rows[i]) * nlev * new * 8
            if groups[-1] and nbytes + b > self.WAVE_BUDGET:
                groups.append([])
                nbytes = 0
            groups[-1].append(i)
            nbytes += b
        for group in groups:
            again = []
            for i in group:
                jobs = [None] * nshards
                jobs[s] = batches[i][0]
                trace_count("rows.dispatched", len(jobs[s][1]))
                trace_count("rows.redispatched", len(jobs[s][1]))
                peaks = search(jobs, windows, nharms=cfg.nharmonics, max_peaks=new)[s]
                again.append((batches[i][0], peaks, new))
            for i, got in zip(group, self._unpack(search, windows, s, nshards, dev,
                                                  *self._pack(dev, again))):
                out[i] = got
        return out

    def _collect(self, block: dict, plan, dispatch_lists, expand, per_dm) -> None:
        """Each searched DM trial of one shard's block into ``per_dm``, as
        its ragged cluster stream over its full accel list: the block's
        entries, fetched in (row, level) order, put in each DM trial's
        (level, accel) C order, as the JAX package's device pack streams and
        checkpoints them."""
        results = block["results"]
        cc = np.concatenate([r[0] for r in results])
        vi = np.concatenate([r[1] for r in results])
        vs = np.concatenate([r[2] for r in results])
        ends = np.concatenate([[0], np.cumsum(cc.sum(axis=1))])
        r0 = 0
        for d in block["todo"]:
            r1 = r0 + len(dispatch_lists[d])
            e0, e1 = ends[r0], ends[r1]
            di, ds = _level_major(vi[e0:e1], vs[e0:e1], cc[r0:r1])
            cells = cc[r0:r1].T
            if expand[d] is not None:
                # deduped dispatch: replicate the representative's
                # results onto every accel trial of its class
                di, ds, cells = _expand_accel_results(
                    di, ds, cells, expand[d],
                    _accel_pad(len(plan.accel_lists[d]), self.knobs.accel_bucket),
                )
            per_dm[d] = (di, ds, cells)
            r0 = r1

    def finalize(self, fil: Filterbank, part: PartialSearchResult,
                 fold_exchange=None) -> SearchResult:
        """Global distilling and scoring over the (possibly merged)
        per-DM-trial candidates, then folding of the top ``npdmp`` (the JAX
        package's PeasoupSearch.finalize). ``fold_exchange`` is the
        multi-process hook: callable(this process's fold outcomes) -> every
        process's outcomes (parallel/multihost.py:run_search wires the
        exchange; None for one process)."""
        cfg = self.config
        tel = current_telemetry()
        timers = part.timers
        t0 = time.perf_counter()
        tel.set_stage("distilling")
        with trace_span("Distilling"):
            dm_still = DMDistiller(cfg.freq_tol, keep_related=True)
            harm_still = HarmonicDistiller(
                cfg.freq_tol, cfg.max_harm, keep_related=True, fractional_harms=False
            )
            tel.gauge("candidates.per_dm_total", len(part.cands))
            cands = dm_still.distill(part.cands)
            tel.gauge("candidates.post_dm_distill", len(cands))
            cands = harm_still.distill(cands)
            tel.gauge("candidates.post_harmonic_distill", len(cands))
        timers["distilling"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        tel.set_stage("scoring")
        with trace_span("Scoring"):
            scorer = CandidateScorer(
                fil.tsamp, fil.cfreq, fil.foff, abs(fil.foff) * fil.nchans
            )
            scorer.score_all(cands)
        timers["scoring"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if cfg.npdmp > 0:
            tel.set_stage("folding")
            folder = MultiFolder(
                part.trials, fil.tsamp, device=self.device,
                pos5_freq=cfg.boundary_5_freq, pos25_freq=cfg.boundary_25_freq,
                dm_offset=part.dm_offset,
            )
            outcomes = folder.fold_outcomes(cands, cfg.npdmp)
            if fold_exchange is not None:
                outcomes = fold_exchange(outcomes)
            cands = folder.apply_outcomes(cands, outcomes)
            self._sync()
            tel.gauge("candidates.folded", min(cfg.npdmp, len(cands)))
        timers["folding"] = time.perf_counter() - t0
        cands = cands[: cfg.limit]
        tel.gauge("candidates.final", len(cands))
        timers["total"] = time.perf_counter() - part.t_total_start
        return SearchResult(
            candidates=cands,
            dm_list=part.dm_list,
            acc_list_dm0=part.acc_list_dm0,
            timers=timers,
            nsamps=part.nsamps,
            size=part.size,
            n_accel_trials=part.n_accel_trials,
        )
