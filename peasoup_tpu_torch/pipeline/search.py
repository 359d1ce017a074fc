"""The host side of the search: the reference's `peasoup` main + Worker loop
(reference: src/pipeline_multi.cu:262-419, 83-254) on one CUDA device.

The DM trials are dedispersed in one kernel launch and stay on the
device. Blocks of DM trials are preprocessed together, and their
(DM, accel) trials run as row batches of the acceleration chain
(pipeline/accel_search.py), sized from the device's free memory. Cluster
peaks come back to the host, where candidate building, distilling and
scoring run on small arrays, as in the reference.

With npdmp > 0 the top candidates are folded and optimised
(pipeline/folder.py) from the dedispersed trials the device still holds.

Not ported yet, and refused with NotImplementedError: subband or matmul
dedispersion, checkpoints, the tuning cache, more than one device, and
the JAX package's out-of-memory degradation ladder.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..core.candidates import Candidate, CandidateCollection
from ..device import resolve_device
from ..io.masks import read_killfile, read_zapfile
from ..io.sigproc import Filterbank
from ..ops.dedisperse import dedisperse, fil_to_device, output_scale
from ..ops.resample import accel_factor
from ..ops.zap import birdie_mask
from ..plan.accel_plan import AccelerationPlan
from ..plan.dm_plan import DMPlan
from ..plan.fft_plan import choose_fft_size
from ..plan.search_plan import SearchPlan, from_arrays
from .accel_search import preprocess_block, search_rows
from .distill import AccelerationDistiller, DMDistiller, HarmonicDistiller
from .folder import MultiFolder
from .score import CandidateScorer

log = logging.getLogger("peasoup_tpu_torch.search")


@dataclass
class SearchConfig:
    """Mirrors CmdLineOptions with the reference's defaults
    (include/utils/cmdline.hpp:69-209), and the JAX package's
    SearchConfig field for field. Fields for features the port does not
    have yet must keep their defaults (PeasoupSearch refuses others);
    the JAX package's TPU tuning knobs (dedisp_block, subband_matmul,
    use_pallas, use_pallas_peaks, tuning_cache, max_num_threads) have no
    effect here, and accel_bucket only pads the deduped results."""

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


@dataclass
class SearchResult:
    candidates: list
    dm_list: np.ndarray
    acc_list_dm0: np.ndarray
    timers: dict
    nsamps: int
    size: int
    n_accel_trials: int = 0  # DM x accel trials, deduped ones included


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
    trials: torch.Tensor | None = None  # (ndm, out_nsamps) u8, kept on
    # the search's device for folding when npdmp > 0


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


def _unsupported(cfg: SearchConfig) -> str | None:
    if cfg.subbands > 0 or cfg.dedisp_engine == "matmul":
        return "subband and matmul dedispersion are ROADMAP item A.3"
    if cfg.checkpoint_file:
        return "checkpoints are ROADMAP item A.8"
    if cfg.tune:
        return "the tuning cache is ROADMAP item A.16"
    if cfg.shard_devices > 1:
        return "searching on more than one device is ROADMAP item A.15"
    return None


class PeasoupSearch:
    # bytes of device memory one (DM, accel) row of the acceleration
    # chain holds at its peak, and one DM trial of the preprocessing
    # block, per time sample of the FFT length (resample indices, the
    # series, its DFT, the spectrum, and their temporaries)
    ROW_BYTES_PER_SAMPLE = 64
    DM_BYTES_PER_SAMPLE = 64

    def __init__(self, config: SearchConfig, device: str | torch.device = "cuda"):
        why = _unsupported(config)
        if why:
            raise NotImplementedError(f"not ported yet: {why}")
        self.config = config
        self.device = resolve_device(device)
        # cluster slots learned from overflowing chunks, so later chunks
        # dispatch once
        self._learned_max_peaks = 0

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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _memory_budget(self) -> int:
        if self.config.hbm_bytes:
            return self.config.hbm_bytes // 2
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            return int(free * 0.6)
        return 2_000_000_000

    def run(self, fil: Filterbank, plan: SearchPlan | None = None) -> SearchResult:
        """Full search of ``fil``; ``plan`` defaults to :meth:`build_plan`."""
        cfg = self.config
        dev = self.device
        timers: dict[str, float] = {}
        t_total = time.perf_counter()

        t0 = time.perf_counter()
        if plan is None:
            plan = self.build_plan(fil)
        if plan.nharms != cfg.nharmonics:
            raise ValueError("plan windows do not match config.nharmonics")
        timers["plan"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        trials = dedisperse(
            fil_to_device(fil, dev),
            torch.from_numpy(plan.delays).to(dev),
            torch.from_numpy(plan.killmask).to(dev),
            plan.out_nsamps,
            scale=output_scale(fil.nbits, int(plan.killmask.sum())),
        )
        self._sync()
        timers["dedispersion"] = time.perf_counter() - t0

        size = plan.size
        tobs = float(np.float32(size) * np.float32(fil.tsamp))
        # float bin_width = 1.0/tobs (pipeline_multi.cu:119)
        bin_width = float(np.float32(1.0 / tobs))
        geometry = dict(
            size=size,
            nsamps_valid=min(plan.out_nsamps, size),
            pos5=int(cfg.boundary_5_freq / bin_width),
            pos25=int(cfg.boundary_25_freq / bin_width),
        )
        accel_lists = plan.accel_lists
        if cfg.dedupe_accel:
            dispatch_lists, expand = _dedupe_identity_accels(
                accel_lists, fil.tsamp, size
            )
        else:
            dispatch_lists, expand = list(accel_lists), [None] * plan.ndm

        t0 = time.perf_counter()
        per_dm = self._search_trials(
            trials, plan, dispatch_lists, fil.tsamp, geometry
        )
        if cfg.npdmp <= 0:
            trials = None  # only the folder reads the trials again
        self._sync()
        timers["search_device"] = time.perf_counter() - t0

        t_host = time.perf_counter()
        harm_finder = HarmonicDistiller(cfg.freq_tol, cfg.max_harm, keep_related=False)
        acc_still = AccelerationDistiller(tobs, cfg.freq_tol, keep_related=True)
        dm_trial_cands = CandidateCollection()
        for dm_idx, dm in enumerate(plan.dm_list):
            accs = accel_lists[dm_idx]
            vi, vs, cc = per_dm.pop(dm_idx)
            if expand[dm_idx] is not None:
                # deduped dispatch: replicate the representative's results
                # onto every accel trial of its class
                vi, vs, cc = _expand_accel_results(
                    vi, vs, cc, expand[dm_idx],
                    _accel_pad(len(accs), cfg.accel_bucket),
                )
            idxs, snrs, ccounts = _densify_ragged(vi, vs, cc)
            accel_trial_cands = CandidateCollection()
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
                accel_trial_cands.append(harm_finder.distill(trial_cands))
            dm_trial_cands.append(acc_still.distill(accel_trial_cands.cands))
            log.debug(
                "DM %.3f (%d/%d): %d accel trials, %d cands so far",
                dm, dm_idx + 1, plan.ndm, len(accs), len(dm_trial_cands),
            )
        timers["search_host"] = time.perf_counter() - t_host
        timers["searching"] = time.perf_counter() - t0

        part = PartialSearchResult(
            cands=dm_trial_cands.cands,
            dm_list=plan.dm_list,
            acc_list_dm0=self._accel_plan(fil, size).generate_accel_list(0.0),
            timers=timers,
            nsamps=fil.nsamps,
            size=size,
            n_accel_trials=sum(len(a) for a in accel_lists),
            t_total_start=t_total,
            trials=trials,
        )
        return self.finalize(fil, part)

    def _search_trials(self, trials, plan, dispatch_lists, tsamp, geometry):
        """Run every dispatched (DM, accel) trial. Returns per DM trial its
        ragged cluster stream (bins, snrs, counts (nlev, n_dispatch)):
        the valid cluster slots of every (level, accel) cell in C order,
        as the JAX package packs them."""
        cfg = self.config
        dev = self.device
        size = geometry["size"]
        budget = self._memory_budget()
        d_blk = cfg.dm_block or max(
            1, min(plan.ndm, budget // 2 // (self.DM_BYTES_PER_SAMPLE * size))
        )
        row_blk = max(1, budget // 2 // (self.ROW_BYTES_PER_SAMPLE * size))
        zapmask = torch.from_numpy(plan.zapmask).to(dev)
        threshold = float(np.float32(cfg.min_snr))
        per_dm: dict[int, list] = {}
        for lo in range(0, plan.ndm, d_blk):
            dms = range(lo, min(lo + d_blk, plan.ndm))
            tims = trials[lo : dms[-1] + 1, :size]
            xd, mean, std = preprocess_block(tims, zapmask, **geometry)
            rows = [(d - lo, a) for d in dms for a in range(len(dispatch_lists[d]))]
            afs_all = {
                d: accel_factor(dispatch_lists[d], tsamp).astype(np.float32)
                for d in dms
            }
            results = []
            for r0 in range(0, len(rows), row_blk):
                batch = rows[r0 : r0 + row_blk]
                row_dm = torch.tensor(
                    [d for d, _ in batch], dtype=torch.int32, device=dev
                )
                afs = torch.from_numpy(
                    np.asarray([afs_all[lo + d][a] for d, a in batch], np.float32)
                ).to(dev)
                results.append(
                    self._search_batch(
                        xd, row_dm, afs, mean[row_dm], std[row_dm],
                        plan.windows, threshold,
                    )
                )
            del xd, mean, std
            # batches dispatched before an overflow escalation have fewer
            # slots; only the first cc slots of a cell are ever read
            mx = max(r[0].shape[-1] for r in results)
            idxs, snrs = (
                np.concatenate([
                    np.pad(r[k], ((0, 0), (0, 0), (0, mx - r[k].shape[-1])))
                    for r in results
                ])
                for k in (0, 1)
            )
            cc = np.concatenate([r[2] for r in results])
            r0 = 0
            for d in dms:
                r1 = r0 + len(dispatch_lists[d])
                # (level, accel) cells in C order, as the JAX package's
                # device pack streams them
                cells = cc[r0:r1].T
                keep = np.arange(mx) < cells[..., None]
                per_dm[d] = (
                    idxs[r0:r1].transpose(1, 0, 2)[keep],
                    snrs[r0:r1].transpose(1, 0, 2)[keep],
                    cells,
                )
                r0 = r1
        return per_dm

    def _search_batch(self, xd, row_dm, afs, mean, std, windows, threshold):
        """One row batch of the DM block ``xd``, re-dispatched at the next
        power of two while a cluster count overflows the slots (the
        reference sizes for 100000 up front, peakfinder.hpp:61). Returns
        numpy (idxs, snrs, cluster counts) of the batch's rows."""
        cfg = self.config
        max_peaks = max(cfg.max_peaks, self._learned_max_peaks)
        while True:
            peaks = search_rows(
                xd, row_dm, afs, mean, std, windows, threshold=threshold,
                nharms=cfg.nharmonics, max_peaks=max_peaks,
            )
            cc = peaks.ccounts.cpu().numpy()
            worst = int(cc.max()) if cc.size else 0
            if worst <= max_peaks:
                break
            old, max_peaks = max_peaks, 1 << int(np.ceil(np.log2(worst)))
            self._learned_max_peaks = max(self._learned_max_peaks, max_peaks)
            log.debug(
                "cluster overflow: escalating max_peaks %d -> %d (observed %d)",
                old, max_peaks, worst,
            )
        return peaks.idxs.cpu().numpy(), peaks.snrs.cpu().numpy(), cc

    def finalize(self, fil: Filterbank, part: PartialSearchResult) -> SearchResult:
        """Global distilling and scoring over the per-DM-trial candidates,
        then folding of the top ``npdmp`` (the JAX package's
        PeasoupSearch.finalize)."""
        cfg = self.config
        timers = part.timers
        t0 = time.perf_counter()
        dm_still = DMDistiller(cfg.freq_tol, keep_related=True)
        harm_still = HarmonicDistiller(
            cfg.freq_tol, cfg.max_harm, keep_related=True, fractional_harms=False
        )
        cands = harm_still.distill(dm_still.distill(part.cands))
        timers["distilling"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        scorer = CandidateScorer(
            fil.tsamp, fil.cfreq, fil.foff, abs(fil.foff) * fil.nchans
        )
        scorer.score_all(cands)
        timers["scoring"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if cfg.npdmp > 0:
            folder = MultiFolder(
                part.trials, fil.tsamp,
                pos5_freq=cfg.boundary_5_freq, pos25_freq=cfg.boundary_25_freq,
            )
            cands = folder.fold_n(cands, cfg.npdmp)
            self._sync()
        timers["folding"] = time.perf_counter() - t0
        timers["total"] = time.perf_counter() - part.t_total_start
        return SearchResult(
            candidates=cands[: cfg.limit],
            dm_list=part.dm_list,
            acc_list_dm0=part.acc_list_dm0,
            timers=timers,
            nsamps=part.nsamps,
            size=part.size,
            n_accel_trials=part.n_accel_trials,
        )
