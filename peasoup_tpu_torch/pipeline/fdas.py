"""The host side of the Fourier-domain acceleration (and jerk) search on one
CUDA device: the JAX package's pipeline/fdas.py.

The DM plan is the periodicity search's. The trials are dedispersed by the
dedisperse kernel (ops/dedisperse.py), segment by segment into host RAM,
as the JAX driver keeps them; blocks of them upload in turn. Each DM trial
is whitened once and correlated with the (f-dot, f-ddot) template bank
(fdas/templates.py) in (DM block x template batch) tiles
(ops/fdas.py:fdas_block_core); the tiles' cluster peaks come back to the
host, where each template trial's detections are harmonic-distilled, each
DM trial's acceleration-distilled, and the run DM- and harmonic-distilled
and scored (the port's distillers, in its native library by default).

With ``run(dm_slice=(lo, hi), finalize=False)`` a process of a
multi-process run searches its slice of the global DM list only
(parallel/multihost.py:run_fdas_search merges the slices). With
``checkpoint_file`` each DM block's peaks are saved once searched (a
slice's to its own sibling file) and a later run searches only the
trials missing. An out-of-memory error on
the card steps down the JAX package's ladder: halve the template batch
while it can, then the DM block; past that it raises. Each step is
logged, and recorded as the JAX package records it: the ``fdas.memory``
DegradationLadder, the ``fdas_*`` events and the ``device.oom`` fault
seam at each attempt.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..core.candidates import CandidateCollection, FdasCandidate
from ..device import resolve_device
from ..fdas.templates import SPEED_OF_LIGHT, auto_segment, build_template_bank
from ..io.masks import read_killfile, read_zapfile
from ..io.sigproc import Filterbank
from ..obs.log import get_logger
from ..obs.telemetry import current as current_telemetry
from ..ops.dedisperse import dedisperse_host, fil_to_device, output_scale
from ..ops.fdas import fdas_block_core
from ..ops.zap import birdie_mask
from ..plan.dm_plan import DMPlan
from ..plan.fft_plan import choose_fft_size
from ..resilience import DegradationLadder, faults
from ..utils import ProgressBar, trace_span
from .checkpoint import SearchCheckpoint
from .distill import AccelerationDistiller, DMDistiller, HarmonicDistiller
from .score import CandidateScorer
from .search import _freq_factor, _is_oom, _level_windows, _release

log = get_logger("fdas")


@dataclass
class FdasConfig:
    """The JAX package's FdasConfig, field for field and with its defaults.
    The DM-plan and spectrum knobs mirror SearchConfig; zmax and wmax
    bound the f-dot (f-ddot) trial grid in DFT bins over the observation
    (PRESTO's -z and -w)."""

    outdir: str = "."
    killfilename: str = ""
    zapfilename: str = ""
    limit: int = 1000
    size: int = 0  # fft size; 0 = prev power of two
    dm_start: float = 0.0
    dm_end: float = 100.0
    dm_tol: float = 1.10
    dm_pulse_width: float = 64.0
    zmax: float = 64.0  # f-dot extent in bins (0 = pure periodicity)
    zstep: float = 2.0  # f-dot grid spacing in bins
    wmax: float = 0.0  # f-ddot (jerk) extent in bins; 0 = plane off
    wstep: float = 20.0  # f-ddot grid spacing in bins
    boundary_5_freq: float = 0.05
    boundary_25_freq: float = 0.5
    nharmonics: int = 4
    min_snr: float = 9.0
    min_freq: float = 0.1
    max_freq: float = 1100.0
    max_harm: int = 16
    freq_tol: float = 1e-4
    verbose: bool = False
    progress_bar: bool = False
    max_peaks: int = 128  # crossings kept per (trial, template, level)
    segment: int = 0  # overlap-save FFT length; 0 = auto from width
    template_block: int = 0  # template rows per tile; 0 = auto
    dm_block: int = 0  # DM trials per tile; 0 = auto from the memory budget
    checkpoint_file: str = ""  # resumable per-DM-trial result store


@dataclass
class FdasResult:
    candidates: list
    dm_list: np.ndarray
    zs: np.ndarray  # the f-dot trial grid (bins)
    ws: np.ndarray  # the f-ddot trial grid (bins)
    timers: dict
    nsamps: int
    size: int
    n_templates: int = 0
    n_trials: int = 0  # DM x template trials searched


@dataclass
class PartialFdasResult:
    """A run stopped after the per-DM distils (``run(finalize=False)``):
    what :meth:`FdasSearch.finalize` needs."""

    cands: list  # per-DM-trial candidates, dm_idx of the whole list
    dm_offset: int
    dm_list: np.ndarray
    zs: np.ndarray
    ws: np.ndarray
    timers: dict
    nsamps: int
    size: int
    n_templates: int
    n_trials: int
    t_total_start: float


def _fdas_config_key(cfg: FdasConfig, fil, size: int, global_ndm: int) -> str:
    """The FDAS search's checkpoint key: everything that changes its
    per-trial results, the observation's header included (the JAX
    package's, field for field)."""
    h = fil.header
    fields = (
        "fdas-v1-global-dm",
        fil.nsamps, fil.nchans, size, global_ndm,
        fil.tsamp, fil.fch1, fil.foff,
        getattr(h, "tstart", None), getattr(h, "source_name", None),
        getattr(h, "nbits", None),
        cfg.dm_start, cfg.dm_end, cfg.dm_tol, cfg.dm_pulse_width,
        cfg.zmax, cfg.zstep, cfg.wmax, cfg.wstep,
        cfg.boundary_5_freq, cfg.boundary_25_freq, cfg.nharmonics,
        cfg.min_snr, cfg.min_freq, cfg.max_freq, cfg.max_peaks,
        cfg.killfilename, cfg.zapfilename,
    )
    return repr(fields)


class FdasSearch:
    """Dedisperse the DM plan, then correlation-search every trial."""

    # the JAX package's working-set budget where the device reports none
    # (the CPU); on the card, half its free memory
    MEM_BUDGET = 6_000_000_000
    # bytes one (DM, template) cell of a tile holds per spectrum bin at its
    # peak (the overlap-save products and transforms, the levels), as the
    # JAX package budgets it
    CELL_BYTES_PER_BIN = 64

    def __init__(self, config: FdasConfig, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        if native.enabled():
            native.load()  # the distil library builds here or the search raises
        # DM trials the last run searched (the rest were restored), and the
        # (dm_block, template_block) it ended with
        self.n_searched = 0
        self.blocks = (0, 0)

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

    def _auto_blocks(self, nbins: int, ntemplates: int) -> tuple[int, int]:
        """(dm_block, template_block), the JAX package's rule: a template
        batch of at most 64 rows, and as many DM trials (at most 32) as the
        budget holds cells of CELL_BYTES_PER_BIN bytes a bin."""
        cfg = self.config
        budget = self.MEM_BUDGET
        if self.device.type == "cuda":
            budget = torch.cuda.mem_get_info(self.device)[0] // 2
        cells = max(8, budget // (nbins * self.CELL_BYTES_PER_BIN))
        tb = cfg.template_block or min(ntemplates, 64)
        db = cfg.dm_block or max(1, min(32, cells // max(1, tb)))
        return db, tb

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(
        self,
        fil: Filterbank,
        dm_slice: tuple[int, int] | None = None,
        finalize: bool = True,
    ) -> FdasResult | PartialFdasResult:
        """Search ``fil`` (the DM trials [lo, hi) of ``dm_slice`` only, if
        given); ``finalize=False`` stops after the per-DM distils."""
        cfg = self.config
        tel = current_telemetry()
        timers: dict[str, float] = {}
        t_total = time.perf_counter()

        t0 = time.perf_counter()
        tel.set_stage("plan")
        dm_plan = self.build_dm_plan(fil)
        global_ndm = dm_plan.ndm
        dm_lo = 0
        if dm_slice is not None:
            dm_lo, dm_hi = dm_slice
            dm_plan = dm_plan.subset(dm_lo, dm_hi)
        size = choose_fft_size(fil.nsamps, cfg.size)
        bank = build_template_bank(cfg.zmax, cfg.wmax, cfg.zstep, cfg.wstep)
        segment = cfg.segment or auto_segment(bank.width)
        timers["plan"] = time.perf_counter() - t0
        if dm_plan.ndm == 0:
            part = PartialFdasResult(
                cands=[], dm_offset=dm_lo, dm_list=dm_plan.dm_list, zs=bank.zs,
                ws=bank.ws, timers=dict.fromkeys(
                    ("dedispersion", "search_device", "search_host", "searching"), 0.0),
                nsamps=fil.nsamps, size=size, n_templates=bank.ntemplates,
                n_trials=0, t_total_start=t_total,
            )
            return self.finalize(fil, part) if finalize else part
        tel.gauge("fdas.n_dm_trials", int(dm_plan.ndm))
        tel.gauge("fdas.n_templates", int(bank.ntemplates))
        tel.gauge("fdas.fft_size", int(size))
        tel.event("fdas_plan", ndm=int(dm_plan.ndm), n_templates=int(bank.ntemplates),
                  width=int(bank.width), segment=int(segment), zmax=float(cfg.zmax),
                  wmax=float(cfg.wmax), fft_size=int(size))
        log.info("FDAS plan: %d DM trials x %d templates (width %d, segment %d), "
                 "fft size %d", dm_plan.ndm, bank.ntemplates, bank.width, segment, size)

        # a slice's store is its own sibling file, local keys (checkpoint.py)
        ckpt = SearchCheckpoint(
            cfg.checkpoint_file, _fdas_config_key(cfg, fil, size, global_ndm),
            slice_bounds=dm_slice,
        )
        per_dm: dict[int, tuple] = {}
        if cfg.checkpoint_file:
            per_dm = ckpt.load()
            if per_dm:
                log.info("resuming: %d/%d DM trials restored from %s",
                         len(per_dm), dm_plan.ndm, cfg.checkpoint_file)

        # trials in host RAM, dedispersed by the kernel segment by segment
        t0 = time.perf_counter()
        tel.set_stage("dedispersion")
        trials = np.zeros((0, dm_plan.out_nsamps), dtype=np.uint8)
        if len(per_dm) < dm_plan.ndm:
            with trace_span("Dedisperse"):
                trials = dedisperse_host(
                    fil_to_device(fil, self.device), dm_plan.delay_samples(),
                    dm_plan.killmask, dm_plan.out_nsamps,
                    scale=output_scale(fil.nbits, int(dm_plan.killmask.sum())),
                )
        self._sync()
        timers["dedispersion"] = time.perf_counter() - t0
        tel.capture_device_memory("dedispersion")
        if per_dm:
            tel.event("checkpoint_resume", restored=len(per_dm), ndm=int(dm_plan.ndm))

        nsamps_valid = min(dm_plan.out_nsamps, size)
        tobs = float(np.float32(size) * np.float32(fil.tsamp))
        bin_width = float(np.float32(1.0 / tobs))
        size_spec = size // 2 + 1
        if cfg.zapfilename:
            zapmask = birdie_mask(*read_zapfile(cfg.zapfilename), bin_width, size_spec)
        else:
            zapmask = np.zeros(size_spec, dtype=bool)
        windows = _level_windows(size, cfg.nharmonics, cfg.min_freq, cfg.max_freq,
                                 fil.tsamp)
        factors = [_freq_factor(size, nh, fil.tsamp) for nh in range(cfg.nharmonics + 1)]
        geometry = dict(
            size=size, nsamps_valid=nsamps_valid, segment=segment,
            pos5=int(cfg.boundary_5_freq / bin_width),
            pos25=int(cfg.boundary_25_freq / bin_width),
        )

        t0 = time.perf_counter()
        tel.set_stage("searching")
        progress = ProgressBar() if cfg.progress_bar else None
        if progress:
            progress.start()
        try:
            self._run_blocks(trials, dm_plan.ndm, bank, zapmask, windows, per_dm,
                             ckpt, geometry, progress)
        finally:
            if progress:
                progress.stop()
        del trials
        self._sync()
        timers["search_device"] = time.perf_counter() - t0
        tel.capture_device_memory("search")

        t_host = time.perf_counter()
        tel.set_stage("search_host")
        harm_finder = HarmonicDistiller(cfg.freq_tol, cfg.max_harm, keep_related=False)
        tmpl_still = AccelerationDistiller(tobs, cfg.freq_tol, keep_related=True)
        dm_trial_cands = CandidateCollection()
        zs, ws = bank.zs, bank.ws
        for dm_idx, dm in enumerate(dm_plan.dm_list):
            idxs, snrs, ccounts = per_dm.pop(dm_idx)
            tmpl_trial_cands = CandidateCollection()
            for t in range(bank.ntemplates):
                z, w = float(zs[t]), float(ws[t])
                trial_cands = [
                    self._candidate(float(dm), dm_idx + dm_lo, z, w, lvl, float(s),
                                    int(b), factors, tobs)
                    for lvl in range(cfg.nharmonics + 1)
                    for b, s in zip(idxs[lvl, t, : ccounts[lvl, t]],
                                    snrs[lvl, t, : ccounts[lvl, t]])
                ]
                tmpl_trial_cands.append(harm_finder.distill(trial_cands))
            dm_trial_cands.append(tmpl_still.distill(tmpl_trial_cands.cands))
        timers["search_host"] = time.perf_counter() - t_host
        timers["searching"] = time.perf_counter() - t0
        tel.gauge("candidates.per_dm_distill", len(dm_trial_cands))

        part = PartialFdasResult(
            cands=dm_trial_cands.cands, dm_offset=dm_lo, dm_list=dm_plan.dm_list,
            zs=zs, ws=ws, timers=timers, nsamps=fil.nsamps, size=size,
            n_templates=bank.ntemplates, n_trials=dm_plan.ndm * bank.ntemplates,
            t_total_start=t_total,
        )
        return self.finalize(fil, part) if finalize else part

    def _candidate(self, dm, dm_idx, z, w, lvl, snr, bin_idx, factors, tobs) -> FdasCandidate:
        """One detection -> candidate, as the JAX package builds it. The
        detection bin is the start-of-observation frequency of the matched
        drifting tone; the reported frequency is the mean over the
        observation, f = (bin + z/2 + w/6) * factor, which the time-domain
        search recovers. At z = w = 0 the stored f32 freq is the plain
        search's f32(bin * factor)."""
        factor = float(factors[lvl])
        freq = float(np.float32(np.float32(bin_idx) * factors[lvl]))
        corr = (z / 2.0 + w / 6.0) * factor
        if corr:
            freq = float(np.float32(freq + corr))
        # the template grid is in drift bins at the detected level; the
        # fundamental's f-dot scales by the same per-level factor
        fdot = z * factor / tobs
        fddot = w * factor / (tobs * tobs)
        acc = -fdot * SPEED_OF_LIGHT / freq if freq > 0 and fdot else 0.0
        return FdasCandidate(
            dm=dm, dm_idx=dm_idx, acc=acc, nh=lvl, snr=snr, freq=freq,
            fdot=fdot, fddot=fddot, z=z, w=w,
        )

    def _run_blocks(self, trials, ndm, bank, zapmask, windows, per_dm, ckpt,
                    geometry, progress=None) -> None:
        """Every DM trial missing from ``per_dm`` in (dm_block x
        template_block) tiles, under the JAX package's two-rung memory
        ladder: on an out-of-memory error halve the template batch while it
        is above one row, then the DM block; past that raise. Each DM
        block's (idxs, snrs, cluster counts) per trial, (nlev, T, K), go to
        ``per_dm`` and the store; ``progress`` (a ProgressBar) is
        updated after each."""
        cfg = self.config
        tel = current_telemetry()
        dev = self.device
        nbins = geometry["size"] // 2 + 1
        ntemplates = bank.ntemplates
        db, tb = self._auto_blocks(nbins, ntemplates)
        db, tb = min(db, ndm), min(tb, ntemplates)
        zap_dev = torch.from_numpy(zapmask).to(dev)
        tmpl_all = torch.from_numpy(bank.templates).to(dev)
        tim_len = min(geometry["size"], trials.shape[1])
        threshold = float(np.float32(cfg.min_snr))
        self.n_searched = 0
        ladder = DegradationLadder("fdas.memory", ("template_block_shrink", "dm_block_shrink"))
        retry = False
        while True:
            if retry:
                _release(dev)
            self.blocks = (db, tb)
            todo = [d for d in range(ndm) if d not in per_dm]
            tel.event("fdas_wave_plan", n_blocks=-(-len(todo) // db), dm_block=db,
                      template_block=tb, n_template_batches=-(-ntemplates // tb))
            tel.set_progress(ndm - len(todo), ndm, unit="dm trials")
            try:
                faults.fire("device.oom", context=f"fdas:db{db}.tb{tb}")
                for s0 in range(0, len(todo), db):
                    rows = todo[s0 : s0 + db]
                    tims = torch.from_numpy(trials[rows, :tim_len]).to(dev)
                    parts = [
                        fdas_block_core(
                            tims, tmpl_all[t0 : t0 + tb], zap_dev, windows,
                            threshold=threshold, nharms=cfg.nharmonics,
                            max_peaks=cfg.max_peaks, **geometry,
                        )
                        for t0 in range(0, ntemplates, tb)
                    ]
                    del tims
                    # one copy to the host a field, the template batches
                    # joined along the template axis
                    idxs, snrs, ccounts = (
                        # audit: ignore[PSA001] -- host distil: a copy a field
                        torch.cat([getattr(p, f) for p in parts], dim=2).cpu().numpy()
                        for f in ("idxs", "snrs", "ccounts")
                    )
                    del parts
                    for k, d in enumerate(rows):
                        per_dm[d] = (idxs[k], snrs[k], ccounts[k])
                    self.n_searched += len(rows)
                    ckpt.save(per_dm)
                    tel.set_progress(ndm - len(todo) + s0 + len(rows), ndm,
                                     unit="dm trials")
                    if progress:
                        progress.update((ndm - len(todo) + s0 + len(rows)) / ndm)
                log.info("searched %d of %d DM trials (%d restored) in tiles of %d DM "
                         "x %d templates", self.n_searched, ndm, ndm - self.n_searched,
                         db, tb)
                return
            except Exception as exc:
                if not _is_oom(exc):
                    raise
                retry = True
                if tb > 1:
                    tb = max(1, tb // 2)
                    log.warning("device OOM; halving the template batch to %d: %.200s",
                                tb, exc)
                    tel.event("fdas_oom_template_shrink", template_block=tb,
                              error=f"{exc!s:.200}")
                    if ladder.current_rung in (None, "template_block_shrink"):
                        ladder.step("template_block_shrink", template_block=tb,
                                    error=f"{exc!s:.200}")
                elif db > 1:
                    db = max(1, db // 2)
                    log.warning("device OOM at template_block=1; halving the DM block "
                                "to %d: %.200s", db, exc)
                    tel.event("fdas_oom_dm_shrink", dm_block=db, error=f"{exc!s:.200}")
                    ladder.step("dm_block_shrink", dm_block=db, error=f"{exc!s:.200}")
                else:
                    ladder.exhausted(dm_block=db, template_block=tb,
                                     error=f"{exc!s:.200}")
                    raise

    def finalize(self, fil: Filterbank, part: PartialFdasResult) -> FdasResult:
        """The global distil and scoring of the per-DM candidates (the JAX
        package's FdasSearch.finalize)."""
        cfg = self.config
        tel = current_telemetry()
        timers = part.timers
        t0 = time.perf_counter()
        tel.set_stage("distilling")
        dm_still = DMDistiller(cfg.freq_tol, keep_related=True)
        harm_still = HarmonicDistiller(
            cfg.freq_tol, cfg.max_harm, keep_related=True, fractional_harms=False
        )
        tel.gauge("candidates.per_dm_total", len(part.cands))
        cands = harm_still.distill(dm_still.distill(part.cands))
        tel.gauge("candidates.post_harmonic_distill", len(cands))
        timers["distilling"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        tel.set_stage("scoring")
        scorer = CandidateScorer(fil.tsamp, fil.cfreq, fil.foff, abs(fil.foff) * fil.nchans)
        scorer.score_all(cands)
        timers["scoring"] = time.perf_counter() - t0

        cands = cands[: cfg.limit]
        tel.gauge("candidates.final", len(cands))
        timers["total"] = time.perf_counter() - part.t_total_start
        log.info("FDAS search: %d DM x %d template trials -> %d candidates",
                 len(part.dm_list), part.n_templates, len(cands))
        return FdasResult(
            candidates=cands, dm_list=part.dm_list, zs=part.zs, ws=part.ws,
            timers=timers, nsamps=part.nsamps, size=part.size,
            n_templates=part.n_templates, n_trials=part.n_trials,
        )
