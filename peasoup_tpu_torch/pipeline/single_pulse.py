"""The host side of the single-pulse search on one or more CUDA devices:
the JAX package's transient search (peasoup_tpu/pipeline/single_pulse.py)
over the dedispersed DM-time plane.

The DM trials are dedispersed in one kernel launch (csrc/dedisperse.cu)
and stay on the device (or in host RAM, below). With several devices
(pipeline/search.py:_pick_devices) each shard dedisperses a contiguous
1/n of them on its device (parallel/sharded_dedisperse.py) and searches
its own blocks there, the shards' k-th blocks together. Blocks of them, sized from the device's free
memory, are normalised, swept by the boxcar bank with its dec-fold
(csrc/spchain.cu) and compacted to per-trial events
(ops/singlepulse.single_pulse_search_block). The events come back to the
host, where a friends-of-friends pass in (time, DM, width) merges the
detections of one pulse at many DM trials, widths and samples into one
candidate with its footprint (the clustering stage of Heimdall and GSP,
arXiv:2110.12749).

With ``checkpoint_file`` each DM block's events are saved once it is
searched, a later run restores them and searches only the blocks with a
trial missing, and a run with every trial restored skips dedispersion.
Trials whose block would pass ``TRIALS_DEVICE_LIMIT`` bytes stay in host
RAM and upload a block at a time. An out-of-memory error on the card
halves the DM block and retries, keeping the trials already searched (the
JAX package's ``spsearch.memory`` ladder and its ``dm_block_shrink`` rung);
at one trial a block the ladder is exhausted and the error raised: on the
card a search runs or raises, so the JAX package's last rung, the CPU
backend, has no counterpart. The run records the JAX package's ``sp_*``
events, stages and gauges, and the ``device.oom`` fault seam fires at
each attempt.

With ``run(dm_slice=(lo, hi), finalize=False)`` a process of a
multi-process run searches its slice of the global DM list and returns
its raw events (global dm_idx) for the merge
(parallel/multihost.py:run_single_pulse_search). A shard that fails fails
the run: nothing falls back to fewer devices.

With ``tune`` the plan of the observation's shape bucket comes from the
per-device tuning cache, measured on the card on a cold bucket
(perf/tuning.py, the JAX package's pipeline/single_pulse.py:434-447): its
``dedisp_block`` sizes the segments of trials dedispersed into host RAM.
As in the JAX package, the single-pulse search takes nothing else from it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.candidates import SinglePulseCandidate, SinglePulseCandidateCollection
from ..device import device_context
from ..io.masks import read_killfile
from ..io.sigproc import Filterbank
from ..obs.log import get_logger
from ..obs.telemetry import current as current_telemetry
from ..obs.trace import job_span
from ..ops.dedisperse import dedisperse, dedisperse_host, fil_to_device, output_scale
from ..ops.singlepulse import default_widths, plan_pad, single_pulse_search_block
from ..parallel.mesh import make_mesh
from ..parallel.sharded_dedisperse import dedisperse_sharded, shard_bounds
from ..plan.dm_plan import DMPlan
from ..resilience import DegradationLadder, check_revoke, faults
from ..utils import ProgressBar, trace_span
from .checkpoint import SearchCheckpoint
from .search import _is_oom, _pick_devices, _release, _trial_rows

log = get_logger("single_pulse")


@dataclass
class SinglePulseConfig:
    """The JAX package's SinglePulseConfig with its defaults
    (Heimdall/GSP practice; the reference has no single-pulse search),
    less its TPU knobs dedisp_block and use_pallas (a host-RAM segment is
    dedisperse_host's default height, or the tuned one). ``max_num_threads``
    caps the cards the DM trials are sharded over and ``shard_devices``
    forces a shard count (pipeline/search.py:_pick_devices). ``tune``
    resolves the dedispersion plan from the tuning cache at
    ``tuning_cache`` ("" = perf/tuning.py:default_cache_path)."""

    outdir: str = "."
    killfilename: str = ""
    limit: int = 1000
    dm_start: float = 0.0
    dm_end: float = 100.0
    dm_tol: float = 1.10
    dm_pulse_width: float = 64.0
    min_snr: float = 6.0
    n_widths: int = 12  # octave-spaced boxcar widths 1..2^(n-1) samples
    max_width: int = 0  # cap on the widest boxcar (samples); 0 = none
    max_events: int = 256  # events kept per DM trial
    decimate: int = 32  # best-plane max-decimation before the compaction
    time_link: float = 1.0  # friends-of-friends: events link when
    # |dt| <= time_link * max(width_i, width_j) + decimate
    dm_link: int = 2  # ... and |d dm_idx| <= dm_link
    verbose: bool = False
    progress_bar: bool = False
    max_num_threads: int = 14
    dm_block: int = 0  # DM trials per device block; 0 = auto from memory
    hbm_bytes: int = 0  # device memory budget override; 0 = ask the device
    checkpoint_file: str = ""
    shard_devices: int = 0
    tune: bool = False
    tuning_cache: str = ""


@dataclass
class SinglePulseResult:
    candidates: list
    dm_list: np.ndarray
    widths: tuple[int, ...]
    timers: dict
    nsamps: int
    n_events: int = 0  # raw above-threshold events before clustering
    n_overflowed: int = 0  # trials whose event count exceeded max_events


@dataclass
class PartialSinglePulseResult:
    """A search stopped before clustering: what finalize needs."""

    events: np.ndarray  # _EVENT_DTYPE records
    dm_list: np.ndarray
    widths: tuple[int, ...]
    timers: dict
    nsamps: int
    n_overflowed: int
    t_total_start: float


_EVENT_DTYPE = np.dtype(
    [
        ("dm_idx", np.int64),
        ("sample", np.int64),
        ("width_idx", np.int64),
        ("snr", np.float64),
    ]
)


def cluster_events_fof(
    events: np.ndarray,  # _EVENT_DTYPE records
    widths: tuple[int, ...],
    *,
    time_link: float = 1.0,
    dm_link: int = 2,
    dec: int = 32,
) -> list[np.ndarray]:
    """Friends-of-friends in (time, DM, width): two events are friends
    when their start samples lie within ``time_link * max(w_i, w_j) +
    dec`` and their DM trials within ``dm_link``. Width enters through
    the time tolerance, which links the width ladder a bright pulse
    climbs. Returns index arrays, one per cluster.

    The pair scan slides over time-sorted events (the time tolerance is
    bounded by the widest filter), so cost is O(n * window)."""
    n = len(events)
    if n == 0:
        return []
    order = np.argsort(events["sample"], kind="stable")
    ev = events[order]
    wmax_link = time_link * float(max(widths)) + dec
    parent = np.arange(n, dtype=np.int64)

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    w_of = np.asarray(widths, dtype=np.float64)[ev["width_idx"]]
    lo = 0
    for j in range(n):
        while ev["sample"][j] - ev["sample"][lo] > wmax_link:
            lo += 1
        for i in range(lo, j):
            dt = ev["sample"][j] - ev["sample"][i]
            if dt > time_link * max(w_of[i], w_of[j]) + dec:
                continue
            if abs(ev["dm_idx"][j] - ev["dm_idx"][i]) > dm_link:
                continue
            ra, rb = find(i), find(j)
            if ra != rb:
                parent[rb] = ra
    roots: dict[int, list[int]] = {}
    for i in range(n):
        roots.setdefault(find(i), []).append(i)
    return [order[np.asarray(members)] for members in roots.values()]


def candidates_from_clusters(
    events: np.ndarray,  # _EVENT_DTYPE records
    clusters: list[np.ndarray],  # index arrays from cluster_events_fof
    widths: tuple[int, ...],
    dm_list: np.ndarray,
    tsamp: float,
) -> list[SinglePulseCandidate]:
    """Package friends-of-friends clusters as SinglePulseCandidates: the
    peak member and the footprint's extents."""
    w_arr = np.asarray(widths, dtype=np.int64)
    out = []
    for members in clusters:
        ev = events[members]
        peak = int(np.argmax(ev["snr"]))
        widx = int(ev["width_idx"][peak])
        out.append(
            SinglePulseCandidate(
                dm=float(dm_list[int(ev["dm_idx"][peak])]),
                dm_idx=int(ev["dm_idx"][peak]),
                snr=float(ev["snr"][peak]),
                time_s=float(ev["sample"][peak]) * tsamp,
                sample=int(ev["sample"][peak]),
                width=int(w_arr[widx]),
                width_idx=widx,
                members=len(members),
                dm_idx_lo=int(ev["dm_idx"].min()),
                dm_idx_hi=int(ev["dm_idx"].max()),
                sample_lo=int(ev["sample"].min()),
                sample_hi=int(ev["sample"].max()),
                width_lo=int(w_arr[ev["width_idx"]].min()),
                width_hi=int(w_arr[ev["width_idx"]].max()),
            )
        )
    return out


def make_checkpoint_key(
    cfg: SinglePulseConfig, fil, global_ndm: int, widths: tuple[int, ...]
) -> str:
    """The single-pulse search's checkpoint key: everything that changes
    its per-trial events, the observation's header included, under its
    own format tag so a periodicity store never resumes it (the JAX
    package's make_checkpoint_key, field for field)."""
    h = fil.header
    fields = (
        "sp-v1",  # single-pulse per-trial payload format version
        fil.nsamps, fil.nchans, global_ndm,
        fil.tsamp, fil.fch1, fil.foff,
        getattr(h, "tstart", None), getattr(h, "source_name", None),
        getattr(h, "nbits", None),
        cfg.dm_start, cfg.dm_end, cfg.dm_tol, cfg.dm_pulse_width,
        cfg.min_snr, tuple(int(w) for w in widths), cfg.max_events,
        cfg.decimate, cfg.killfilename,
    )
    return repr(fields)


class SinglePulseSearch:
    # bytes of device memory one DM trial of a block holds per padded
    # sample: ~4 f32 planes (normalised series, prefix sums, and their
    # temporaries); the auto block keeps 4x headroom and at most 256
    # trials, as the JAX package sizes it
    BYTES_PER_SAMPLE = 16
    MAX_DM_BLOCK = 256
    # the JAX package's budget where the device reports none (the CPU)
    DEFAULT_MEMORY = 12_000_000_000
    # trial blocks larger than this stay in host RAM (a third of the device
    # memory, 4 GB where none is known, as the JAX package sets it)
    TRIALS_DEVICE_LIMIT = 4_000_000_000

    def __init__(self, config: SinglePulseConfig, device: str | torch.device = "cuda",
                 devices=None):
        self.config = config
        self.devices = _pick_devices(device, config, devices)
        self.device = self.devices[0]
        self.mesh = make_mesh({"dm": len(self.devices)}, devices=self.devices)
        # shards that share the busiest device share its memory
        self._share = max(self.devices.count(d) for d in self.devices)
        limit = config.hbm_bytes
        if not limit and self.device.type == "cuda":
            limit = torch.cuda.mem_get_info(self.device)[1]
        if limit:
            self.TRIALS_DEVICE_LIMIT = int(limit) // 3
        # DM trials the last run searched (the rest were restored)
        self.n_searched = 0
        # the tuned dedispersion plan of the last run (None without tune)
        self.dedisp_plan = None

    def build_dm_plan(self, fil: Filterbank) -> DMPlan:
        """The dedispersion plan: the same construction as the
        periodicity search's."""
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

    def widths_for(self, out_nsamps: int) -> tuple[int, ...]:
        """The run's boxcar bank: octave-spaced, capped so the widest
        filter is at most a quarter of the trial, and by cfg.max_width."""
        cap = max(1, out_nsamps // 4)
        if self.config.max_width:
            cap = min(cap, self.config.max_width)
        return default_widths(self.config.n_widths, max_width=cap)

    def dm_block(self, tpad: int) -> int:
        """DM trials per device block of one shard: cfg.dm_block, else a
        quarter of the memory budget (shared by the shards on one device)
        over BYTES_PER_SAMPLE * tpad, at most MAX_DM_BLOCK."""
        cfg = self.config
        if cfg.dm_block > 0:
            return cfg.dm_block
        if cfg.hbm_bytes:
            total = cfg.hbm_bytes
        elif self.device.type == "cuda":
            total, _ = torch.cuda.mem_get_info(self.device)
        else:
            total = self.DEFAULT_MEMORY
        per_trial = self.BYTES_PER_SAMPLE * tpad
        return int(max(1, min(self.MAX_DM_BLOCK,
                              (total // 4 // self._share) // max(1, per_trial))))

    def _sync(self) -> None:
        for dev in set(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def run(
        self,
        fil: Filterbank,
        dm_slice: tuple[int, int] | None = None,
        finalize: bool = True,
    ) -> SinglePulseResult | PartialSinglePulseResult:
        """Full search of ``fil``: plan, dedisperse, search the DM trials
        block by block, then cluster (:meth:`finalize`). With
        ``dm_slice=(lo, hi)`` only that contiguous block of the global
        DM-trial list is searched (events carry global dm_idx); with
        ``finalize=False`` the run stops before clustering."""
        cfg = self.config
        tel = current_telemetry()
        timers: dict[str, float] = {}
        t_total = time.perf_counter()

        t0 = time.perf_counter()
        tel.set_stage("plan")
        global_plan = self.build_dm_plan(fil)
        widths = self.widths_for(global_plan.out_nsamps)
        plan, dm_lo = global_plan, 0
        if dm_slice is not None:
            dm_lo = dm_slice[0]
            plan = global_plan.subset(*dm_slice)
        timers["plan"] = time.perf_counter() - t0
        tel.gauge("sp.n_dm_trials", int(global_plan.ndm))
        tel.gauge("sp.n_widths", len(widths))
        tel.event("sp_plan", ndm=int(global_plan.ndm),
                  out_nsamps=int(global_plan.out_nsamps), widths=[int(w) for w in widths],
                  dm_slice=[int(dm_lo), int(dm_lo + plan.ndm)])
        if plan.ndm == 0:
            # an empty slice (more processes than DM trials) contributes no
            # events and never touches the device
            part = PartialSinglePulseResult(
                events=np.zeros(0, dtype=_EVENT_DTYPE), dm_list=global_plan.dm_list,
                widths=widths, timers={**timers, "dedispersion": 0.0, "searching": 0.0},
                nsamps=fil.nsamps, n_overflowed=0, t_total_start=t_total,
            )
            return self.finalize(fil, part) if finalize else part

        # the checkpoint store, loaded before dedispersion: a run whose every
        # trial is restored skips it. A slice's store is its own sibling
        # file, local keys (checkpoint.py)
        ckpt = None
        per_dm: dict[int, tuple] = {}
        if cfg.checkpoint_file:
            ckpt = SearchCheckpoint(
                cfg.checkpoint_file,
                make_checkpoint_key(cfg, fil, global_plan.ndm, widths),
                slice_bounds=dm_slice,
            )
            per_dm = ckpt.load()
            if per_dm:
                log.info("resuming: %d/%d DM trials restored from %s",
                         len(per_dm), plan.ndm, cfg.checkpoint_file)
        skip_dedisp = plan.ndm > 0 and all(d in per_dm for d in range(plan.ndm))

        # the tuned segment height of the host-RAM trials
        seg = {}
        self.dedisp_plan = None
        if cfg.tune:
            from ..perf.tuning import resolve_plan_for_filterbank

            self.dedisp_plan = resolve_plan_for_filterbank(
                fil, "spsearch", cfg, cfg.tuning_cache or None, device=self.device
            )
            log.info("dedispersion plan: dedisp_block=%d (%s): %s",
                     self.dedisp_plan.dedisp_block, self.dedisp_plan.source,
                     self.dedisp_plan.summary())
            tel.event("dedisp_plan", **self.dedisp_plan.summary())
            tel.set_context(dedisp_plan=self.dedisp_plan.summary())
            if self.dedisp_plan.dedisp_block:
                seg = dict(block=self.dedisp_plan.dedisp_block)

        t0 = time.perf_counter()
        tel.set_stage("dedispersion")
        # sharded trials spread over the shards' devices
        trials_bytes = plan.ndm * plan.out_nsamps
        spill = trials_bytes > self.TRIALS_DEVICE_LIMIT * len(set(self.devices))
        tel.event("sp_device_plan", n_devices=len(self.devices),
                  sharded=len(self.devices) > 1, trials_spill=bool(spill),
                  trials_bytes=int(trials_bytes))
        if skip_dedisp:
            log.info("resume fast path: all %d trials restored; dedispersion "
                     "skipped", plan.ndm)
            tel.event("sp_resume_fast_path", ndm=int(plan.ndm))
            trials = np.zeros((0, plan.out_nsamps), dtype=np.uint8)
        else:
            args = (fil_to_device(fil, self.device), plan.delay_samples(),
                    plan.killmask, plan.out_nsamps)
            scale = output_scale(fil.nbits, int(plan.killmask.sum()))
            with trace_span("Dedisperse"):
                if spill:
                    trials = dedisperse_host(*args, scale=scale, **seg)
                elif len(self.devices) > 1:
                    trials = dedisperse_sharded(*args, self.mesh, scale=scale)
                else:
                    trials = dedisperse(*args, scale=scale)
        self._sync()
        timers["dedispersion"] = time.perf_counter() - t0
        tel.capture_device_memory("dedispersion")

        t0 = time.perf_counter()
        tel.set_stage("searching")
        if per_dm and not skip_dedisp:
            tel.event("sp_checkpoint_resume", restored=len(per_dm), ndm=int(plan.ndm))
        tpad, _ = plan_pad(plan.out_nsamps)
        dm_block = self.dm_block(tpad)
        # the JAX package's spsearch.memory ladder, the rung a card has:
        # halve the DM block; at one trial it is exhausted and the error
        # raised (no cpu_backend rung: on the card a search runs or raises)
        ladder = DegradationLadder("spsearch.memory", ("dm_block_shrink", "cpu_backend"))
        shrink, retry = 1, False
        while True:
            if retry:
                _release(*self.devices)
            blk = max(1, dm_block // shrink)
            tel.event("sp_wave_plan", n_chunks=-(-plan.ndm // blk), dm_block=blk,
                      shrink=shrink, backend="default")
            try:
                faults.fire("device.oom", context=f"spsearch:shrink{shrink}")
                self._search_blocks(trials, plan.ndm, blk, widths, per_dm, ckpt)
                break
            except Exception as exc:
                if not _is_oom(exc):
                    raise
                if blk <= 1:
                    ladder.exhausted(dm_block=blk, error=f"{exc!s:.200}")
                    raise
                shrink *= 2
                retry = True
                log.warning("device OOM at dm_block=%d; retrying with dm_block=%d: "
                            "%.200s", blk, max(1, dm_block // shrink), exc)
                tel.event("sp_oom_shrink_retry", dm_block_old=blk, shrink=shrink,
                          error=f"{exc!s:.200}")
                ladder.step("dm_block_shrink", dm_block_old=blk,
                            dm_block_new=max(1, dm_block // shrink), error=f"{exc!s:.200}")
        del trials
        self._sync()
        timers["searching"] = time.perf_counter() - t0
        tel.capture_device_memory("search")

        recs = []
        n_overflowed = 0
        for dm_idx in range(plan.ndm):
            pos_w, snrs, count = per_dm[dm_idx]
            c = int(count)
            n_overflowed += c > len(snrs)
            # the first max_events events of each trial, in ascending time
            recs.extend(
                (dm_idx + dm_lo, int(pos_w[0, i]), int(pos_w[1, i]), float(snrs[i]))
                for i in range(min(c, len(snrs)))
            )
        events = np.asarray(recs, dtype=_EVENT_DTYPE)
        if n_overflowed:
            log.warning(
                "%d DM trials overflowed the %d-event compaction; keeping the "
                "first %d (ascending time) per trial",
                n_overflowed, cfg.max_events, cfg.max_events,
            )
            tel.event("sp_event_overflow", trials=int(n_overflowed),
                      max_events=cfg.max_events)
        part = PartialSinglePulseResult(
            events=events, dm_list=global_plan.dm_list, widths=widths, timers=timers,
            nsamps=fil.nsamps, n_overflowed=n_overflowed, t_total_start=t_total,
        )
        return self.finalize(fil, part) if finalize else part

    def _search_blocks(self, trials, ndm: int, blk: int, widths, per_dm, ckpt) -> None:
        """Search the DM trials in blocks of ``blk`` and put each trial's
        (positions and widths (2, K) i32, snrs (K,) f32, count) in
        ``per_dm``; a block whose every trial is there already is skipped,
        one with a trial missing is searched whole. Each shard searches
        its own contiguous 1/n of the trials on its device, the shards'
        k-th blocks dispatched together before any is read back. Trials
        elsewhere (host RAM, another shard) move to a block's device a
        block at a time. ``ckpt`` saves after each round of blocks."""
        cfg = self.config
        tel = current_telemetry()
        threshold = float(cfg.min_snr)
        bounds = shard_bounds(ndm, len(self.devices))
        self.n_searched = 0
        rounds = range(0, max(hi - lo for lo, hi in bounds), blk)
        tel.set_progress(0, len(rounds), unit="chunks")
        progress = ProgressBar() if cfg.progress_bar else None
        if progress:
            progress.start()
        try:
            for ci, k in enumerate(rounds):
                with job_span("wave", wave=ci), trace_span("SP-Chunk"):
                    outs = self._search_round(trials, per_dm, bounds, k, blk, widths,
                                              threshold)
                if outs and ckpt is not None:
                    with job_span("checkpoint", wave=ci):
                        ckpt.save(per_dm)
                tel.set_progress(ci + 1, len(rounds), unit="chunks")
                if progress:
                    progress.update((ci + 1) / len(rounds))
                if outs:
                    # the revoke seam, right after the checkpoint save
                    check_revoke("spsearch.wave")
        finally:
            if progress:
                progress.stop()
        log.info("searched %d of %d DM trials (%d restored)", self.n_searched,
                 ndm, ndm - self.n_searched)

    def _search_round(self, trials, per_dm, bounds, k, blk, widths, threshold) -> list:
        """The k-th block of every shard, dispatched together before any is
        read back; each searched trial's events into ``per_dm``. Returns
        the blocks searched."""
        cfg = self.config
        outs = []
        for (lo, hi), dev in zip(bounds, self.devices):
            lo, hi = lo + k, min(lo + k + blk, hi)
            if lo >= hi or all(d in per_dm for d in range(lo, hi)):
                continue
            with device_context(dev):
                block = _trial_rows(trials, lo, hi, trials.shape[1], dev)
                outs.append((lo, single_pulse_search_block(
                    block, widths, threshold, cfg.max_events, cfg.decimate
                )))
        for lo, res in outs:
            samples, widx, snrs, counts = (a.cpu().numpy() for a in res)
            for j in range(len(counts)):
                per_dm[lo + j] = (
                    np.stack([samples[j], widx[j]]).astype(np.int32),
                    snrs[j].astype(np.float32),
                    np.int32(counts[j]),
                )
            self.n_searched += len(counts)
            log.debug("DM trials %d..%d searched", lo, lo + len(counts) - 1)
        return outs

    def finalize(
        self, fil: Filterbank, part: PartialSinglePulseResult
    ) -> SinglePulseResult:
        """Cluster the events and package the strongest ``cfg.limit``
        candidates, highest S/N first."""
        cfg = self.config
        tel = current_telemetry()
        timers = part.timers
        t0 = time.perf_counter()
        tel.set_stage("clustering")
        clusters = cluster_events_fof(
            part.events, part.widths, time_link=cfg.time_link,
            dm_link=cfg.dm_link, dec=cfg.decimate,
        )
        cands = SinglePulseCandidateCollection()
        cands.append(
            candidates_from_clusters(
                part.events, clusters, part.widths, part.dm_list, fil.tsamp
            )
        )
        out = sorted(cands, key=lambda c: -c.snr)[: cfg.limit]
        timers["clustering"] = time.perf_counter() - t0
        timers["total"] = time.perf_counter() - part.t_total_start
        tel.gauge("sp.n_events", len(part.events))
        tel.gauge("sp.n_clusters", len(clusters))
        tel.gauge("candidates.final", len(out))
        log.info(
            "single-pulse search: %d events -> %d clusters -> %d candidates",
            len(part.events), len(clusters), len(out),
        )
        return SinglePulseResult(
            candidates=out, dm_list=part.dm_list, widths=part.widths,
            timers=timers, nsamps=part.nsamps, n_events=len(part.events),
            n_overflowed=part.n_overflowed,
        )
