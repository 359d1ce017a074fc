"""The FFA search pipeline of the port (the JAX package's pipeline/ffa.py):
dedisperse the DM plan with the dedisperse kernel, then run the FFA
staircase (ops/ffa.py) over every trial on the same device."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..io.masks import read_killfile
from ..io.sigproc import Filterbank
from ..obs.log import get_logger
from ..obs.telemetry import current as current_telemetry
from ..ops.dedisperse import dedisperse_host, fil_to_device, output_scale
from ..ops.ffa import ffa_search_block
from ..plan.dm_plan import DMPlan

log = get_logger("ffa")


@dataclass
class FFAConfig:
    """FFA search knobs (the reference's FFACmdLineOptions,
    include/utils/cmdline.hpp:211-292), the JAX package's FFAConfig field
    for field. ``checkpoint_file`` is accepted and unused, as there: the
    octaves fold from scratch and have no per-trial resume."""

    outdir: str = "."
    killfilename: str = ""
    limit: int = 1000
    dm_start: float = 0.0
    dm_end: float = 100.0
    dm_tol: float = 1.10
    dm_pulse_width: float = 64.0
    p_start: float = 0.8  # shortest folded period (s)
    p_end: float = 20.0  # longest folded period (s)
    min_dc: float = 0.001  # minimum duty cycle (fraction)
    min_snr: float = 8.0
    verbose: bool = False
    progress_bar: bool = False
    checkpoint_file: str = ""


@dataclass
class FFAResult:
    candidates: list  # FFACandidate records, period-collapsed
    dm_list: np.ndarray
    timers: dict
    nsamps: int


class FFASearch:
    """Dedisperse the DM plan, then staircase-FFA every trial, on the CUDA
    device unless ``device="cpu"``."""

    def __init__(self, config: FFAConfig, device: str | torch.device = "cuda"):
        self.config = config
        self.device = resolve_device(device)

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

    def run(self, fil: Filterbank, progress=None) -> FFAResult:
        """Full search of ``fil``; ``progress(fraction)`` is called after
        each octave."""
        cfg = self.config
        tel = current_telemetry()
        timers: dict[str, float] = {}
        t_total = time.perf_counter()

        t0 = time.perf_counter()
        tel.set_stage("plan")
        plan = self.build_dm_plan(fil)
        timers["plan"] = time.perf_counter() - t0
        tel.gauge("ffa.n_dm_trials", int(plan.ndm))
        tel.event("ffa_plan", ndm=int(plan.ndm), p_start=float(cfg.p_start),
                  p_end=float(cfg.p_end), min_dc=float(cfg.min_dc))

        # the staircase prepares the trials on the host (mean removal and
        # downsampling, as the JAX package does), so they land in host RAM
        # a segment at a time
        t0 = time.perf_counter()
        tel.set_stage("dedispersion")
        with record_function("Dedisperse"):
            trials = dedisperse_host(
                fil_to_device(fil, self.device), plan.delay_samples(), plan.killmask,
                plan.out_nsamps, scale=output_scale(fil.nbits, int(plan.killmask.sum())),
            )
        timers["dedispersion"] = time.perf_counter() - t0
        tel.capture_device_memory("dedispersion")

        t0 = time.perf_counter()
        tel.set_stage("ffa_search")

        def on_progress(f: float) -> None:
            # feeds the heartbeat's rate and ETA as well as the caller's
            tel.set_progress(round(f * 100.0, 3), 100.0, unit="%")
            if progress is not None:
                progress(f)

        cands = ffa_search_block(
            trials, fil.tsamp, cfg.p_start, cfg.p_end, cfg.min_dc, plan.dm_list,
            snr_min=cfg.min_snr, progress=on_progress, device=self.device,
        )
        timers["ffa_search"] = time.perf_counter() - t0
        tel.capture_device_memory("ffa_search")

        out = cands[: cfg.limit]
        timers["total"] = time.perf_counter() - t_total
        tel.gauge("candidates.final", len(out))
        log.info("FFA search: %d DM trials -> %d period-collapsed candidates",
                 plan.ndm, len(out))
        return FFAResult(candidates=out, dm_list=plan.dm_list, timers=timers,
                         nsamps=fil.nsamps)
