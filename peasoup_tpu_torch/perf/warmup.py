"""Warmup: build every kernel and run every registered program before the
data needs it (the JAX package's perf/warmup.py).

A fresh process of the port pays ``nvcc`` once for each kernel source
whose library is missing from ``peasoup_tpu_torch/_build`` (kernels.py);
a library built once is reused by every later process. Where the JAX
package's warm pass makes "every compile a persistent-cache hit", here a
warm pass builds no kernel: :func:`warm_registry` builds and loads every
kernel (``kernels.build``, ``kernels.load``), runs each program of the
registry (ops/registry.py) once, and reports the kernels it built in this
process against those it found built.

:func:`warm_bucket` warms one campaign bucket: ``mode="registry"`` runs
:func:`warm_registry`; ``mode="dryrun"`` runs the pipeline once over a
synthetic observation that fills the bucket
(:func:`synthetic_bucket_observation`), which loads every kernel, the
native distil library and the plan tables the bucket's jobs use.
:func:`shape_ctx_for_bucket` derives the bucket's geometry with the
drivers' own plan machinery.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from dataclasses import dataclass, field

import torch

from ..device import resolve_device

log = logging.getLogger("peasoup_tpu_torch.warmup")


@dataclass
class ProgramWarmup:
    """One program's warm run."""

    name: str
    seconds: float  # wall time of its build and one run, synchronised
    error: str | None = None

    def to_doc(self) -> dict:
        return {"name": self.name, "seconds": round(self.seconds, 6), "error": self.error}


@dataclass
class WarmupReport:
    """One warm pass: the programs it ran, and the kernels it built in this
    process (``built``) against those whose library it found (``found``)."""

    device: str
    programs: list[ProgramWarmup] = field(default_factory=list)
    seconds: float = 0.0
    built: list[str] = field(default_factory=list)
    found: list[str] = field(default_factory=list)

    @property
    def errors(self) -> list[ProgramWarmup]:
        return [p for p in self.programs if p.error]

    def to_doc(self) -> dict:
        return {
            "device": self.device,
            "seconds": round(self.seconds, 3),
            "programs": len(self.programs),
            "kernels_built": self.built,
            "kernels_found": self.found,
            "errors": [p.to_doc() for p in self.errors],
            "per_program": [p.to_doc() for p in self.programs],
        }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_registry(specs=None, programs: list[str] | None = None,
                  device: str | torch.device = "cuda") -> WarmupReport:
    """Build and load every kernel (on a CUDA device; on the CPU the
    wrappers run their plain versions and nothing is built), then run each
    registered program once on ``device``. A program that fails is
    recorded with its error, and the pass goes on to the next."""
    from .. import kernels

    device = resolve_device(device)
    if specs is None:
        from ..ops.registry import registered_programs

        specs = registered_programs()
    if programs:
        wanted = set(programs)
        specs = [s for s in specs if s.name in wanted]
    report = WarmupReport(device=str(device))
    t_all = time.perf_counter()
    if device.type == "cuda":
        report.found = [k for k in kernels.KERNELS if kernels.library_path(k).exists()]
        kernels.load()
        report.built = [k for k in kernels.KERNELS if k not in report.found]
    for spec in specs:
        t0 = time.perf_counter()
        err = None
        try:
            fn, args, kwargs = spec.build(device)
            fn(*args, **kwargs)
            _sync(device)
        except Exception as exc:  # recorded per program; the pass goes on
            err = f"{type(exc).__name__}: {exc!s:.300}"
        report.programs.append(ProgramWarmup(spec.name, time.perf_counter() - t0, err))
    report.seconds = time.perf_counter() - t_all
    return report


# --------------------------------------------------------------------------
# campaign-bucket warmup
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCtx:
    """The geometry a campaign bucket implies for one pipeline (the JAX
    package's ops/registry.py:ShapeCtx, the fields the port's drivers
    read): 0 in a field means it does not apply to the pipeline."""

    nsamps: int  # padded observation length (the bucket rung)
    nchans: int
    nbits: int
    ndm: int
    out_nsamps: int  # dedispersed trial length
    dedisp_block: int  # DM trials a host-RAM dedispersion segment
    widths: tuple[int, ...] = ()  # the single-pulse boxcar bank
    tpad: int = 0  # the single-pulse padded trial length
    decimate: int = 0
    fft_size: int = 0  # periodicity search
    nharms: int = 0
    accel_pad: int = 0  # padded accel trials a DM trial
    pos5: int = 0  # whitening boundaries in spectrum bins
    pos25: int = 0
    subbands: int = 0
    subband_smear: float = 0.0
    subband_matmul: bool = False
    dedisp_engine: str = ""
    fold_nsamps: int = 0  # the survey fold's power-of-two series length


def _filtered_config(cls, overrides: dict, **fixed):
    """A config of ``cls`` from the overrides it knows (others dropped, as
    the JAX package's warmup drops them)."""
    names = {f.name for f in dataclasses.fields(cls)}
    merged = {k: v for k, v in overrides.items() if k in names}
    merged.update(fixed)
    return cls(**merged)


def shape_ctx_for_bucket(bucket, pipeline: str, overrides: dict) -> ShapeCtx:
    """The bucket's geometry for ``pipeline`` ("search" or "spsearch"),
    from the drivers' own plans: the DM plan, and the FFT size, accel
    padding and whitening boundaries of the periodicity search or the
    width bank and padded length of the single-pulse search. Tuned knobs
    (``subbands``, ``subband_smear``, ``dedisp_block``, ...) enter through
    ``overrides``."""
    import numpy as np

    from ..ops.singlepulse import default_widths, plan_pad
    from ..pipeline.folder import fold_geometry
    from ..plan.dm_plan import DMPlan

    nchans, nbits, nsamps, tsamp, fch1, foff = bucket
    if pipeline == "search":
        from ..pipeline.search import SearchConfig as cls
    elif pipeline == "spsearch":
        from ..pipeline.single_pulse import SinglePulseConfig as cls
    else:
        raise ValueError(f"no shape context for pipeline {pipeline!r}")
    cfg = _filtered_config(cls, overrides)
    plan = DMPlan.create(
        nsamps=int(nsamps), nchans=int(nchans), tsamp=float(tsamp), fch1=float(fch1),
        foff=float(foff), dm_start=cfg.dm_start, dm_end=cfg.dm_end,
        pulse_width=cfg.dm_pulse_width, tol=cfg.dm_tol,
    )
    extra: dict = {}
    if pipeline == "spsearch":
        cap = max(1, plan.out_nsamps // 4)
        if cfg.max_width:
            cap = min(cap, cfg.max_width)
        extra.update(widths=default_widths(cfg.n_widths, max_width=cap),
                     tpad=plan_pad(plan.out_nsamps)[0], decimate=cfg.decimate)
    else:
        from ..pipeline.search import _accel_pad
        from ..plan.accel_plan import AccelerationPlan
        from ..plan.fft_plan import choose_fft_size

        size = choose_fft_size(int(nsamps), cfg.size)
        tobs = float(np.float32(size) * np.float32(tsamp))
        bin_width = float(np.float32(1.0 / tobs))
        acc_plan = AccelerationPlan(
            acc_lo=cfg.acc_start, acc_hi=cfg.acc_end, tol=cfg.acc_tol,
            pulse_width=cfg.acc_pulse_width, nsamps=size, tsamp=float(tsamp),
            cfreq=float(fch1) + (int(nchans) / 2.0 - 0.5) * float(foff), bw=float(foff),
        )
        # the widest accel list is at the lowest DM
        accs = acc_plan.generate_accel_list(float(cfg.dm_start))
        extra.update(
            fft_size=size, nharms=cfg.nharmonics,
            accel_pad=_accel_pad(len(accs), cfg.accel_bucket),
            pos5=int(cfg.boundary_5_freq / bin_width),
            pos25=int(cfg.boundary_25_freq / bin_width),
            subbands=cfg.subbands, subband_smear=cfg.subband_smear,
            subband_matmul=cfg.subband_matmul, dedisp_engine=cfg.dedisp_engine,
        )
    fold_size = int(fold_geometry(plan.out_nsamps, float(tsamp))[0])
    return ShapeCtx(
        nsamps=int(nsamps), nchans=int(nchans), nbits=int(nbits), ndm=int(plan.ndm),
        out_nsamps=int(plan.out_nsamps),
        dedisp_block=int(overrides.get("dedisp_block", 16)),
        fold_nsamps=fold_size, **extra,
    )


def synthetic_bucket_observation(bucket, path: str, seed: int = 0):
    """Write a synthetic observation that fills a bucket exactly: noise at
    the bucket's shape and bit depth plus a bright broadband pulse train
    every ~50 ms (so the candidate paths run over real work), and read it
    back, so a sub-byte bucket carries the packed bytes as a real
    observation does."""
    import numpy as np

    from ..io.sigproc import Filterbank, SigprocHeader, read_filterbank, write_filterbank

    nchans, nbits, nsamps, tsamp, fch1, foff = bucket
    nchans, nbits, nsamps = int(nchans), int(nbits), int(nsamps)
    rng = np.random.default_rng(seed)
    hi = (1 << min(nbits, 8)) - 1
    data = rng.integers(0, max(1, hi // 4) + 1, size=(nsamps, nchans), dtype=np.uint8)
    period = max(64, int(round(0.05 / float(tsamp))))
    for s in range(period // 2, nsamps, period):
        data[s : min(s + 4, nsamps), :] = hi
    hdr = SigprocHeader(
        source_name="WARMUP", data_type=1, nchans=nchans, nbits=nbits, nifs=1,
        tsamp=float(tsamp), tstart=50000.0, fch1=float(fch1), foff=float(foff),
    )
    write_filterbank(path, Filterbank(header=hdr, data=data))
    return read_filterbank(path)


def warm_bucket(bucket, pipeline: str, overrides: dict, scratch_dir: str,
                mode: str = "dryrun", device: str | torch.device = "cuda") -> dict:
    """Warm one campaign bucket on ``device``. ``mode="registry"`` runs
    :func:`warm_registry`; ``mode="dryrun"`` runs the pipeline once over a
    synthetic observation of the bucket (one observation's work, and
    every kernel and table the bucket's jobs load). Returns the stats:
    kernels built in this process, seconds, and the error where the warmup
    failed (recorded, as the JAX package records it: the first real job
    then fails loudly on its own)."""
    import os
    import shutil

    from .. import kernels

    device = resolve_device(device)
    t0 = time.perf_counter()
    found = ([k for k in kernels.KERNELS if kernels.library_path(k).exists()]
             if device.type == "cuda" else [])
    stats: dict = {"bucket": list(bucket), "mode": mode, "seconds": 0.0,
                   "kernels_built": [], "error": None}
    try:
        if mode == "registry":
            rep = warm_registry(device=device)
            if rep.errors:
                stats["error"] = rep.errors[0].error
        elif mode == "dryrun":
            os.makedirs(scratch_dir, exist_ok=True)
            fil = synthetic_bucket_observation(bucket, os.path.join(scratch_dir, "warmup.fil"))
            _dryrun_pipeline(pipeline, overrides, scratch_dir, fil, device)
            shutil.rmtree(scratch_dir, ignore_errors=True)
        else:
            raise ValueError(f"unknown warmup mode {mode!r}")
    except Exception as exc:  # recorded in the stats, as the JAX package does
        stats["error"] = f"{type(exc).__name__}: {exc!s:.300}"
        log.warning("bucket warmup failed for %s: %s", bucket, exc)
    if device.type == "cuda":
        stats["kernels_built"] = [k for k in kernels.KERNELS
                                  if k not in found and kernels.library_path(k).exists()]
    stats["seconds"] = round(time.perf_counter() - t0, 3)
    return stats


def _dryrun_pipeline(pipeline: str, overrides: dict, outdir, fil, device) -> None:
    """One run of the pipeline over the synthetic observation, nothing kept."""
    if pipeline == "spsearch":
        from ..pipeline.single_pulse import SinglePulseConfig, SinglePulseSearch

        cfg = _filtered_config(SinglePulseConfig, overrides, outdir=str(outdir),
                               checkpoint_file="")
        SinglePulseSearch(cfg, device=device).run(fil)
    elif pipeline == "search":
        from ..pipeline.search import PeasoupSearch, SearchConfig

        cfg = _filtered_config(SearchConfig, overrides, outdir=str(outdir),
                               checkpoint_file="")
        PeasoupSearch(cfg, device=device).run(fil)
    else:
        raise ValueError(f"no dry run for pipeline {pipeline!r}")
