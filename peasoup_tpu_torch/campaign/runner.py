"""The campaign worker: a long-lived scheduler/executor loop (the port's
copy of the JAX package's campaign/runner.py, dispatching to the port's
``PeasoupSearch``, ``SinglePulseSearch``, ``FFASearch`` and
``FdasSearch`` on the worker's device: the card unless the caller asks
for the CPU).

One invocation of ``campaign run`` is one worker. Workers share nothing
but the campaign directory (queue.py); N workers on M hosts need no
coordinator, and a worker of either package may serve a campaign
directory the other wrote: the queue tree, the done records,
``campaign.json`` and the rollup keep the JAX package's formats and
schema names.

Observations rarely share exact shapes, so the runner buckets them:
``nsamps`` is padded up to a coarse geometric ladder (powers of two and
3·2^(k-1) — two rungs per octave, campaign/buckets.py) with per-channel
median samples, and the queue hands a worker jobs from its previous
bucket first (queue.claim_next prefer_bucket). The bucket key includes
everything shape-determining (nchans, nbits, padded nsamps, tsamp, fch1,
foff).

Where the JAX worker reuses compiled XLA programs, the port reuses its
kernels' libraries: each CUDA source is built once by ``nvcc`` into the
package's ``_build/`` and loaded by every later job and process
(kernels.py), and nothing is compiled per shape. The done record's
``jit_programs_compiled`` field, which both packages' rollups read, holds
the number of kernel libraries this process built during the job
(:func:`jit_programs_compiled`): 0 on a warm bucket, and a same-bucket
job that built one raises the structured ``jit_cache_miss`` event, as a
recompile does in the JAX package. The JAX worker's persistent
compilation cache has no counterpart: the library cache above needs no
switch. Warmup (``warmup_mode``): ``dryrun`` builds and loads the kernel
libraries and opens the card's context (perf/warmup.py:warm_bucket),
where the JAX package searches a synthetic observation to compile the
bucket's programs; ``aot`` builds and runs the program registry
(perf/warmup.py:warm_registry).

Each job runs with the full live-observability stack under its own job
dir (``<root>/jobs/<id>/``): status.json heartbeat, crash flight
recorder, telemetry.json manifest. A lease-renewal thread keeps the
claim fresh while the job computes (it never touches the device); if the
worker is SIGKILLed the lease expires and any other worker reaps and
re-queues the job (queue.py). A revoke (preemption, retirement) reaches
the drivers' wave-boundary seams (``search.wave``, ``spsearch.wave``),
which checkpoint and stop; the job is released with zero attempts
consumed and resumes from its job dir's checkpoint. A gang job
(``nprocs > 1``) runs on several workers through
parallel/multihost.py's drivers over a :class:`GangComm` file exchange,
and the leader writes outputs bitwise those of a single-process run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time

import numpy as np
import torch

from ..device import resolve_device
from ..obs import get_logger
from ..obs.flight import FlightRecorder
from ..obs.heartbeat import Heartbeat
from ..obs.metrics import MetricsRecorder
from ..obs.telemetry import RunTelemetry
from ..obs.trace import Tracer, new_trace_id
from .buckets import bucket_for_header, bucket_for_input, bucket_nsamps
from .db import DB_FILENAME, CandidateDB
from .queue import Claim, Job, JobQueue, job_id_for
from .registry import WorkerRegistry
from .rollup import write_status

log = get_logger("campaign.runner")

CAMPAIGN_CONFIG = "campaign.json"
CAMPAIGN_CONFIG_SCHEMA = "peasoup_tpu.campaign"

PIPELINES = ("search", "spsearch", "ffa", "fdas")


def _safe_name(s: str) -> str:
    """Filesystem-safe worker id (same sanitisation as the registry's
    entry filenames, so per-worker artifacts line up by stem)."""
    return "".join(
        c if c.isalnum() or c in "-_." else "_" for c in s
    )[:80]


# --------------------------------------------------------------------------
# campaign config
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CampaignConfig:
    """Campaign-wide settings, persisted as ``<root>/campaign.json`` so
    every worker (and every later ``status``/``retry`` invocation) runs
    with identical semantics. First writer wins; later writers attach."""

    pipeline: str = "spsearch"
    config: dict = dataclasses.field(default_factory=dict)
    lease_s: float = 60.0
    max_attempts: int = 3
    backoff_base_s: float = 2.0
    heartbeat_interval: float = 2.0
    bucket_nsamps: list | None = None  # explicit ladder override
    # warmup: build and load a new bucket's kernels on a background
    # thread (overlapping the first observation's filterbank read)
    # before the pipeline touches data — the first job of a warmed
    # bucket then reports jit_programs_compiled == 0 like its
    # successors. "dryrun" loads the kernel libraries and opens the
    # card's context; "aot" builds every kernel and runs the program
    # registry once (perf/warmup.py).
    warmup: bool = True
    warmup_mode: str = "dryrun"  # "dryrun" | "aot"
    # auto-tuned dedispersion plans (perf/tuning.py): each new bucket
    # resolves exact-vs-subband + per-device shape knobs on the warmup
    # thread (overlapping the first observation's read) and persists
    # the winner in the campaign-shared tuning cache, so every other
    # worker/job of the bucket loads the plan with zero re-measurement
    tune: bool = False
    tuning_cache: str = ""  # "" = <campaign root>/tuning_cache.json
    # priority preemption: a worker holding the lowest-priority
    # running claim revokes ITSELF when a pending job outranks it and
    # no idle worker is live (the decentralised trigger; operators and
    # schedulers can also `peasoup-campaign preempt` explicitly). The
    # victim checkpoints at the next DM-block boundary and releases
    # with zero attempts consumed; one unresponsive past the grace
    # deadline is escalated to the reap path.
    preempt: bool = True
    preempt_grace_s: float = 60.0
    # gang-scheduled jobs (Job.nprocs > 1): how long the leader waits
    # for the full group at the join barrier before releasing the
    # claim cleanly (no partial-gang deadlock), and how long any
    # member waits at a mid-run barrier before the gang fails
    # transient (a dead member must consume exactly one attempt)
    gang_assemble_s: float = 30.0
    gang_timeout_s: float = 600.0
    # fleet observability (obs/metrics.py, obs/trace.py): per-worker
    # time-series metrics under queue/workers/ and per-job trace span
    # files under jobs/<id>/ — both on by default (append-only JSON
    # lines, negligible next to device work); `peasoup-campaign
    # metrics` / `trace` consume them
    metrics: bool = True
    trace: bool = True

    def tuning_cache_path(self, root: str) -> str:
        return self.tuning_cache or os.path.join(root, "tuning_cache.json")

    def to_doc(self) -> dict:
        return {
            "schema": CAMPAIGN_CONFIG_SCHEMA,
            **dataclasses.asdict(self),
        }


def save_campaign_config(root: str, cfg: CampaignConfig) -> CampaignConfig:
    """Persist the campaign config; if one already exists it WINS (a
    second worker attaching with different flags must not fork the
    campaign's semantics mid-flight). The document is written whole to a
    file of this process's own and published with ``os.link``, which
    fails where the config exists: a worker started beside the first
    never reads a config half written (the JAX package's O_EXCL create
    publishes the empty file first)."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, CAMPAIGN_CONFIG)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(cfg.to_doc(), f, indent=2)
        f.write("\n")
    try:
        os.link(tmp, path)
    except FileExistsError:
        existing = load_campaign_config(root)
        if existing.to_doc() != cfg.to_doc():
            log.warning(
                "campaign %s already configured; using its existing "
                "campaign.json (pipeline=%s) over this invocation's flags",
                root, existing.pipeline,
            )
        return existing
    finally:
        os.unlink(tmp)
    return cfg


def load_campaign_config(root: str) -> CampaignConfig:
    path = os.path.join(root, CAMPAIGN_CONFIG)
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != CAMPAIGN_CONFIG_SCHEMA:
        raise ValueError(f"{path}: not a {CAMPAIGN_CONFIG_SCHEMA} file")
    doc.pop("schema", None)
    return CampaignConfig(**doc)


# --------------------------------------------------------------------------
# shape buckets
# --------------------------------------------------------------------------

# bucket_nsamps, bucket_for_header and bucket_for_input: campaign/buckets.py
# (the tuning cache keys its entries by the same bucket)


def pad_to_nsamps(fil, target: int):
    """Pad a filterbank's time axis up to ``target`` samples with each
    channel's median level (flat baseline: the normalisers see a few
    percent more pure-baseline samples, no fake transient edges).
    Returns (padded_fil, original_nsamps)."""
    orig = fil.nsamps
    if target <= orig:
        return fil, orig
    data = fil.data
    fill = np.median(data, axis=0)
    if np.issubdtype(data.dtype, np.integer):
        fill = np.rint(fill)
    pad = np.broadcast_to(
        fill.astype(data.dtype), (target - orig, data.shape[1])
    )
    from ..io.sigproc import Filterbank

    hdr = dataclasses.replace(fil.header, nsamples=target)
    return Filterbank(
        header=hdr, data=np.concatenate([data, pad], axis=0)
    ), orig


# --------------------------------------------------------------------------
# manifest -> jobs
# --------------------------------------------------------------------------

def parse_manifest(path: str) -> list[dict]:
    """One observation per line: either a bare filterbank path or a
    JSON object ``{"input": ..., "config": {...}}`` with per-job
    pipeline overrides. ``#`` comments and blank lines are skipped;
    relative paths resolve against the manifest's directory."""
    base = os.path.dirname(os.path.abspath(path))
    entries = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            if ln.startswith("{"):
                doc = json.loads(ln)
                if "input" not in doc:
                    raise ValueError(
                        f"{path}: manifest JSON line lacks 'input': {ln}"
                    )
            else:
                doc = {"input": ln}
            if not os.path.isabs(doc["input"]):
                doc["input"] = os.path.join(base, doc["input"])
            entries.append(doc)
    return entries


def enqueue_entries(
    queue: JobQueue,
    entries: list[dict],
    pipeline: str,
    ladder: list[int] | None = None,
    priority: int = 0,
    nprocs: int = 1,
    tenant: str = "",
) -> int:
    """Idempotently enqueue manifest entries; returns how many were
    new. ``priority`` is the default priority class; a per-entry
    ``"priority"`` in a manifest JSON line overrides it (higher claims
    sooner — queue.claim_next ranks priority above bucket affinity).
    ``nprocs`` (default / per-entry ``"nprocs"``) > 1 gang-schedules
    the job across a worker process group via the multi-host drivers —
    supported for the search and spsearch pipelines. ``tenant``
    (default / per-entry ``"tenant"``) stamps jobs for the
    multi-tenant quota + usage accounting (campaign/tenants.py) —
    quota-validated submissions should instead go through
    campaign/ingest.submit_observation, which journals the decision."""
    added = 0
    for e in entries:
        inp = e["input"]
        job = Job(
            job_id=job_id_for(inp),
            input=inp,
            pipeline=e.get("pipeline", pipeline),
            config=e.get("config") or {},
            bucket=bucket_for_input(inp, ladder),
            priority=int(e.get("priority", priority)),
            nprocs=int(e.get("nprocs", nprocs)),
            tenant=str(e.get("tenant", tenant) or ""),
        )
        if job.pipeline not in PIPELINES:
            raise ValueError(
                f"unknown pipeline {job.pipeline!r} for {inp} "
                f"(expected one of {PIPELINES})"
            )
        if job.nprocs > 1 and job.pipeline not in (
            "search", "spsearch", "fdas"
        ):
            raise ValueError(
                f"gang scheduling (nprocs={job.nprocs}) is supported "
                f"for the search/spsearch/fdas pipelines only, not "
                f"{job.pipeline!r} ({inp})"
            )
        added += bool(queue.add_job(job))
    return added


# --------------------------------------------------------------------------
# per-job execution
# --------------------------------------------------------------------------

def _build_config(cls, overrides: dict, **fixed):
    """Instantiate a pipeline config dataclass from campaign + job
    overrides, rejecting unknown keys loudly (a typo'd knob must fail
    the job visibly, not silently run with defaults)."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(overrides) - names
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} keys in campaign config: "
            f"{sorted(unknown)}"
        )
    merged = dict(overrides)
    merged.update(fixed)
    return cls(**merged)


def jit_programs_compiled(tel: RunTelemetry) -> int:
    """Kernel libraries this process built during the telemetry's run
    (kernels.py counts them as ``kernels.library_builds``), under the
    done-record field the JAX package fills with its XLA compiles. Zero
    on a job whose every kernel was already built (by an earlier job,
    the bucket's warmup thread or another process)."""
    return int(tel.counters.get("kernels.library_builds", 0))


def tuned_overrides(
    overrides: dict, plan_doc: dict, pipeline: str
) -> dict:
    """Merge a resolved dedispersion plan's shape knobs into the job's
    pipeline overrides. Operator-set knobs always win (an explicit
    ``subbands``/``dedisp_block`` in the campaign or job config is a
    decision, not a default), and in-driver re-resolution is disabled
    — the campaign already resolved the plan for this bucket."""
    out = dict(overrides)
    if pipeline == "search" and not overrides.get("subbands"):
        if plan_doc.get("engine") == "subband":
            out["subbands"] = int(plan_doc["subbands"])
            out["subband_smear"] = float(plan_doc.get("subband_smear", 1.0))
            if plan_doc.get("subband_matmul"):
                out["subband_matmul"] = True
        elif plan_doc.get("engine") == "matmul" and not overrides.get(
            "dedisp_engine"
        ):
            out["dedisp_engine"] = "matmul"
    if "dedisp_block" not in overrides and plan_doc.get("dedisp_block"):
        out["dedisp_block"] = int(plan_doc["dedisp_block"])
    if "dm_block" not in overrides and plan_doc.get("dm_block"):
        out["dm_block"] = int(plan_doc["dm_block"])
    if "accel_bucket" not in overrides and plan_doc.get("accel_bucket"):
        out["accel_bucket"] = int(plan_doc["accel_bucket"])
    out["tune"] = False
    return out


def run_observation(
    job: Job, overrides: dict, job_dir: str, tel: RunTelemetry,
    bucket_ladder: list[int] | None = None,
    warmer: "_BucketWarmer | None" = None,
    tuning_cache: str | None = None,
    comm=None,
    write_outputs: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Execute one observation end-to-end inside this process and write
    its outputs (overview.xml + pipeline-specific candidate files)
    under ``job_dir``. Returns the done-record info dict. ``warmer``
    is an in-flight bucket warmup joined after the filterbank read —
    I/O and warmup overlap — whose stats land in the telemetry and
    done record. ``comm`` (a parallel.multihost.GangComm) routes a
    gang-scheduled job through the multi-host drivers: this process
    computes its rank's DM slice and the gang's file-backed exchange
    merges, so the leader writes outputs identical to a single-process
    run. ``device`` is where the pipeline runs: the card unless the
    caller asks for the CPU."""
    from ..io.output import (
        CandidateFileWriter,
        OutputFileWriter,
        write_ffa_candidates,
        write_singlepulse,
    )
    from ..io.sigproc import read_filterbank

    t0 = time.perf_counter()
    tel.set_stage("reading")
    fil = read_filterbank(job.input)
    if fil.nsamps <= 0 or fil.nchans <= 0:
        raise ValueError(f"{job.input}: empty filterbank")
    reading = time.perf_counter() - t0

    target = (
        job.bucket[2]
        if job.bucket
        else bucket_nsamps(fil.nsamps, bucket_ladder)
    )
    fil, orig_nsamps = pad_to_nsamps(fil, target)
    if fil.nsamps != orig_nsamps:
        tel.event(
            "campaign_pad", orig_nsamps=orig_nsamps,
            padded_nsamps=int(fil.nsamps),
        )

    warmup_stats = None
    if warmer is not None:
        tel.set_stage("warmup")
        warmup_stats = warmer.result()
        tel.event("warmup", **warmup_stats)
        tel.add_timer("warmup", float(warmup_stats["seconds"]))
        tel.gauge("warmup.seconds", float(warmup_stats["seconds"]))
        tel.gauge(
            "warmup.programs_compiled",
            int(warmup_stats["programs_compiled"]),
        )

    plan_doc = None
    # the dedispersion planner knows the search/spsearch drivers only;
    # FFA/FDAS jobs keep their manual knobs
    if tuning_cache and job.bucket and job.pipeline not in ("ffa", "fdas"):
        # resolve AFTER the warmer join: the warmer tuned a cold bucket
        # on its thread and persisted the plan, so this is a pure cache
        # hit (zero measurements) for it and for every later job
        try:
            from ..perf.tuning import resolve_plan_for_bucket

            plan_doc = resolve_plan_for_bucket(
                tuple(job.bucket), job.pipeline, overrides, tuning_cache,
                device=device,
            ).summary()
        except Exception as exc:
            log.warning(
                "tuned-plan resolution failed for %s: %.200s",
                job.job_id, exc,
            )
        if plan_doc is not None:
            overrides = tuned_overrides(overrides, plan_doc, job.pipeline)
            tel.event("dedisp_plan", **plan_doc)
            tel.set_context(dedisp_plan=plan_doc)

    outdir = job_dir.rstrip("/")
    from .. import kernels

    launched0 = dict(kernels.launches)
    if job.pipeline == "spsearch":
        from ..pipeline.single_pulse import (
            SinglePulseConfig,
            SinglePulseSearch,
        )

        cfg = _build_config(
            SinglePulseConfig, overrides, outdir=outdir,
            checkpoint_file=os.path.join(outdir, "search.ckpt.npz"),
        )
        if comm is not None:
            from ..parallel.multihost import run_single_pulse_search

            result = run_single_pulse_search(fil, cfg, comm=comm, device=device)
        else:
            result = SinglePulseSearch(cfg, device=device).run(fil)
        # detections whose peak lies in the padding are artefacts of
        # the bucket, not the sky
        cands = [c for c in result.candidates if c.sample < orig_nsamps]
        result.timers["reading"] = reading
        tel.merge_timers(result.timers)
        if write_outputs:
            tel.set_stage("writing")
            write_singlepulse(
                os.path.join(outdir, "candidates.singlepulse"), cands
            )
            stats = OutputFileWriter()
            stats.add_misc_info()
            stats.add_header(fil.header)
            stats.add_dm_list(result.dm_list)
            stats.add_device_info(device)
            stats.add_single_pulse_section(
                cfg, job.input, result.widths, cands
            )
            stats.add_timing_info(result.timers)
            stats.to_file(os.path.join(outdir, "overview.xml"))
        n_cands = len(cands)
    elif job.pipeline == "ffa":
        from ..pipeline.ffa import FFAConfig, FFASearch

        cfg = _build_config(FFAConfig, overrides, outdir=outdir)
        result = FFASearch(cfg, device=device).run(fil)
        result.timers["reading"] = reading
        tel.merge_timers(result.timers)
        if write_outputs:
            tel.set_stage("writing")
            write_ffa_candidates(
                os.path.join(outdir, "candidates.ffa"), result.candidates
            )
            stats = OutputFileWriter()
            stats.add_misc_info()
            stats.add_header(fil.header)
            stats.add_dm_list(result.dm_list)
            stats.add_device_info(device)
            stats.add_ffa_section(cfg, job.input, result.candidates)
            stats.add_timing_info(result.timers)
            stats.to_file(os.path.join(outdir, "overview.xml"))
        n_cands = len(result.candidates)
    elif job.pipeline == "fdas":
        from ..io.output import write_fdas_candidates
        from ..pipeline.fdas import FdasConfig, FdasSearch

        cfg = _build_config(
            FdasConfig, overrides, outdir=outdir,
            checkpoint_file=os.path.join(outdir, "search.ckpt.npz"),
        )
        if comm is not None:
            from ..parallel.multihost import run_fdas_search

            result = run_fdas_search(fil, cfg, comm=comm, device=device)
        else:
            result = FdasSearch(cfg, device=device).run(fil)
        result.timers["reading"] = reading
        tel.merge_timers(result.timers)
        if write_outputs:
            tel.set_stage("writing")
            writer = CandidateFileWriter(outdir)
            writer.write_binary(result.candidates, "candidates.peasoup")
            write_fdas_candidates(
                os.path.join(outdir, "candidates.fdas"), result.candidates
            )
            stats = OutputFileWriter()
            stats.add_misc_info()
            stats.add_header(fil.header)
            stats.add_fdas_section(cfg, result.zs, result.ws)
            stats.add_dm_list(result.dm_list)
            stats.add_device_info(device)
            stats.add_candidates_fdas(
                result.candidates, writer.byte_mapping
            )
            stats.add_timing_info(result.timers)
            stats.to_file(os.path.join(outdir, "overview.xml"))
        n_cands = len(result.candidates)
    else:  # "search" (validated at enqueue)
        from ..pipeline.search import PeasoupSearch, SearchConfig

        cfg = _build_config(
            SearchConfig, overrides, outdir=outdir,
            checkpoint_file=os.path.join(outdir, "search.ckpt.npz"),
        )
        if comm is not None:
            from ..parallel.multihost import run_search

            result = run_search(fil, cfg, comm=comm, device=device)
        else:
            result = PeasoupSearch(cfg, device=device).run(fil)
        result.timers["reading"] = reading
        tel.merge_timers(result.timers)
        if write_outputs:
            tel.set_stage("writing")
            writer = CandidateFileWriter(outdir)
            writer.write_binary(result.candidates, "candidates.peasoup")
            stats = OutputFileWriter()
            stats.add_misc_info()
            stats.add_header(fil.header)
            stats.add_search_parameters(cfg, job.input)
            stats.add_dm_list(result.dm_list)
            stats.add_acc_list(result.acc_list_dm0)
            stats.add_device_info(device)
            stats.add_candidates(result.candidates, writer.byte_mapping)
            stats.add_timing_info(result.timers)
            stats.to_file(os.path.join(outdir, "overview.xml"))
        n_cands = len(result.candidates)

    tel.gauge("candidates.written", n_cands)
    # the kernels this job launched (the warmer thread has been joined, so
    # the process-wide counts are the pipeline's alone); on the CPU the
    # plain versions run and nothing is launched
    launched = {k: n - launched0.get(k, 0) for k, n in kernels.launches.items()
                if n > launched0.get(k, 0)}
    for k, n in sorted(launched.items()):
        tel.gauge(f"kernels.launches.{k}", n)
    # scientific data-quality gauges (obs/health.py) over the block
    # already in memory: advisory — a failure degrades to "no gauges",
    # never to a failed job
    quality: dict = {}
    try:
        from ..obs.health import observation_quality

        quality = observation_quality(
            fil.data[:orig_nsamps],
            n_candidates=n_cands,
            n_dm_trials=len(result.dm_list),
            nbits=fil.nbits,
        )
        for qk, qv in quality.items():
            tel.gauge(f"dq.{qk}", qv)
    except Exception:
        log.warning(
            "quality gauges failed for %s", job.job_id, exc_info=True
        )
    info = {
        "n_candidates": n_cands,
        "pipeline": job.pipeline,
        "bucket": list(job.bucket) if job.bucket else None,
        "duration_s": round(time.perf_counter() - t0, 3),
        "padded_from": orig_nsamps if fil.nsamps != orig_nsamps else None,
    }
    if job.tenant:
        # tenant provenance rides the done record into the usage
        # ledger (campaign/usage.py), quota windows and metric labels
        info["tenant"] = job.tenant
        try:
            info["bytes_read"] = os.path.getsize(job.input)
        except OSError:
            pass
    if quality:
        info["quality"] = quality
    if launched:
        info["kernel_launches"] = launched
    if job.sentinel:
        info["sentinel"] = True
    if warmup_stats is not None:
        info["warmup_s"] = float(warmup_stats["seconds"])
        info["warmup"] = warmup_stats
        if warmup_stats.get("tuning") is not None:
            # the warmer thread did the actual measuring for this
            # bucket; attribute the tuning wall to ITS job only (later
            # jobs are cache hits and must not re-count it)
            info["tuning_s"] = float(
                warmup_stats["tuning"].get("tuning_s", 0.0)
            )
    if plan_doc is not None:
        info["dedisp_plan"] = plan_doc
    return info


class _BucketWarmer(threading.Thread):
    """Background warmup (and, with ``tuning_cache``, dedispersion
    auto-tuning) for one shape bucket, started when a worker claims the
    first job of a bucket it has not warmed yet. It overlaps the job's
    filterbank read: the driver joins (``result``) after reading,
    before the pipeline dispatches. The tuned plan is persisted in the
    campaign's tuning cache before the job (and every other worker)
    resolves it — pure cache hits from then on. The thread works on the
    job's device, made current on it explicitly (a new thread starts on
    the process's default card), and in a context of its own, so the
    kernel libraries it builds never count against the job's
    ``jit_programs_compiled``: by the time the pipeline runs, every
    kernel it needs is built and loaded.

    The body runs under the resilience crash guard: an escaping
    exception emits a structured ``thread_crashed`` event on the job's
    telemetry (instead of dying invisibly, as it used to), flips the
    ``resilience`` status section to degraded, and the job proceeds
    unwarmed — warmup is an optimisation, never a dependency."""

    def __init__(
        self, bucket: tuple, pipeline: str, overrides: dict,
        mode: str, tuning_cache: str | None = None,
        telemetry=None, device: str | torch.device = "cuda",
    ) -> None:
        super().__init__(name="campaign-warmup", daemon=True)
        self._args = (bucket, pipeline, overrides, mode)
        self._device = torch.device(device)
        self._tuning_cache = tuning_cache
        self._telemetry = telemetry
        self._stats: dict | None = None
        self._error: Exception | None = None

    def run(self) -> None:
        from ..resilience import guard_thread

        self._error = guard_thread(
            "campaign-warmup", self._warm_on_device, telemetry=self._telemetry
        )

    def _warm_on_device(self) -> None:
        if self._device.type == "cuda":
            with torch.cuda.device(self._device):
                self._warm()
        else:
            self._warm()

    def _warm(self) -> None:
        from ..perf.warmup import warm_bucket

        bucket, pipeline, overrides, mode = self._args
        tuning = None
        if self._tuning_cache and pipeline not in ("ffa", "fdas"):
            try:
                from ..perf.tuning import resolve_plan_for_bucket

                tuning = resolve_plan_for_bucket(
                    bucket, pipeline, overrides, self._tuning_cache,
                    device=self._device,
                ).summary()
            except Exception as exc:
                log.warning(
                    "bucket tuning failed for %s: %.200s", bucket, exc
                )
        # the JAX package's "aot" mode compiles the program registry;
        # the port's counterpart builds every kernel and runs the registry
        stats = warm_bucket(
            bucket, "registry" if mode == "aot" else mode, device=self._device,
        )
        stats["mode"] = mode
        stats["programs_compiled"] = len(stats["kernels_built"])
        stats["tuning"] = tuning
        self._stats = stats

    def result(self, timeout: float | None = None) -> dict:
        self.join(timeout=timeout)
        if self._stats is None:  # thread died before warm_bucket ran
            bucket, _, _, mode = self._args
            return {
                "bucket": list(bucket), "mode": mode, "seconds": 0.0,
                "kernels_built": [], "programs_compiled": 0,
                "error": (
                    f"warmup thread crashed: {self._error!s:.200}"
                    if self._error is not None
                    else "warmup thread produced no result"
                ),
                "tuning": None,
            }
        return self._stats


class _LeaseRenewer(threading.Thread):
    """Daemon renewing the worker's claim (and its fleet-registry
    heartbeat) at a third of the lease, so only a dead (or
    wedged-past-lease) worker ever loses a job or drops out of the
    fleet view. The loop body already tolerates per-renewal failures;
    the crash guard covers everything else (a bug here silently
    forfeiting leases is exactly the invisible-thread-death failure
    mode).

    The beat is also the fleet's revoke channel: it observes a
    preempt-request file beside the claim (or a retire marker beside
    the registry entry) and flips the job's
    :class:`~peasoup_tpu_torch.resilience.revoke.RevokeToken`, which the
    driver answers at its next checkpoint boundary. With
    ``self_preempt`` it additionally runs the decentralised victim
    selection: when a pending job outranks this claim, no live idle
    worker exists, and this is THE lowest-priority running claim, it
    writes the preempt request on its own claim — priority preemption
    with no coordinator."""

    def __init__(
        self, queue: JobQueue, claim: Claim, telemetry=None,
        registry: "WorkerRegistry | None" = None,
        token=None,
        self_preempt: bool = False,
        grace_s: float = 60.0,
        on_beat=None,
    ) -> None:
        super().__init__(name="campaign-lease", daemon=True)
        self._queue = queue
        self._claim = claim
        self._telemetry = telemetry
        self._registry = registry
        self._token = token
        self._self_preempt = bool(self_preempt)
        self._grace_s = float(grace_s)
        # per-beat hook: how a BUSY worker observes fleet requests that
        # are not revokes (the on-demand profile.request watcher)
        self._on_beat = on_beat
        # NB: not "_stop" — Thread uses that name internally
        self._halt = threading.Event()

    def run(self) -> None:
        from ..resilience import guard_thread

        guard_thread(
            "campaign-lease", self._renew_loop, telemetry=self._telemetry
        )

    def _renew_loop(self) -> None:
        period = max(0.05, self._queue.lease_s / 3.0)
        while not self._halt.wait(period):
            try:
                ok = self._queue.renew(self._claim)
                if (
                    ok is False
                    and self._token is not None
                    and not self._token.is_set()
                ):
                    # the lease is GONE — reaped, or a racing claimant
                    # won the renewal window. This worker is a zombie
                    # on the job: revoke so the driver stops at its
                    # next checkpoint boundary. It must then touch
                    # NOTHING in the queue (the new owner's state is
                    # authoritative)
                    self._token.revoke(
                        kind="lost",
                        reason="claim lease lost (reaped or "
                        "re-claimed by a peer)",
                    )
                if self._registry is not None:
                    self._registry.beat(
                        self._claim.worker_id,
                        current_job=self._claim.job.job_id,
                    )
            except Exception:
                log.debug("lease renewal failed", exc_info=True)
            try:
                self._observe_revoke()
            except Exception:
                log.debug("revoke observation failed", exc_info=True)
            if self._on_beat is not None:
                try:
                    self._on_beat()
                except Exception:
                    log.debug("beat hook failed", exc_info=True)

    def _observe_revoke(self) -> None:
        token = self._token
        if token is None or token.is_set():
            return
        job_id = self._claim.job.job_id
        req = self._queue.preempt_request(job_id)
        if req is None and self._self_preempt and not self._claim.gang:
            wanted = self._queue.preemption_wanted(self._claim)
            if wanted is not None and not self._idle_worker_live():
                if self._queue.is_lowest_priority_running(self._claim):
                    self._queue.request_preempt(
                        job_id,
                        requester=(
                            f"priority:{wanted['job_id']}"
                            f"(p{wanted['priority']})"
                        ),
                        grace_s=self._grace_s,
                    )
                    req = self._queue.preempt_request(job_id)
        if req is not None:
            from ..resilience import TransientIOError, faults

            try:
                # the revoke-delivery seam: an injected fault makes
                # THIS beat miss the request (an unresponsive victim —
                # the grace deadline escalates to the reaper)
                faults.fire("preempt.revoke", context=job_id)
            except TransientIOError:
                return
            token.revoke(
                kind="preempt",
                reason=req.get("requester") or "preempt request",
                requested_unix=req.get("requested_unix"),
            )
            if self._telemetry is not None:
                self._telemetry.event(
                    "preempt_observed", job_id=job_id,
                    requester=req.get("requester"),
                    requested_unix=req.get("requested_unix"),
                )
            return
        if self._registry is not None:
            ret = self._registry.retire_requested(self._claim.worker_id)
            if ret is not None:
                token.revoke(
                    kind="retire",
                    reason=ret.get("requester") or "retire request",
                    requested_unix=ret.get("requested_unix"),
                )
                if self._telemetry is not None:
                    self._telemetry.event(
                        "retire_observed",
                        worker_id=self._claim.worker_id,
                        requester=ret.get("requester"),
                    )

    def _idle_worker_live(self) -> bool:
        if self._registry is None:
            return False
        return any(
            e.get("current_job") is None
            and e.get("worker_id") != self._claim.worker_id
            for e in self._registry.live()
        )

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=5.0)


# --------------------------------------------------------------------------
# the worker loop
# --------------------------------------------------------------------------

class CampaignRunner:
    """One worker process draining a campaign directory. ``group``
    names the process group this worker belongs to for gang-scheduled
    jobs (Job.nprocs > 1): the group's lexicographically-first live
    member leads gang claims; the rest join as ranked members. Every job
    runs on ``device``: the card unless the caller asks for the CPU (a
    request for the card where there is none raises here)."""

    def __init__(
        self,
        root: str,
        worker_id: str | None = None,
        group: str | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        # no card where one was asked for: raise before joining the fleet
        self.device = resolve_device(device)
        self.root = os.path.abspath(root)
        self.campaign = load_campaign_config(self.root)
        self.queue = JobQueue(
            self.root,
            lease_s=self.campaign.lease_s,
            max_attempts=self.campaign.max_attempts,
            backoff_base_s=self.campaign.backoff_base_s,
        )
        self.worker_id = worker_id or JobQueue.default_worker_id()
        self.group = group
        # fleet membership: workers join and leave at will; the
        # registry's heartbeat files are what rollup/watch render and
        # what the fleet soak audits for leaks (campaign/registry.py)
        self.registry = WorkerRegistry(
            self.root, lease_s=self.campaign.lease_s, group=group
        )
        self._jobs_done = 0
        self._last_bucket: tuple | None = None
        self._warmed_buckets: set[tuple] = set()
        self._retiring = False
        # gang epochs this worker already served as a member (the
        # invitation outlives the member's run until the leader
        # completes — never join the same epoch twice)
        self._gang_epochs_joined: set[str] = set()
        self._tuning_cache = (
            self.campaign.tuning_cache_path(self.root)
            if self.campaign.tune else None
        )
        # fleet observability: this worker's append-only time series
        # (queue depth, throughput, preemption latency...) next to its
        # registry entry, and the single-flight on-demand profiler
        self.metrics = MetricsRecorder(
            self.registry.metrics_path(self.worker_id),
            enabled=self.campaign.metrics,
        )
        self._profile_thread: threading.Thread | None = None
        self._profile_s = 0.0
        self._last_queue_sample = 0.0
        self._last_alert_eval = 0.0

    # --- one job ------------------------------------------------------
    def process_claim(
        self, claim: Claim, claim_wait_s: float | None = None
    ) -> str:
        """Run one claimed job under its own observability stack.
        Returns the job's resulting state (done|backoff|quarantined),
        "released" when a revoke (preempt/retire) handed the job back
        mid-run with zero attempts consumed, or "lost" when the claim
        lease was reaped from under a live run (the reaper charged
        the attempt; this worker mutates no further queue state). ``claim_wait_s`` is
        how long this worker idled before winning the claim (a
        scheduling span in the job's trace and a fleet latency
        histogram)."""
        from ..resilience import RevokeToken, activate_token

        job = claim.job
        job_dir = os.path.join(self.root, "jobs", job.job_id)
        os.makedirs(job_dir, exist_ok=True)
        manifest_path = os.path.join(job_dir, "telemetry.json")
        tel = RunTelemetry()
        tel.set_context(
            command="campaign-job",
            job_id=job.job_id,
            worker_id=self.worker_id,
            pipeline=job.pipeline,
            inputfile=job.input,
            outdir=job_dir,
            attempt=job.attempts + 1,
            bucket=list(job.bucket) if job.bucket else None,
            gang=claim.gang,
            trace_id=job.trace_id or None,
        )
        # the job's trace: this process's span file under the job dir,
        # keyed by the trace id minted at enqueue — a resumed or
        # gang-scheduled run appends to the SAME trace from another
        # process/worker, and the export stitches them into one
        tracer = Tracer(
            os.path.join(
                job_dir, f"trace-{_safe_name(self.worker_id)}.jsonl"
            ),
            job.trace_id or new_trace_id(),
            worker=self.worker_id,
            enabled=self.campaign.trace,
        )
        tracer.attach(tel)
        now_unix = time.time()
        if claim_wait_s is not None:
            tracer.span_at(
                "claim_wait", now_unix - claim_wait_s, claim_wait_s,
                job_id=job.job_id,
            )
            self.metrics.observe("claim_wait_seconds", claim_wait_s)
        from ..resilience import STATS as _RES_STATS

        res_base = _RES_STATS.snapshot()
        token = RevokeToken()
        renewer = _LeaseRenewer(
            self.queue, claim, telemetry=tel, registry=self.registry,
            token=token,
            self_preempt=self.campaign.preempt,
            grace_s=self.campaign.preempt_grace_s,
            on_beat=self._observe_profile,
        )
        renewer.start()
        comm = None
        if claim.gang:
            # gang leader: assemble the group at the join barrier (the
            # file-backed exchange's round 0), then route through the
            # multi-host driver. An unassembled gang is a clean release
            # — zero attempts, no partial-gang deadlock.
            comm = self._gang_comm(claim.gang, job_dir, rank=0)
            try:
                with tracer.span(
                    "gang_join", cat="sched", rank=0,
                    nprocs=claim.gang.get("nprocs"),
                ):
                    comm.allgather(
                        self.worker_id.encode(),
                        context=f"gang-join:{job.job_id}",
                        timeout_s=self.campaign.gang_assemble_s,
                    )
            except Exception as exc:
                renewer.stop()
                self._gang_cleanup(comm)
                tel.event(
                    "gang_unassembled", job_id=job.job_id,
                    gang=claim.gang, error=f"{exc!s:.200}",
                )
                tracer.close()
                self.queue.release(claim)
                log.warning(
                    "gang for %s did not assemble (%s); claim released "
                    "cleanly", job.job_id, exc,
                )
                return "released"
            tel.event(
                "gang_assembled", job_id=job.job_id, gang=claim.gang
            )
        warmer = None
        if (
            self.campaign.warmup
            and job.bucket
            and tuple(job.bucket) not in self._warmed_buckets
        ):
            # first job of a bucket this worker has not warmed: compile
            # its programs on a background thread while the filterbank
            # reads (run_observation joins before dispatching)
            warmer = _BucketWarmer(
                tuple(job.bucket), job.pipeline,
                {**self.campaign.config, **job.config},
                self.campaign.warmup_mode,
                tuning_cache=self._tuning_cache,
                telemetry=tel,
                device=self.device,
            )
            warmer.start()
            self._warmed_buckets.add(tuple(job.bucket))
        recorder = FlightRecorder(
            tel,
            os.path.join(job_dir, "flight.json"),
            manifest_path=manifest_path,
        ).install()
        heartbeat = Heartbeat(
            tel,
            os.path.join(job_dir, "status.json"),
            interval=self.campaign.heartbeat_interval,
        ).start()
        overrides = {**self.campaign.config, **job.config}
        from ..resilience import SearchPreempted

        try:
            with tel.activate(), activate_token(token), \
                    tracer.activate(), tracer.span(
                        "job_attempt",
                        job_id=job.job_id,
                        pipeline=job.pipeline,
                        attempt=job.attempts + 1,
                        priority=job.priority,
                    ):
                try:
                    # chaos seam: a scheduled worker.kill raises
                    # WorkerKilled (BaseException) here — it skips the
                    # except below exactly like a real SIGKILL skips
                    # the failure path, the claim is never released,
                    # and the lease reaper is the only recovery
                    from ..resilience import faults

                    faults.fire("worker.kill", context=job.job_id)
                    info = run_observation(
                        job, overrides, job_dir, tel,
                        bucket_ladder=self.campaign.bucket_nsamps,
                        warmer=warmer,
                        tuning_cache=self._tuning_cache,
                        comm=comm,
                        device=self.device,
                    )
                    compiled = jit_programs_compiled(tel)
                    info["jit_programs_compiled"] = compiled
                    tel.gauge("jit.programs_compiled", compiled)
                    if (
                        compiled
                        and job.bucket
                        and job.bucket == self._last_bucket
                    ):
                        # same bucket yet new programs: the reuse
                        # contract broke — surface it, don't fail
                        tel.event(
                            "jit_cache_miss", bucket=list(job.bucket),
                            programs_compiled=compiled,
                        )
                        log.warning(
                            "job %s recompiled %d programs despite "
                            "matching the previous bucket %s",
                            job.job_id, compiled, job.bucket,
                        )
                    tel.set_stage("ingest")
                    with CandidateDB(
                        os.path.join(self.root, DB_FILENAME)
                    ) as db:
                        info["ingested"] = db.ingest_job(
                            job.job_id, job_dir, job.input,
                            tenant=job.tenant,
                        )
                    # per-job resilience accounting: what THIS job
                    # survived (retries, degradations, injected
                    # faults), for the done record + campaign rollup
                    res_delta = _RES_STATS.delta_since(res_base)
                    # a previously RELEASED attempt's survived faults
                    # ride the job record (queue.record_carried_
                    # resilience) — fold them in so the done record
                    # accounts for the job's WHOLE history
                    for table, kv in (
                        claim.job.carried_resilience or {}
                    ).items():
                        if not isinstance(kv, dict):
                            continue
                        tgt = res_delta.setdefault(table, {})
                        for k, v in kv.items():
                            tgt[k] = tgt.get(k, 0) + int(v)
                    if res_delta:
                        info["resilience"] = res_delta
                    # a job that descended a degradation ladder (OOM
                    # fall-through, thread crash) completed DEGRADED:
                    # correct results, reduced machinery — surfaced in
                    # the done record so operators can audit the tail
                    info["degraded"] = bool(
                        res_delta.get("degradations")
                        or res_delta.get("thread_crashes")
                    )
                    # preemption provenance: a job that was revoked and
                    # resumed carries its tally + request->release
                    # latency into the done record (claim.job is the
                    # record as re-read at claim time)
                    if job.preemptions:
                        info["preemptions"] = int(job.preemptions)
                        info["preempt_latency_s"] = list(
                            job.preempt_latency_s
                        )
                    if claim.gang:
                        info["gang"] = dict(claim.gang)
                    tel.set_stage("done")
                    tel.write(manifest_path)
                except SearchPreempted as exc:
                    # the revoke's cooperative stop: the checkpoint on
                    # disk is consistent (check_revoke's contract), so
                    # the claim is RELEASED — zero attempts consumed —
                    # and the job resumes from the checkpoint later,
                    # bitwise-equal to an uninterrupted run
                    tel.event(
                        "preempted", job_id=job.job_id,
                        revoke_kind=exc.kind, reason=exc.reason,
                    )
                    tel.write(
                        manifest_path, aborted=True,
                        abort_reason=f"revoked ({exc.kind}): "
                        f"{exc.reason:.200}",
                    )
                    if comm is not None:
                        comm.abort(f"leader revoked ({exc.kind})")
                    if exc.kind == "lost":
                        # the lease was reaped (or re-claimed) from
                        # under a live run: the reaper already charged
                        # the attempt and a new owner may hold the
                        # claim — this zombie must not mutate ANY
                        # shared queue state (no release, no carried
                        # fold, no preempt accounting). The checkpoint
                        # on disk still serves the re-run
                        from ..resilience import STATS

                        STATS.preemption("lost")
                        self.metrics.counter(
                            "preemptions_total", event=exc.kind
                        )
                        log.warning(
                            "job %s lease lost mid-run; abandoning "
                            "attempt without queue mutations",
                            job.job_id,
                        )
                        # ...except the worker's OWN spool: the faults
                        # this attempt survived must still reach the
                        # campaign rollup, and the append-only sidecar
                        # races nobody (the job record is off-limits —
                        # we hold no lease)
                        lost_delta = _RES_STATS.delta_since(res_base)
                        if lost_delta:
                            self.queue.record_orphaned_resilience(
                                self.worker_id, job.job_id, lost_delta
                            )
                        return "lost"
                    # whatever this attempt survived must not vanish
                    # with the zero-attempt release: carry it on the
                    # job record into the resumed run's done record
                    rel_delta = _RES_STATS.delta_since(res_base)
                    if rel_delta:
                        self.queue.record_carried_resilience(
                            claim, rel_delta
                        )
                    if exc.kind == "retire":
                        self.queue.release(claim)
                        self._retiring = True
                        from ..resilience import STATS

                        STATS.preemption("retire")
                        log.info(
                            "worker %s retiring: job %s released "
                            "cleanly at a checkpoint boundary",
                            self.worker_id, job.job_id,
                        )
                    else:
                        latency = self.queue.release_preempted(
                            claim, observed_unix=token.observed_unix
                        )
                        tel.event(
                            "preempt_released", job_id=job.job_id,
                            latency_s=round(latency, 4),
                        )
                        # the revoke-latency span: request -> release,
                        # in the job's one connected trace
                        release_unix = time.time()
                        tracer.span_at(
                            "revoke", release_unix - latency, latency,
                            kind=exc.kind, job_id=job.job_id,
                        )
                        self.metrics.observe(
                            "preemption_latency_seconds", latency
                        )
                    self.metrics.counter(
                        "preemptions_total", event=exc.kind
                    )
                    return "released"
                except Exception as exc:
                    tel.event(
                        "campaign_job_failed",
                        error=f"{type(exc).__name__}: {exc!s:.500}",
                    )
                    tel.write(
                        manifest_path, aborted=True,
                        abort_reason=f"{type(exc).__name__}: {exc!s:.200}",
                    )
                    if comm is not None:
                        # any gang failure fails the gang as ONE unit:
                        # peers abort fast at their next barrier, and
                        # the job requeues as a single consumed attempt
                        comm.abort(
                            f"leader failed: {type(exc).__name__}"
                        )
                    state = self.queue.fail(
                        claim, f"{type(exc).__name__}: {exc}"
                    )
                    fail_labels = {"state": state}
                    if job.tenant:
                        fail_labels["tenant"] = job.tenant
                    self.metrics.counter(
                        "jobs_failed_total", **fail_labels
                    )
                    log.warning(
                        "job %s failed -> %s: %s", job.job_id, state, exc
                    )
                    return state
        finally:
            heartbeat.stop()
            recorder.close()
            renewer.stop()
            tracer.close()
            if comm is not None:
                self._gang_cleanup(comm)
        # second chaos seam: dying AFTER the work but BEFORE the done
        # record is the worst case for exactly-once — the reaped job
        # re-runs in full and must complete idempotently
        from ..resilience import faults as _faults

        _faults.fire("worker.kill", context=f"{job.job_id}:pre-complete")
        if not self.queue.complete(
            claim, worker_id=self.worker_id, **info
        ):
            # the lease was lost between the last renewal and this
            # publish: the reaper charged the attempt and the done
            # record is the next owner's to write — claiming "done"
            # here would double-count the job
            log.warning(
                "job %s finished but its lease was lost; done record "
                "not published (the job will re-run)", job.job_id,
            )
            # the attempt's survived faults still count: spool the
            # delta (NOT info["resilience"] — that folds in carried
            # marks, which stay on the job record for the re-run's
            # done record; spooling them too would double-count)
            lost_delta = _RES_STATS.delta_since(res_base)
            if lost_delta:
                self.queue.record_orphaned_resilience(
                    self.worker_id, job.job_id, lost_delta
                )
            return "lost"
        self._record_job_metrics(tel, info)
        if job.bucket:
            self._last_bucket = job.bucket
        log.info(
            "job %s done: %d candidates, %d programs compiled",
            job.job_id, info["n_candidates"], info["jit_programs_compiled"],
        )
        return "done"

    # --- gang-scheduled jobs ------------------------------------------
    def _gang_comm(self, gang: dict, job_dir: str, rank: int):
        """The file-backed exchange for one gang epoch. The leader
        (rank 0) sweeps stale epoch directories first — a SIGKILLed
        previous attempt must not leak its blobs."""
        import shutil

        from ..parallel.multihost import GangComm

        if rank == 0:
            for name in list(os.listdir(job_dir)) if os.path.isdir(
                job_dir
            ) else []:
                # stale epochs only: a racing member may already have
                # created (and written its join blob into) THIS epoch
                if name.startswith("gang-") and name != (
                    f"gang-{gang['epoch']}"
                ):
                    shutil.rmtree(
                        os.path.join(job_dir, name), ignore_errors=True
                    )
        return GangComm(
            os.path.join(job_dir, f"gang-{gang['epoch']}"),
            nprocs=int(gang["nprocs"]),
            rank=rank,
            timeout_s=self.campaign.gang_timeout_s,
            heartbeat=lambda: self.registry.beat(self.worker_id),
        )

    def _gang_cleanup(self, comm) -> None:
        import shutil

        shutil.rmtree(comm.gang_dir, ignore_errors=True)

    def _gang_member(self, claim_doc: dict) -> None:
        """The member side of a gang job: compute this rank's DM slice
        through the same multi-host driver the leader runs, feeding
        the file-backed exchange. Members hold no claim and consume no
        attempts — a dying leader (claim reaped, exchange aborted or
        timed out) just sends the member back to the queue loop; a
        dying member surfaces at the LEADER's next barrier and fails
        the gang transiently as one unit."""
        gang = claim_doc["gang"]
        job_id = claim_doc["job_id"]
        epoch = gang.get("epoch", "")
        self._gang_epochs_joined.add(epoch)
        job = self.queue.get_job(job_id)
        if job is None:
            return
        rank = gang["members"].index(self.worker_id)
        job_dir = os.path.join(self.root, "jobs", job_id)
        os.makedirs(job_dir, exist_ok=True)
        tel = RunTelemetry()
        tel.set_context(
            command="campaign-gang-member",
            job_id=job_id,
            worker_id=self.worker_id,
            pipeline=job.pipeline,
            inputfile=job.input,
            outdir=job_dir,
            gang=gang,
            process_index=rank,
            process_count=int(gang["nprocs"]),
            trace_id=claim_doc.get("trace_id") or job.trace_id or None,
        )
        # the member's spans join the job's ONE trace: the id rides the
        # gang claim document the invitation handed us
        tracer = Tracer(
            os.path.join(
                job_dir, f"trace-{_safe_name(self.worker_id)}.jsonl"
            ),
            claim_doc.get("trace_id") or job.trace_id or new_trace_id(),
            worker=self.worker_id,
            enabled=self.campaign.trace,
        )
        tracer.attach(tel)
        self.registry.beat(self.worker_id, current_job=job_id)
        comm = self._gang_comm(gang, job_dir, rank=rank)
        log.info(
            "joining gang for %s as rank %d/%d (epoch %s)",
            job_id, rank, gang["nprocs"], epoch,
        )
        try:
            with tel.activate(), tracer.activate(), tracer.span(
                "gang_member", job_id=job_id, rank=rank,
                nprocs=int(gang["nprocs"]),
            ):
                with tracer.span(
                    "gang_join", cat="sched", rank=rank,
                    nprocs=gang.get("nprocs"),
                ):
                    comm.allgather(
                        self.worker_id.encode(),
                        context=f"gang-join:{job_id}",
                        timeout_s=self.campaign.gang_assemble_s,
                    )
                tel.event("gang_assembled", job_id=job_id, gang=gang)
                run_observation(
                    job,
                    {**self.campaign.config, **job.config},
                    job_dir, tel,
                    bucket_ladder=self.campaign.bucket_nsamps,
                    tuning_cache=self._tuning_cache,
                    comm=comm,
                    write_outputs=False,  # the leader owns the outputs
                    device=self.device,
                )
                tel.write(
                    os.path.join(job_dir, f"telemetry.proc{rank}.json")
                )
        except Exception as exc:
            comm.abort(f"member rank {rank} failed: {type(exc).__name__}")
            log.warning(
                "gang member rank %d of %s stopped: %.300s",
                rank, job_id, exc,
            )
            tel.event(
                "gang_member_failed", job_id=job_id, rank=rank,
                error=f"{exc!s:.200}",
            )
        finally:
            tracer.close()
            self.registry.beat(self.worker_id, current_job=None)

    # --- warmup-aware claiming ----------------------------------------
    def _warm_bucket_hint(self) -> set[tuple]:
        """Buckets whose warmup/tuning has already been paid for: this
        worker's own warmed set unioned with every bucket a done
        record carries warmup tallies for (the same data the rollup's
        warm-bucket summary aggregates) — so a worker joining a
        running campaign prefers already-warm buckets over opening a
        cold one, maximising bucket streaks."""
        warm = set(self._warmed_buckets)
        try:
            for doc in self.queue.done_records():
                b = doc.get("bucket")
                if b and (
                    doc.get("warmup_s") is not None
                    or doc.get("dedisp_plan") is not None
                ):
                    warm.add(tuple(b))
        except Exception:  # a torn done record must not stall claiming
            log.debug("warm-bucket hint scan failed", exc_info=True)
        return warm

    # --- fleet observability ------------------------------------------
    def _record_job_metrics(self, tel: RunTelemetry, info: dict) -> None:
        """One completed job's contribution to this worker's time
        series: completion/duration, per-stage seconds + throughput,
        device-memory high water, warmup/tuning wall, compiles."""
        m = self.metrics
        if not m.enabled:
            return
        try:
            # tenant label on the per-job series: Prometheus exposition
            # and series(labels=...) queries slice usage by tenant
            tlab = (
                {"tenant": info["tenant"]} if info.get("tenant") else {}
            )
            m.counter(
                "jobs_done_total", pipeline=info.get("pipeline", ""),
                **tlab,
            )
            dur = float(info.get("duration_s") or 0.0)
            if dur:
                m.observe("job_duration_seconds", dur, **tlab)
            if tlab and dur:
                m.counter("tenant_device_seconds_total", dur, **tlab)
            for stage, secs in sorted(tel.timers.items()):
                m.counter("stage_seconds_total", float(secs), stage=stage)
            trials = float(tel.counters.get("search.dm_trials_done", 0))
            searching = float(tel.timers.get("searching", 0.0))
            if trials and searching > 0:
                m.gauge(
                    "stage_throughput_per_s", trials / searching,
                    stage="searching", unit="dm_trials",
                )
            peak = tel.gauges.get("memory.peak_bytes")
            if peak:
                m.gauge("device_memory_peak_bytes", float(peak))
            if info.get("warmup_s") is not None:
                m.counter("warmup_seconds_total", float(info["warmup_s"]))
            if info.get("tuning_s") is not None:
                m.counter("tuning_seconds_total", float(info["tuning_s"]))
            m.counter(
                "jit_programs_compiled_total",
                int(info.get("jit_programs_compiled", 0)),
                **tlab,
            )
            if info.get("gang"):
                m.counter("gang_jobs_total")
            if info.get("degraded"):
                m.counter("degraded_jobs_total")
            # scientific data-quality gauges (obs/health.py): the last
            # job's values as worker-level series for the sparklines;
            # campaign baselines read the done records, not these
            for qk, qv in sorted((info.get("quality") or {}).items()):
                m.gauge(f"dq_{qk}", float(qv))
        except Exception:  # metrics must never fail a completed job
            log.debug("job metrics recording failed", exc_info=True)

    def _sample_queue_metrics(self, min_interval_s: float = 1.0) -> None:
        """Throttled queue-depth gauges (one sample per derived state)
        — the "what was queue depth over the last hour" series."""
        if not self.metrics.enabled:
            return
        now_mono = time.monotonic()
        if now_mono - self._last_queue_sample < min_interval_s:
            return
        self._last_queue_sample = now_mono
        try:
            counts = self.queue.counts()
            for state in (
                "pending", "running", "backoff", "stale", "done",
                "quarantined", "throttled",
            ):
                self.metrics.gauge(
                    "queue_depth", counts.get(state, 0), state=state
                )
            self.metrics.gauge("queue_jobs_total", counts.get("total", 0))
            # liveness series for the heartbeat-absence alert rule
            now_unix = time.time()
            self.metrics.gauge("worker_heartbeat_unix", now_unix)
        except Exception:
            log.debug("queue metrics sampling failed", exc_info=True)

    def _evaluate_alerts(self, min_interval_s: float = 5.0) -> None:
        """Throttled survey-health round (obs/alerts.py) beside the
        status rollup. Any worker may run it; concurrent evaluators
        serialise on the engine's lock file. Never fails the worker."""
        now_mono = time.monotonic()
        if now_mono - self._last_alert_eval < min_interval_s:
            return
        self._last_alert_eval = now_mono
        try:
            from ..obs.alerts import default_rules, evaluate_campaign

            evaluate_campaign(
                self.root,
                rules=default_rules(
                    heartbeat_s=max(
                        float(self.campaign.heartbeat_interval), 0.1
                    )
                ),
                queue=self.queue,
                registry=self.registry,
            )
        except Exception:
            log.debug("alert evaluation failed", exc_info=True)

    def _observe_profile(self) -> None:
        """The worker side of on-demand profiling: observe a
        ``profile.request`` beside our registry entry (written by
        ``peasoup-campaign profile``), clear it (single-flight), and
        run the bounded capture on a helper thread so neither the
        renewer beat nor the claim loop blocks on it."""
        if self._profile_thread is not None and (
            self._profile_thread.is_alive()
        ):
            return
        req = self.registry.profile_requested(self.worker_id)
        if req is None:
            return
        self.registry.clear_profile(self.worker_id)
        seconds = float(req.get("seconds") or 5.0)
        self._profile_s = seconds
        now_unix = time.time()
        outdir = os.path.join(
            self.root, "profiles",
            f"{_safe_name(self.worker_id)}-{int(now_unix)}",
        )
        from ..obs.profiler import start_profile_capture

        # the capture announces itself in this worker's metrics stream
        self._profile_thread = start_profile_capture(
            outdir, seconds, metrics=self.metrics
        )
        log.info(
            "device profile capture started for %s (%.3gs, requested "
            "by %s)", self.worker_id, seconds, req.get("requester") or "?",
        )

    # --- the loop -----------------------------------------------------
    def run(
        self,
        max_jobs: int | None = None,
        drain: bool = True,
        poll_s: float = 1.0,
    ) -> dict:
        """Claim and process jobs until the campaign drains (every job
        terminal), ``max_jobs`` are processed, a retire request lands
        (autoscale scale-down: the worker finishes — or checkpoints
        and releases — its current job, deregisters and exits), or —
        with ``drain=False`` — the queue has nothing immediately
        claimable. Registers in the fleet registry for the duration
        (heartbeat renewed alongside the claim lease; clean
        deregistration on any exit path — only a SIGKILL leaves an
        entry, which peers reap). Returns this worker's tally."""
        from ..resilience import WorkerKilled

        tally = {
            "done": 0, "failed": 0, "quarantined": 0, "released": 0,
            "lost": 0,
        }
        processed = 0
        self.registry.register(self.worker_id, group=self.group)
        wait_t0 = time.perf_counter()  # claim-wait latency base
        try:
            while True:
                if max_jobs is not None and processed >= max_jobs:
                    break
                if self._retiring or self.registry.retire_requested(
                    self.worker_id
                ):
                    log.info(
                        "worker %s retiring (requested): leaving the "
                        "fleet cleanly", self.worker_id,
                    )
                    break
                self.registry.beat(
                    self.worker_id, jobs_done=self._jobs_done,
                    current_job=None,
                )
                # fleet observability: queue-depth time series and the
                # idle-side profile.request watcher (the busy side is
                # the lease renewer's beat hook)
                self._sample_queue_metrics()
                self._observe_profile()
                if self.group:
                    # a gang claim naming this worker outranks new
                    # work: the leader is holding the claim for the
                    # whole group
                    inv = self.queue.gang_invitation(self.worker_id)
                    if inv is not None and (
                        inv["gang"].get("epoch")
                        not in self._gang_epochs_joined
                    ):
                        self._gang_member(inv)
                        continue
                claim = self.queue.claim_next(
                    self.worker_id, prefer_bucket=self._last_bucket,
                    warm_buckets=self._warm_bucket_hint(),
                    group=self.group,
                    group_members=(
                        self.registry.live_group(self.group)
                        if self.group else None
                    ),
                )
                if claim is None:
                    self.registry.reap()
                    write_status(self.root, self.queue)
                    self._evaluate_alerts()
                    if self.queue.drained() or not drain:
                        break
                    counts = self.queue.counts()
                    if counts["total"] == 0:
                        break
                    # others are running, or retries back off: wait
                    time.sleep(poll_s)
                    continue
                state = self.process_claim(
                    claim,
                    claim_wait_s=round(
                        time.perf_counter() - wait_t0, 6
                    ),
                )
                wait_t0 = time.perf_counter()
                if state == "released":
                    # a revoke (preempt/retire) or an unassembled gang
                    # handed the job back: nothing was consumed and
                    # nothing was processed
                    tally["released"] += 1
                    continue
                if state == "lost":
                    # the lease was reaped from under a live run: the
                    # reaper charged the attempt and a peer owns the
                    # job now — this worker has nothing to account for
                    tally["lost"] += 1
                    continue
                processed += 1
                if state == "done":
                    tally["done"] += 1
                    self._jobs_done += 1
                elif state == "quarantined":
                    tally["quarantined"] += 1
                else:
                    tally["failed"] += 1
                self.registry.beat(
                    self.worker_id, jobs_done=self._jobs_done,
                    current_job=None,
                    last_bucket=(
                        list(self._last_bucket)
                        if self._last_bucket else None
                    ),
                )
                write_status(self.root, self.queue)
                self._evaluate_alerts()
            # a request that landed since the last poll is answered, and
            # a capture still running announces its outcome in this
            # worker's metrics stream, before the worker leaves (the
            # leave would clear the request unanswered, and the capture's
            # thread is a daemon, which the interpreter's exit would drop)
            self._observe_profile()
            if self._profile_thread is not None:
                self._profile_thread.join(timeout=self._profile_s + 30.0)
            # dead peers' membership entries expire within one lease;
            # reap them on the way out so a drained campaign leaves a
            # clean registry (the fleet soak's zero-leak invariant)
            self.registry.reap()
            write_status(self.root, self.queue)
            self._evaluate_alerts(min_interval_s=0.0)
        except WorkerKilled:
            # the simulated SIGKILL: a real kill runs no cleanup, so
            # the membership entry must stay behind for peers to reap
            raise
        except BaseException:
            self.registry.deregister(self.worker_id)
            raise
        self.registry.deregister(self.worker_id)
        return tally


def run_worker(
    root: str,
    worker_id: str | None = None,
    max_jobs: int | None = None,
    drain: bool = True,
    poll_s: float = 1.0,
    group: str | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """THE worker entry point: one call makes this process a campaign
    worker (fleet registration, warmup-aware claiming, per-job
    observability, rollup writes) until it leaves. The CLI
    (``peasoup-campaign run``) and the autoscale controller's spawns
    enter through here. ``group`` opts the worker into a
    gang-scheduling process group; ``device`` is where its jobs run."""
    return CampaignRunner(
        root, worker_id=worker_id, group=group, device=device
    ).run(max_jobs=max_jobs, drain=drain, poll_s=poll_s)
