"""``peasoup-chaos`` — the chaos soak: real workloads under seeded
fault schedules, judged by end-to-end invariants (the port's copy of the
JAX package's tools/chaos.py, its workloads on the port's campaign
runner, single-pulse search and stream on ``--device``).

The unit tests prove each recovery path in isolation; this tool proves
they *compose*. It runs a synthetic multi-observation campaign (and a
replay stream) twice — once fault-free for ground truth, once under a
deterministic fault schedule (resilience/faults.py) — and asserts the
invariants that define "survived":

* **exactly-once** — every enqueued job ends done XOR quarantined;
  nothing is lost, nothing double-completes.
* **bitwise-equal results** — for transient-only schedules (flaky
  reads, sqlite contention, worker kills — faults that must not change
  *what* is computed), every job's candidate file is byte-identical to
  the fault-free run, and every replayed stream trigger matches.
* **clean tree** — no leaked claim files, reap tombstones or ``*.tmp``
  atomic-write residue anywhere under the campaign root.
* **valid telemetry** — every done job's manifest validates against
  the checked-in schema; the campaign rollup loads and carries the
  resilience section.
* **bounded + attributed recovery** — retry counts stay within
  policy x injections, and every fault site that fired has a nonzero
  tally on the recovery path that answers it (retries for flaky
  reads/ingest, lease reaping for worker kills, quarantined artifacts
  for corrupted caches).

The jobs search on ``--device`` (the card unless ``--device cpu``; with
no card ``cuda`` raises, exit 2). The report records each job's kernel
launches and kernel libraries built (``jit_programs_compiled``, from its
done record) and the stream's kernel launches. Runs in seconds on the CPU
(tiny observations)::

    python -m peasoup_tpu_torch.tools.chaos --mode both -o /tmp/chaos \\
        --faults 'fil.read:p=0.25:n=4,db.ingest:at=1,worker.kill:at=obs0' \\
        --seed 7 --device cpu

``--mode fleet`` spawns real ``python -m peasoup_tpu_torch.cli.campaign
run --device <dev>`` worker processes (on the card they share it).

Exit codes: 0 survived (all invariants hold), 1 invariant violated,
2 internal error. A ``chaos_report.json`` with the schedule, the
injection log and the per-invariant outcomes lands in the workdir.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..obs import get_logger

log = get_logger("tools.chaos")

REPORT_SCHEMA = "peasoup_tpu.chaos_report"
# v3: preempt/gang/autoscale in the fleet schedule
# v4: fleet "observability" section — schema-valid metrics series,
#     exposition round-trip, per-job trace connectivity/unclosed spans
# v5: on-demand profile drill over the request protocol, gang barrier
#     flow-id linkage, and the survey-health alerts snapshot
REPORT_VERSION = 5

DEFAULT_CAMPAIGN_FAULTS = (
    "fil.read:p=0.25:n=4,db.ingest:at=1,worker.kill:at=obs0"
)
# at=replay pins the injections to the reader thread's replay loop
# (the cross-thread attribution drill), not the initial batch read
DEFAULT_STREAM_FAULTS = "fil.read:at=replay:n=2"

# sites whose injections must never change results — the schedules this
# tool accepts for the bitwise-equality invariant
TRANSIENT_SITES = frozenset(
    {"fil.read", "queue.claim", "db.ingest", "checkpoint.write",
     "worker.kill", "device.oom", "cache.corrupt", "clock.skew",
     "multihost.barrier", "multihost.merge", "preempt.revoke"}
)

# fault site -> stats tables where its recovery must leave a mark
RECOVERY_TABLES = {
    "fil.read": ("retries", "recoveries", "giveups"),
    "queue.claim": ("retries", "recoveries", "giveups"),
    "db.ingest": ("retries", "recoveries", "giveups"),
    "checkpoint.write": ("retries", "recoveries", "giveups"),
    "device.oom": ("degradations",),
    "cache.corrupt": ("corrupt_artifacts",),
    "multihost.barrier": ("retries", "recoveries", "giveups"),
    "multihost.merge": ("retries", "recoveries", "giveups"),
    # worker.kill recovery is the queue reaper: checked against job
    # attempt counts, not a stats table
    "worker.kill": (),
    "clock.skew": (),
    # preempt.revoke suppresses revoke delivery; its recovery is the
    # grace-deadline reap, checked against attempt counts
    "preempt.revoke": (),
}


# --------------------------------------------------------------------------
# synthetic observations (the JAX package's smoke-gate recipe, parameterised)
# --------------------------------------------------------------------------

def make_observations(
    data_dir: str,
    n_obs: int = 3,
    nsamps: int = 1 << 12,
    nchans: int = 8,
) -> list[str]:
    """Write ``n_obs`` small synthetic filterbanks, each with one
    strong dispersed pulse (distinct noise per observation, same
    shape bucket so the campaign exercises warm reuse)."""
    from ..io.sigproc import (
        Filterbank,
        SigprocHeader,
        write_filterbank,
    )
    from ..plan.dm_plan import DMPlan

    os.makedirs(data_dir, exist_ok=True)
    tsamp, fch1, foff = 0.000256, 1400.0, -16.0
    plan = DMPlan.create(
        nsamps=nsamps, nchans=nchans, tsamp=tsamp, fch1=fch1, foff=foff,
        dm_start=0.0, dm_end=20.0, pulse_width=64.0, tol=1.10,
    )
    delays = plan.delay_samples()[plan.ndm // 2]
    paths = []
    for i in range(n_obs):
        rng = np.random.default_rng(100 + i)
        data = rng.normal(32.0, 4.0, size=(nsamps, nchans))
        s0 = 1200 + 400 * i
        for c in range(nchans):
            data[s0 + delays[c] : s0 + 4 + delays[c], c] += 15.0
        hdr = SigprocHeader(
            source_name=f"CHAOS{i}", tsamp=tsamp, tstart=55000.0 + i,
            fch1=fch1, foff=foff, nchans=nchans, nbits=8, nifs=1,
            data_type=1,
        )
        path = os.path.join(data_dir, f"obs{i}.fil")
        write_filterbank(
            path,
            Filterbank(
                header=hdr,
                data=np.clip(np.rint(data), 0, 255).astype(np.uint8),
            ),
        )
        paths.append(path)
    return paths


# --------------------------------------------------------------------------
# campaign soak
# --------------------------------------------------------------------------

def _setup_campaign(
    root: str,
    inputs: list[str],
    config: dict,
    lease_s: float,
    max_attempts: int,
    gang_inputs: dict | None = None,
):
    """Create the campaign directory + config and enqueue the
    observations; returns the JobQueue (shared by the in-process and
    fleet soaks, so both judge identical campaigns). ``gang_inputs``
    maps input paths to an ``nprocs`` gang width (fleet soak only —
    the fault-free reference runs everything single-process, which is
    exactly what makes gang candidates' bitwise equality a proof)."""
    from ..campaign.queue import Job, JobQueue, job_id_for
    from ..campaign.runner import (
        CampaignConfig,
        bucket_for_input,
        save_campaign_config,
    )

    os.makedirs(root, exist_ok=True)
    cfg = CampaignConfig(
        pipeline="spsearch",
        config=config,
        lease_s=lease_s,
        max_attempts=max_attempts,
        backoff_base_s=0.05,
        heartbeat_interval=0.2,
        warmup=False,  # soak speed: the kernel libraries load once
        tune=False,
        preempt_grace_s=max(10.0, 10 * lease_s),
        gang_assemble_s=max(10.0, 10 * lease_s),
        gang_timeout_s=300.0,
    )
    save_campaign_config(root, cfg)
    queue = JobQueue(
        root, lease_s=lease_s, max_attempts=max_attempts,
        backoff_base_s=0.05,
    )
    gang_inputs = gang_inputs or {}
    for p in inputs:
        queue.add_job(
            Job(
                job_id=job_id_for(p), input=p, pipeline="spsearch",
                bucket=bucket_for_input(p),
                nprocs=int(gang_inputs.get(p, 1)),
            )
        )
    return queue


def _run_campaign(
    root: str,
    inputs: list[str],
    config: dict,
    lease_s: float,
    max_attempts: int,
    device: str = "cuda",
) -> dict:
    """Drain one campaign in-process, surviving injected worker kills
    the way a fleet does: each kill abandons the claim (never released
    — WorkerKilled models SIGKILL), waits out the lease, and a
    replacement worker joins and reaps. The workers enter through
    runner.run_worker — THE production worker entry — so the
    in-process soak and the fleet soak's real subprocesses exercise
    identical code. ``device`` is where the jobs run."""
    from ..campaign.rollup import write_status
    from ..campaign.runner import run_worker
    from ..resilience import WorkerKilled

    queue = _setup_campaign(root, inputs, config, lease_s, max_attempts)
    kills = 0
    tally = {"done": 0, "failed": 0, "quarantined": 0}
    worker = 0
    t0 = time.perf_counter()
    while True:
        try:
            t = run_worker(
                root, worker_id=f"chaos-w{worker}", poll_s=0.05,
                device=device,
            )
            for k in tally:
                tally[k] += t.get(k, 0)
            break  # drained
        except WorkerKilled as exc:
            kills += 1
            worker += 1
            log.warning(
                "worker chaos-w%d killed (%s); lease will expire and a "
                "replacement joins", worker - 1, exc,
            )
            # a SIGKILLed worker's claim outlives it by the lease
            time.sleep(lease_s + 0.25)
    write_status(root, queue)
    return {
        "tally": tally,
        "workers_killed": kills,
        "workers_used": worker + 1,
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def _job_candidate_bytes(root: str, job_id: str) -> bytes | None:
    path = os.path.join(root, "jobs", job_id, "candidates.singlepulse")
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _job_summaries(queue) -> dict:
    """{job id: attempts, preemptions, kernel launches and kernel
    libraries built} from a campaign's done records (the launches are the
    completing attempt's: none where it resumed with every DM trial
    restored from the checkpoint)."""
    return {
        d["job_id"]: {
            "attempts": int(d.get("attempts", 1)),
            "preemptions": int(d.get("preemptions") or 0),
            "kernel_launches": d.get("kernel_launches") or {},
            "jit_programs_compiled": int(d.get("jit_programs_compiled") or 0),
        }
        for d in sorted(queue.done_records(), key=lambda d: d["job_id"])
    }


def _tree_residue(root: str) -> list[str]:
    """Leaked atomic-write temps / reap tombstones / claim files /
    preempt requests / retire markers / gang exchange directories /
    fleet-registry entries (a drained campaign must leave an empty
    registry: clean leavers deregister, dead workers get reaped, and
    every revoke/gang artifact is consumed by its protocol)."""
    bad = []
    for pat in ("**/*.tmp", "**/*.reap.*", "**/*.ckpt.tmp"):
        bad.extend(glob.glob(os.path.join(root, pat), recursive=True))
    bad.extend(glob.glob(os.path.join(root, "queue", "claims", "*.json")))
    bad.extend(glob.glob(os.path.join(root, "queue", "claims", "*.preempt")))
    bad.extend(glob.glob(os.path.join(root, "queue", "workers", "*.json")))
    bad.extend(glob.glob(os.path.join(root, "queue", "workers", "*.retire")))
    bad.extend(glob.glob(os.path.join(root, "jobs", "*", "gang-*")))
    return sorted(bad)


def _exactly_once_violations(
    root: str, counts: dict, job_ids: list[str], n_obs: int
) -> list[str]:
    """The exactly-once invariant, shared by the in-process and fleet
    soaks: every job terminal, none lost, none in two states."""
    violations = []
    if counts["total"] != n_obs:
        violations.append(
            f"jobs lost or duplicated: {counts['total']}/{n_obs} records"
        )
    if counts["done"] + counts["quarantined"] != counts["total"]:
        violations.append(f"campaign not drained exactly-once: {counts}")
    for j in job_ids:
        d = os.path.exists(
            os.path.join(root, "queue", "done", f"{j}.json")
        )
        q = os.path.exists(
            os.path.join(root, "queue", "quarantine", f"{j}.json")
        )
        if d == q:  # both (double-terminal) or neither (lost)
            violations.append(
                f"job {j}: done={d} quarantined={q} (must be exactly one)"
            )
    return violations


def run_campaign_soak(
    workdir: str,
    faults_spec: str,
    seed: int,
    n_obs: int = 3,
    nsamps: int = 1 << 12,
    max_attempts: int = 3,
    lease_s: float = 1.0,
    config: dict | None = None,
    device: str = "cuda",
) -> dict:
    """Reference campaign (fault-free) + chaos campaign (seeded
    schedule) over the same observations, the jobs on ``device``;
    returns the report section with a ``violations`` list (empty =
    survived)."""
    from ..campaign.queue import JobQueue, job_id_for
    from ..campaign.rollup import load_campaign_status
    from ..obs.schema import validate_manifest
    from ..resilience import STATS, faults
    from ..resilience.faults import parse_faults

    plan = parse_faults(faults_spec, seed)
    unknown = set(plan.rules) - TRANSIENT_SITES
    if unknown:
        raise ValueError(f"non-transient fault sites: {sorted(unknown)}")

    config = config or {"dm_end": 20.0, "min_snr": 7.0, "n_widths": 6}
    data_dir = os.path.join(workdir, "data")
    inputs = make_observations(data_dir, n_obs=n_obs, nsamps=nsamps)
    job_ids = [job_id_for(p) for p in inputs]

    # --- reference: the ground truth this soak judges against --------
    faults.configure(None)
    STATS.reset()
    ref_root = os.path.join(workdir, "ref")
    log.info("chaos soak: fault-free reference campaign (%d obs)", n_obs)
    ref = _run_campaign(
        ref_root, inputs, config, lease_s, max_attempts, device
    )
    ref_cands = {j: _job_candidate_bytes(ref_root, j) for j in job_ids}
    if ref["tally"]["done"] != n_obs or any(
        v is None for v in ref_cands.values()
    ):
        raise RuntimeError(
            f"reference campaign did not complete cleanly: {ref}"
        )

    # --- chaos: same inputs, seeded schedule --------------------------
    STATS.reset()
    active = faults.configure(faults_spec, seed)
    chaos_root = os.path.join(workdir, "chaos")
    log.info(
        "chaos soak: campaign under schedule %r (seed %d)",
        faults_spec, seed,
    )
    try:
        chaos = _run_campaign(
            chaos_root, inputs, config, lease_s, max_attempts, device
        )
    finally:
        faults.configure(None)
    stats = STATS.snapshot()
    injection_log = active.to_doc() if active else {}

    # --- invariants ---------------------------------------------------
    queue = JobQueue(chaos_root)
    counts = queue.counts()

    # exactly-once: every job terminal, none lost, none in two states
    violations: list[str] = _exactly_once_violations(
        chaos_root, counts, job_ids, n_obs
    )

    # transient-only schedule: zero quarantine, bitwise-equal products
    if counts["quarantined"]:
        violations.append(
            f"{counts['quarantined']} job(s) quarantined under a "
            "transient-only schedule"
        )
    for j in job_ids:
        got = _job_candidate_bytes(chaos_root, j)
        if got is None:
            violations.append(f"job {j}: no candidate file after soak")
        elif got != ref_cands[j]:
            violations.append(
                f"job {j}: candidates differ from the fault-free run"
            )

    # clean tree
    residue = _tree_residue(chaos_root)
    if residue:
        violations.append(f"leaked files: {residue[:8]}")

    # valid telemetry + rollup with the resilience section
    for j in job_ids:
        man_path = os.path.join(chaos_root, "jobs", j, "telemetry.json")
        try:
            with open(man_path) as f:
                validate_manifest(json.load(f))
        except Exception as exc:
            violations.append(
                f"job {j}: telemetry manifest invalid: {exc!s:.200}"
            )
    try:
        rollup = load_campaign_status(
            os.path.join(chaos_root, "campaign_status.json")
        )
        if "resilience" not in rollup:
            violations.append("rollup lacks the resilience section")
    except Exception as exc:
        violations.append(f"campaign rollup unreadable: {exc!s:.200}")

    # bounded retries: policy budget x injections per site
    from ..resilience.policy import DB_RETRY, IO_RETRY

    budget = max(IO_RETRY.max_attempts, DB_RETRY.max_attempts)
    for site, n in stats["retries"].items():
        injected = stats["faults_injected"].get(site.split(":")[0], 0)
        if n > budget * max(1, injected):
            violations.append(
                f"unbounded retries at {site}: {n} retries for "
                f"{injected} injection(s) (budget {budget}/each)"
            )

    # attribution: every fired site left a mark on its recovery path
    for site, n in stats["faults_injected"].items():
        tables = RECOVERY_TABLES.get(site, ())
        if tables and not any(
            any(k.startswith(site) or site in k for k in stats[t])
            for t in tables
        ):
            violations.append(
                f"fault {site} fired {n}x but no recovery path "
                f"({'/'.join(tables)}) recorded handling it"
            )
    if "worker.kill" in stats["faults_injected"]:
        # the reaper is worker.kill's recovery: the killed job must
        # have consumed extra attempts yet still completed
        reaped = [
            d for d in queue.done_records()
            if int(d.get("attempts", 1)) > 1
        ]
        if chaos["workers_killed"] and not reaped:
            violations.append(
                "worker.kill fired but no done record shows a reaped "
                "retry (attempts > 1)"
            )

    jobs = _job_summaries(queue)
    return {
        "n_obs": n_obs,
        "faults": faults_spec,
        "seed": seed,
        "device": str(device),
        "reference": ref,
        "chaos": chaos,
        "queue": counts,
        "jobs": jobs,
        "kernel_libraries_built": sum(
            j["jit_programs_compiled"] for j in jobs.values()
        ),
        "stats": stats,
        "injections": injection_log,
        "violations": violations,
    }


# --------------------------------------------------------------------------
# fleet soak: real worker PROCESSES under kills, churn and skew
# --------------------------------------------------------------------------

# the per-worker fault schedule one (non-victim) worker runs under:
# two deterministic flaky reads, recovered inside the shared IO retry
# budget — so the rollup's resilience section must show the marks
DEFAULT_FLEET_WORKER_FAULTS = "fil.read:n=2"


def _read_lines(path: str) -> list[str]:
    try:
        with open(path) as f:
            return f.readlines()
    except OSError:
        return []


def _fleet_roles(
    seed: int,
    n_workers: int,
    kills: int = 1,
    leavers: int = 1,
    late_joiners: int = 1,
    skew_s: float = 10.0,
    faults_spec: str = DEFAULT_FLEET_WORKER_FAULTS,
    gangs: int = 0,
) -> list[dict]:
    """Deterministic (seeded) role assignment for the fleet: which
    workers get SIGKILLed mid-job, which leave voluntarily after one
    job, which join late, and which run per-worker fault schedules
    (flaky reads on one drainer; a positive clock skew on a leaver —
    bounded premature reaping, absorbed by the attempt budget). At
    least one plain drainer always remains so the campaign can drain
    whatever the churn does.

    With ``gangs`` > 0 the flaky drainer and the (first) late joiner
    share the process group ``pod0`` — the gang job can only run once
    the late joiner arrives, so gang assembly-over-time is part of the
    drill, and neither group member is ever a kill victim or a leaver
    (a gang that can never assemble would deadlock the job, which the
    assembly timeout turns into a clean release loop instead)."""
    import random

    if n_workers < kills + late_joiners + 1:
        raise ValueError(
            f"fleet of {n_workers} cannot schedule {kills} kill(s) + "
            f"{late_joiners} late join(s) and still keep a drainer"
        )
    rng = random.Random(f"{seed}:fleet-roles")
    order = list(range(n_workers))
    rng.shuffle(order)
    victims = set(order[:kills])
    rest = [i for i in order if i not in victims]
    late = set(rest[-late_joiners:]) if late_joiners else set()
    # leavers drawn from the non-victim, non-late pool (a late joiner
    # that immediately leaves would be churn theatre, not coverage);
    # the FIRST of the pool stays a plain drainer
    pool = [i for i in rest if i not in late]
    leaver_set = set(pool[1 : 1 + leavers])
    faulty = pool[0] if pool else rest[0]
    skewed = next(iter(leaver_set), None)
    gang_members = (
        {faulty, min(late)} if gangs and late else
        set(pool[:2]) if gangs else set()
    )
    roles = []
    for i in range(n_workers):
        env_faults = []
        if i == faulty and faults_spec:
            env_faults.append(faults_spec)
        if i == skewed and skew_s:
            env_faults.append(f"clock.skew:skew={skew_s}")
        roles.append(
            {
                "index": i,
                "worker_id": f"fleet-w{i}",
                "kill": i in victims,
                "max_jobs": 1 if i in leaver_set else None,
                "late": i in late,
                "group": "pod0" if i in gang_members else "",
                "faults": (
                    ",".join(env_faults + [f"seed={seed}"])
                    if env_faults else ""
                ),
            }
        )
    return roles


def run_fleet_soak(
    workdir: str,
    faults_spec: str | None,
    seed: int,
    n_workers: int = 4,
    n_obs: int = 6,
    nsamps: int = 1 << 12,
    lease_s: float = 2.0,
    max_attempts: int = 6,
    kills: int = 1,
    leavers: int = 1,
    late_joiners: int = 1,
    skew_s: float = 10.0,
    timeout_s: float = 900.0,
    config: dict | None = None,
    gangs: int = 1,
    preempts: int = 1,
    autoscale: bool = True,
    device: str = "cuda",
) -> dict:
    """THE fleet-scale soak: N real ``peasoup-campaign run``
    subprocesses (``python -m peasoup_tpu_torch.cli.campaign run
    --device <device>``; on the card they share it) drain one shared campaign directory while the parent
    applies a seeded schedule of real SIGKILLs (delivered the moment a
    victim holds a claim), worker churn (a voluntary single-job
    leaver, a late joiner), a clock-skewed reaper, per-worker
    ``PEASOUP_FAULTS`` — and, new in v3, the scheduling drills:
    ``gangs`` gang-scheduled jobs (nprocs=2 across the ``pod0``
    process group, which only assembles once the late joiner arrives),
    ``preempts`` priority preemptions (an urgent observation enqueued
    mid-soak plus an explicit revoke on a running claim — the victim
    must checkpoint, release with zero attempts, and the job must
    resume bitwise-equal), and — with ``autoscale`` — a REAL
    AutoscaleController spawning at least one extra worker off the
    backlog. Judged by the same invariants as the in-process soak —
    exactly-once, candidates bitwise-equal to a fault-free reference,
    zero leaked claims/preempt-files/retire-markers/gang-dirs/registry
    entries, gang jobs never partially claimed — plus per-site
    recovery and preemption-latency attribution assembled from the
    campaign rollup and the workers' own logs."""
    import signal
    import subprocess
    import sys

    from ..campaign.queue import Job, JobQueue, job_id_for
    from ..campaign.rollup import load_campaign_status, write_status
    from ..campaign.runner import bucket_for_input
    from ..obs.schema import validate_manifest
    from ..resilience import STATS, faults
    from ..resilience.faults import parse_faults

    spec = faults_spec or DEFAULT_FLEET_WORKER_FAULTS
    plan = parse_faults(spec, seed)
    unknown = set(plan.rules) - TRANSIENT_SITES
    if unknown:
        raise ValueError(f"non-transient fault sites: {sorted(unknown)}")
    if n_obs < n_workers:
        raise ValueError(
            f"fleet soak needs >= one job per worker ({n_obs} obs for "
            f"{n_workers} workers): every victim must get a claim to "
            "be killed holding it"
        )

    config = config or {"dm_end": 20.0, "min_snr": 7.0, "n_widths": 6}
    data_dir = os.path.join(workdir, "data")
    # one extra observation per scheduled preemption: the URGENT job,
    # enqueued mid-soak at priority 5 (the reference processes it
    # upfront — priority changes scheduling, never results)
    n_urgent = max(0, int(preempts))
    inputs = make_observations(
        data_dir, n_obs=n_obs + n_urgent, nsamps=nsamps
    )
    base_inputs, urgent_inputs = inputs[:n_obs], inputs[n_obs:]
    job_ids = [job_id_for(p) for p in inputs]
    n_total = len(inputs)
    # the LAST base observation runs as the gang job (any would do;
    # the last keeps the early claims free for the kill schedule)
    gang_inputs = (
        {base_inputs[-1]: 2} if gangs and n_workers >= 2 else {}
    )
    gang_job_ids = {job_id_for(p) for p in gang_inputs}

    # --- fault-free reference (in-process; same code path — the
    # workers enter through runner.run_worker either way) -------------
    faults.configure(None)
    STATS.reset()
    ref_root = os.path.join(workdir, "fleet_ref")
    log.info(
        "fleet soak: fault-free reference campaign (%d obs)", n_total
    )
    ref = _run_campaign(
        ref_root, inputs, config, lease_s, max_attempts, device
    )
    ref_cands = {j: _job_candidate_bytes(ref_root, j) for j in job_ids}
    if ref["tally"]["done"] != n_total or any(
        v is None for v in ref_cands.values()
    ):
        raise RuntimeError(
            f"reference campaign did not complete cleanly: {ref}"
        )

    # --- the fleet ----------------------------------------------------
    root = os.path.join(workdir, "fleet")
    queue = _setup_campaign(
        root, base_inputs, config, lease_s, max_attempts,
        gang_inputs=gang_inputs,
    )
    roles = _fleet_roles(
        seed, n_workers, kills=kills, leavers=leavers,
        late_joiners=late_joiners, skew_s=skew_s, faults_spec=spec,
        gangs=gangs,
    )
    logs_dir = os.path.join(workdir, "fleet_logs")
    os.makedirs(logs_dir, exist_ok=True)
    # the workers import this package wherever the soak was started from;
    # the kernel libraries they load are shared by source hash (kernels.py)
    pkg_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )

    procs: dict[str, dict] = {}

    def spawn(role: dict) -> None:
        env = dict(os.environ)
        env.pop("PEASOUP_FAULTS", None)
        if role["faults"]:
            env["PEASOUP_FAULTS"] = role["faults"]
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH")) if p
        )
        cmd = [
            sys.executable, "-m", "peasoup_tpu_torch.cli.campaign", "run",
            "-w", root, "--worker-id", role["worker_id"],
            "--pipeline", "spsearch",
            "--config", json.dumps(config),
            "--lease", str(lease_s),
            "--max-attempts", str(max_attempts),
            "--backoff", "0.05",
            "--no-warmup",
            "--poll", "0.05",
            "--device", str(device),
        ]
        if role["max_jobs"]:
            cmd += ["--max-jobs", str(role["max_jobs"])]
        if role.get("group"):
            cmd += ["--group", role["group"]]
        logf = open(
            os.path.join(logs_dir, role["worker_id"] + ".log"), "wb"
        )
        proc = subprocess.Popen(
            cmd, stdout=logf, stderr=subprocess.STDOUT, env=env
        )
        procs[role["worker_id"]] = {
            "proc": proc, "logf": logf,
            "log": logf.name, "role": role, "killed": False,
        }
        log.info(
            "fleet: spawned %s (pid %d)%s%s%s",
            role["worker_id"], proc.pid,
            " [victim]" if role["kill"] else "",
            f" [leaves after {role['max_jobs']}]" if role["max_jobs"]
            else "",
            f" [faults {role['faults']}]" if role["faults"] else "",
        )

    # the real autoscale controller, supervising the same campaign the
    # fleet drains: its spawns go through the soak's own spawn() so the
    # extra worker is settled, logged and attributed like any other
    controller = None
    if autoscale:
        from ..campaign.autoscale import (
            AutoscaleController,
            AutoscalePolicy,
        )

        def _scale_spawn(wid: str):
            role = {
                "worker_id": wid, "kill": False, "max_jobs": None,
                "late": False, "group": "", "faults": "",
            }
            spawn(role)
            return procs[wid]["proc"]

        controller = AutoscaleController(
            root,
            AutoscalePolicy(
                min_workers=1,
                max_workers=n_workers + 1,
                cooldown_s=max(2.0, 2 * lease_s),
                backlog_per_worker=1.0,
            ),
            spawn=_scale_spawn,
            controller_id="scale",
        )

    t0 = time.perf_counter()
    for role in roles:
        if not role["late"]:
            spawn(role)
    late_pending = [r for r in roles if r["late"]]
    pending_victims = {r["worker_id"] for r in roles if r["kill"]}
    gang_workers = {r["worker_id"] for r in roles if r.get("group")}
    kills_done: list[dict] = []
    joins: list[str] = []
    preempts_requested: list[dict] = []
    preempt_targets_tried: set[str] = set()
    urgent_enqueued = False
    last_scale_step = 0.0
    claims_dir = os.path.join(root, "queue", "claims")
    done_dir = os.path.join(root, "queue", "done")
    timed_out = False
    profile_drilled: dict | None = None
    profile_announced = False
    profile_requests: list[str] = []
    from ..campaign.registry import WorkerRegistry as _Registry

    soak_registry = _Registry(root, lease_s=lease_s)
    while True:
        if time.perf_counter() - t0 > timeout_s:
            timed_out = True
            break
        # preemption drill: once any claim is live, enqueue the urgent
        # observation at priority 5 AND revoke one running claim
        # explicitly (retrying with a new target if a fast job slipped
        # to done before its renewer observed) — never a gang claim,
        # never the kill victim's (those drills must stay orthogonal)
        if n_urgent and os.path.isdir(claims_dir):
            if not urgent_enqueued and any(
                n.endswith(".json") for n in os.listdir(claims_dir)
            ):
                # the fleet is busy: the urgent work arrives NOW, at
                # priority 5 — exactly the displacement scenario
                for up in urgent_inputs:
                    queue.add_job(
                        Job(
                            job_id=job_id_for(up), input=up,
                            pipeline="spsearch",
                            bucket=bucket_for_input(up),
                            priority=5,
                        )
                    )
                urgent_enqueued = True
                log.info(
                    "fleet: enqueued %d urgent obs at priority 5",
                    len(urgent_inputs),
                )
            confirmed = sum(
                1 for jid in preempt_targets_tried
                if (j := queue.get_job(jid)) is not None and j.preemptions
            )
            outstanding = any(
                queue.preempt_request(jid) is not None
                for jid in preempt_targets_tried
            )
            if confirmed < n_urgent and not outstanding:
                for name in sorted(os.listdir(claims_dir)):
                    if not name.endswith(".json"):
                        continue
                    try:
                        with open(os.path.join(claims_dir, name)) as f:
                            doc = json.load(f)
                    except (OSError, json.JSONDecodeError):
                        continue
                    jid = doc.get("job_id")
                    if (
                        not jid
                        or jid in preempt_targets_tried
                        or jid in gang_job_ids
                        or doc.get("gang")
                        or doc.get("worker_id") in pending_victims
                    ):
                        continue
                    # generous grace: the target is usually the FIRST
                    # claim (coldest compile), and the victim can only
                    # answer at a chunk boundary — the grace-deadline
                    # escalation is drilled separately in unit tests
                    if queue.request_preempt(
                        jid, requester="chaos-soak", grace_s=300.0,
                    ):
                        preempt_targets_tried.add(jid)
                        preempts_requested.append(
                            {
                                "job_id": jid,
                                "victim": doc.get("worker_id"),
                            }
                        )
                        log.info(
                            "fleet: preempt requested on %s (held by "
                            "%s)", jid, doc.get("worker_id"),
                        )
                        break
        # autoscale control loop, throttled to ~1 Hz
        if controller is not None and (
            time.perf_counter() - last_scale_step > 1.0
        ):
            last_scale_step = time.perf_counter()
            try:
                controller.step()
            except Exception:
                log.warning("autoscale step failed", exc_info=True)
        # churn: the late joiners arrive once the fleet has made first
        # progress (a done record) — they must claim from the warm
        # bucket tier, not reopen cold ones
        if late_pending and os.listdir(done_dir):
            for role in late_pending:
                spawn(role)
                joins.append(role["worker_id"])
            late_pending = []
        # profile drill: once the fleet has made first progress, ask a
        # live, non-victim worker for an on-demand capture through the
        # real request protocol — on the CPU the capture is a guarded
        # no-op (obs/profiler.py), but the worker must still observe the
        # marker, clear it and announce the outcome in its metrics stream.
        # A marker that vanished unanswered is asked again of a live
        # stayer: a clock-skewed peer's registry reap takes a live
        # worker's marker with its entry (campaign/registry.py:reap), so
        # the drill asks only once the skewed peer has left.
        skew_live = any(
            "clock.skew" in p["role"].get("faults", "") and p["proc"].poll() is None
            for p in procs.values()
        )
        if (
            profile_drilled is not None
            and not profile_announced
            and time.perf_counter() - profile_drilled["t"] > 2.0
            and soak_registry.profile_requested(profile_drilled["worker_id"])
            is None
        ):
            try:
                with open(soak_registry.metrics_path(
                    profile_drilled["worker_id"]
                )) as f:
                    profile_announced = '"profile_captures_total"' in f.read()
            except OSError:
                pass
            if not profile_announced:
                log.info(
                    "fleet: profile request on %s vanished unanswered; "
                    "asking again", profile_drilled["worker_id"],
                )
                profile_drilled = None
        if profile_drilled is None and not skew_live and os.listdir(done_dir):
            for ent in soak_registry.live():
                wid = ent.get("worker_id")
                if not wid or wid in pending_victims:
                    continue
                proc_ent = procs.get(wid)
                if proc_ent is None or proc_ent["proc"].poll() is not None:
                    continue
                if proc_ent["role"].get("max_jobs"):
                    # early leavers may exit before observing the
                    # marker; drill a stayer so the check is sound
                    continue
                soak_registry.request_profile(
                    wid, seconds=0.2, requester="chaos-soak"
                )
                profile_drilled = {
                    "worker_id": wid, "seconds": 0.2,
                    "t": time.perf_counter(),
                }
                profile_requests.append(wid)
                log.info("fleet: profile drill requested on %s", wid)
                break
        # kills: a victim dies by REAL SIGKILL the moment it holds a
        # claim (plus a beat so the job is genuinely under way) — the
        # worst case for exactly-once, recovered only by lease reaping
        if pending_victims and os.path.isdir(claims_dir):
            for name in sorted(os.listdir(claims_dir)):
                if not name.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(claims_dir, name)) as f:
                        doc = json.load(f)
                except (OSError, json.JSONDecodeError):
                    continue
                wid = doc.get("worker_id")
                if wid in pending_victims:
                    ent = procs.get(wid)
                    pending_victims.discard(wid)
                    if ent and ent["proc"].poll() is None:
                        time.sleep(0.2)
                        try:
                            os.kill(ent["proc"].pid, signal.SIGKILL)
                        except ProcessLookupError:
                            continue
                        ent["killed"] = True
                        kills_done.append(
                            {
                                "worker_id": wid,
                                "pid": ent["proc"].pid,
                                "job_id": doc.get("job_id"),
                            }
                        )
                        log.warning(
                            "fleet: SIGKILLed %s (pid %d) mid-job %s",
                            wid, ent["proc"].pid, doc.get("job_id"),
                        )
        alive = [e for e in procs.values() if e["proc"].poll() is None]
        if not late_pending and not alive and queue.drained():
            break
        time.sleep(0.05)

    # settle: every spawned process must be gone (drained workers exit
    # on their own; a timeout kills the stragglers and is a violation)
    for ent in procs.values():
        if ent["proc"].poll() is None and timed_out:
            ent["proc"].kill()
        try:
            ent["proc"].wait(timeout=60)
        except subprocess.TimeoutExpired:
            ent["proc"].kill()
            ent["proc"].wait(timeout=10)
        ent["logf"].close()
    wall_s = round(time.perf_counter() - t0, 3)
    from ..campaign.registry import WorkerRegistry

    # sweep what the settled processes can no longer sweep themselves:
    # expired corpses and any retire marker that landed after its
    # worker had already exited (deregistration bugs still surface —
    # a LIVE leftover entry is not reaped here and fails the
    # zero-residue invariant below)
    WorkerRegistry(root, lease_s=lease_s).reap()
    write_status(root, queue)  # final rollup over the settled tree

    # --- invariants ---------------------------------------------------
    counts = queue.counts()
    violations = _exactly_once_violations(root, counts, job_ids, n_total)
    if timed_out:
        violations.append(
            f"fleet did not drain within {timeout_s:.0f}s"
        )
    if pending_victims and not timed_out:
        violations.append(
            f"kill schedule unapplied: {sorted(pending_victims)} never "
            "held a claim"
        )
    if counts["quarantined"]:
        violations.append(
            f"{counts['quarantined']} job(s) quarantined under a "
            "transient-only schedule"
        )
    for j in job_ids:
        got = _job_candidate_bytes(root, j)
        if got is None:
            violations.append(f"job {j}: no candidate file after soak")
        elif got != ref_cands[j]:
            violations.append(
                f"job {j}: candidates differ from the fault-free run"
            )
    residue = _tree_residue(root)
    if residue:
        violations.append(f"leaked files: {residue[:8]}")
    for j in job_ids:
        man_path = os.path.join(root, "jobs", j, "telemetry.json")
        try:
            with open(man_path) as f:
                validate_manifest(json.load(f))
        except Exception as exc:
            violations.append(
                f"job {j}: telemetry manifest invalid: {exc!s:.200}"
            )

    # --- per-site recovery attribution --------------------------------
    # injections counted from the workers' own logs (each subprocess
    # owns its STATS); recoveries from the rollup's resilience section
    # (aggregated per-job deltas) and the queue's attempt accounting
    injected: dict[str, int] = {}
    for ent in procs.values():
        try:
            with open(ent["log"], "rb") as f:
                text = f.read().decode("utf-8", "replace")
        except OSError:
            continue
        for site in SITES_IN_LOGS:
            n = text.count(f"injecting fault at {site}")
            if n:
                injected[site] = injected.get(site, 0) + n
    try:
        rollup = load_campaign_status(
            os.path.join(root, "campaign_status.json")
        )
    except Exception as exc:
        rollup = {}
        violations.append(f"campaign rollup unreadable: {exc!s:.200}")
    res = rollup.get("resilience") or {}
    if "fleet" not in rollup:
        violations.append("rollup lacks the fleet section")
    recovery: dict[str, dict] = {}
    for site, n in injected.items():
        if site in ("clock.skew",):
            recovery[site] = {"injected": n}
            continue
        marks = {
            t: v
            for t in ("retries", "recoveries", "giveups")
            for k, v in (res.get(t) or {}).items()
            if k.startswith(site)
        }
        recovery[site] = {"injected": n, **marks}
        if n and not marks:
            violations.append(
                f"fault {site} fired {n}x across the fleet but the "
                "rollup shows no recovery marks"
            )
    done = queue.done_records()
    if kills_done:
        reaped = [d for d in done if int(d.get("attempts", 1)) > 1]
        recovery["worker.kill"] = {
            "sigkills": len(kills_done),
            "reaped_retries": len(reaped),
        }
        if not reaped:
            violations.append(
                "SIGKILL(s) delivered but no done record shows a "
                "reaped retry (attempts > 1)"
            )

    # --- preemption attribution ---------------------------------------
    preempted_done = [d for d in done if d.get("preemptions")]
    preempt_section = {
        "requested": preempts_requested,
        "jobs_resumed": len(preempted_done),
        "latency_s": sorted(
            float(x)
            for d in preempted_done
            for x in (d.get("preempt_latency_s") or [])
        ),
    }
    if n_urgent:
        if not preempted_done:
            violations.append(
                "preemption scheduled but no done record carries a "
                "preemption tally (revoke never landed or was lost)"
            )
        elif not preempt_section["latency_s"]:
            violations.append(
                "preempted job resumed without preempt_latency_s "
                "attribution in its done record"
            )
        for d in preempted_done:
            if int(d.get("attempts", 1)) == 1:
                continue
            # a revoke must consume ZERO attempts. Attempts > 1 on a
            # preempted job is allowed only when ANOTHER drill also
            # hit it: the SIGKILL victim's reaped claim, or the
            # clock-skewed reaper prematurely reaping a fresh claim
            # (skew >> lease makes every claim look expired to it) —
            # both leave a reap signature in the job record's
            # last_error. The zero-attempt release itself is pinned
            # deterministically by tests/test_torch_fleet.py.
            jid = d.get("job_id")
            job = queue.get_job(jid)
            reap_attributed = jid in {
                k.get("job_id") for k in kills_done
            } or (
                job is not None
                and job.last_error is not None
                and (
                    "lease expired" in job.last_error
                    or "grace deadline" in job.last_error
                )
            )
            if not reap_attributed:
                violations.append(
                    f"preempted job {jid} consumed {d['attempts']} "
                    "attempts (revoke must consume zero) with no reap "
                    "to attribute them to"
                )

    # --- gang attribution ---------------------------------------------
    gang_done = [d for d in done if d.get("gang")]
    gang_section = {
        "scheduled": sorted(gang_job_ids),
        "done": len(gang_done),
        "members": sorted(
            {m for d in gang_done for m in d["gang"].get("members", [])}
        ),
    }
    if gang_inputs:
        if len(gang_done) != len(gang_job_ids):
            violations.append(
                f"{len(gang_job_ids)} gang job(s) scheduled but "
                f"{len(gang_done)} completed with gang provenance"
            )
        for d in gang_done:
            g = d["gang"]
            if len(g.get("members", [])) != int(g.get("nprocs", 0)):
                violations.append(
                    f"gang job {d.get('job_id')} completed PARTIALLY "
                    f"claimed: members {g.get('members')} vs nprocs "
                    f"{g.get('nprocs')}"
                )

    # --- fleet observability: metrics series + connected traces ------
    # the soak is ALSO the proof of the observability layer:
    # every worker's time series must be schema-valid and render a
    # parseable Prometheus exposition with nonzero queue-depth (and,
    # when a preemption was drilled, nonzero preemption-latency)
    # samples covering the soak window; every terminal job's span files
    # must merge into ONE connected trace with zero unclosed spans —
    # the preempted-and-resumed job showing both attempts plus the
    # revoke span, and the gang job showing both members' processes.
    from ..obs import metrics as obs_metrics
    from ..obs.trace import load_spans, trace_paths, trace_summary

    obs_section: dict = {"metrics": {}, "traces": {}}
    try:
        fleet_metrics = obs_metrics.fleet_samples(root, validate=True)
    except Exception as exc:
        fleet_metrics = {}
        violations.append(
            f"metrics series schema-invalid: {exc!s:.200}"
        )
    n_samples = sum(len(v) for v in fleet_metrics.values())
    obs_section["metrics"]["sources"] = sorted(fleet_metrics)
    obs_section["metrics"]["samples"] = n_samples
    if not n_samples:
        violations.append("fleet wrote no metrics samples")
    try:
        expo = obs_metrics.prometheus_exposition(fleet_metrics)
        obs_section["metrics"]["exposition_series"] = len(
            obs_metrics.parse_exposition(expo)
        )
    except Exception as exc:
        violations.append(
            f"Prometheus exposition failed to render/parse: {exc!s:.200}"
        )
    qdepth = obs_metrics.series(fleet_metrics, "queue_depth", "gauge")
    if not qdepth or max(r["value"] for r in qdepth) <= 0:
        violations.append(
            "queue_depth series empty or all-zero over the soak"
        )
    else:
        obs_section["metrics"]["queue_depth_samples"] = len(qdepth)
        obs_section["metrics"]["queue_depth_span_s"] = round(
            qdepth[-1]["t"] - qdepth[0]["t"], 3
        )
        if qdepth[-1]["t"] - qdepth[0]["t"] <= 0:
            violations.append(
                "queue_depth series does not span the soak window"
            )
    plat = obs_metrics.series(
        fleet_metrics, "preemption_latency_seconds", "hist"
    )
    if n_urgent:
        if not plat or max(r["value"] for r in plat) <= 0:
            violations.append(
                "preemption drilled but no nonzero "
                "preemption_latency_seconds metric recorded"
            )
        else:
            obs_section["metrics"]["preemption_latency_max_s"] = round(
                max(r["value"] for r in plat), 4
            )
    # profile drill attribution: the worker must have observed the
    # request (marker cleared) and announced the capture outcome —
    # captured on a device backend, skipped on the CPU guard, either
    # way a profile_captures_total sample with an outcome label
    if profile_requests and profile_drilled is None:
        # an answer that came after the soak asked another worker (on the
        # card a capture's start and export take seconds) still proves
        # the protocol: the requested worker observed, cleared, announced
        late = [
            wid for wid in profile_requests
            if any('"profile_captures_total"' in line
                   for line in _read_lines(soak_registry.metrics_path(wid)))
        ]
        if late:
            profile_drilled = {"worker_id": late[-1], "seconds": 0.2}
    if not profile_requests:
        violations.append(
            "profile drill never ran: no live stayer was asked for a capture"
        )
    if profile_requests and profile_drilled is None:
        violations.append(
            f"profile drill requested on {profile_requests} but the last "
            "request vanished unanswered with no live worker left to ask"
        )
    if profile_drilled is not None:
        pcaps = obs_metrics.series(
            fleet_metrics, "profile_captures_total", "counter"
        )
        outcomes = sorted(
            {
                (r.get("labels") or {}).get("outcome", "")
                for r in pcaps
            }
        )
        wid = profile_drilled["worker_id"]
        cleared = soak_registry.profile_requested(wid) is None
        obs_section["profile"] = {
            "drilled": {
                k: v for k, v in profile_drilled.items() if k != "t"
            },
            "requests": profile_requests,
            "samples": len(pcaps),
            "outcomes": outcomes,
            "marker_cleared": cleared,
        }
        if not pcaps:
            violations.append(
                "profile drill requested on "
                f"{profile_drilled['worker_id']} but no "
                "profile_captures_total metric was announced"
            )
        if not cleared:
            violations.append(
                f"profile drill: request marker for {wid} never "
                "cleared (worker did not observe it)"
            )
    preempted_ids = {
        d.get("job_id") for d in done if d.get("preemptions")
    }
    for j in job_ids:
        spans = load_spans(trace_paths(os.path.join(root, "jobs", j)))
        summ = trace_summary(spans)
        obs_section["traces"][j] = {
            "n_spans": summ["n_spans"],
            "trace_ids": summ["trace_ids"],
            "connected": summ["connected"],
            "workers": summ["workers"],
            "unclosed": summ["unclosed"],
            "n_flows": summ["n_flows"],
            "flows_linked": summ["flows_linked"],
            "attempts": sum(
                1 for s in spans if s.get("name") == "job_attempt"
            ),
        }
        if not spans:
            violations.append(f"job {j}: no trace spans written")
            continue
        if not summ["connected"]:
            violations.append(
                f"job {j}: trace NOT connected (trace_ids "
                f"{summ['trace_ids']})"
            )
        if summ["unclosed"]:
            violations.append(
                f"job {j}: {summ['unclosed']} unclosed span(s)"
            )
        names = set(summ["span_names"])
        if j in preempted_ids:
            n_attempts = obs_section["traces"][j]["attempts"]
            if n_attempts < 2:
                violations.append(
                    f"preempted job {j}: trace shows {n_attempts} "
                    "attempt span(s), expected the original AND the "
                    "resume in one connected trace"
                )
            if "revoke" not in names:
                violations.append(
                    f"preempted job {j}: no revoke-latency span in "
                    "its trace"
                )
        if j in gang_job_ids and len(summ["workers"]) < 2:
            violations.append(
                f"gang job {j}: trace spans from "
                f"{summ['workers']} — expected both members' "
                "processes in one connected trace"
            )
        if (
            j in gang_job_ids
            and len(summ["workers"]) >= 2
            and not summ["flows_linked"]
        ):
            violations.append(
                f"gang job {j}: no flow id links the members' "
                "gang_barrier spans (expected the same deterministic "
                "flow id on every rank of each barrier round)"
            )

    # --- survey-health alerts over the settled tree -------------------
    # the workers evaluated the default SLO/data-quality rules while
    # running; the snapshot must exist and validate (what fired is
    # campaign-dependent — the lifecycle itself is drilled by
    # the alerts tests with a controlled clock)
    try:
        from ..obs.alerts import load_alerts, validate_snapshot

        alerts_snap = load_alerts(root)
        validate_snapshot(alerts_snap)
        by_state: dict[str, int] = {}
        for a in alerts_snap.get("alerts", []):
            by_state[a["state"]] = by_state.get(a["state"], 0) + 1
        obs_section["alerts"] = {
            "states": by_state,
            "updated_unix": alerts_snap.get("updated_unix"),
        }
        if not os.path.exists(
            os.path.join(root, "queue", "alerts.json")
        ):
            violations.append(
                "fleet workers never wrote an alerts snapshot "
                "(queue/alerts.json missing after the soak)"
            )
    except Exception as exc:
        violations.append(
            f"alerts snapshot invalid after the soak: {exc!s:.200}"
        )

    # --- autoscale attribution ----------------------------------------
    scale_section = None
    if controller is not None:
        scale_section = {
            "decisions": controller.decisions,
            "ups": sum(
                1 for d in controller.decisions if d["action"] == "up"
            ),
            "downs": sum(
                1 for d in controller.decisions if d["action"] == "down"
            ),
        }
        if not scale_section["ups"]:
            violations.append(
                "autoscale controller never scaled up despite the "
                "backlog (no 'up' decision)"
            )
        if "autoscale" not in (rollup or {}) or not (
            rollup.get("autoscale") or {}
        ).get("decisions"):
            violations.append(
                "rollup lacks the autoscale decision log"
            )

    jobs = _job_summaries(queue)
    return {
        "n_obs": n_obs,
        "n_urgent": n_urgent,
        "n_workers": n_workers,
        "device": str(device),
        "faults": spec,
        "seed": seed,
        "roles": [
            {k: v for k, v in r.items() if k != "index"} for r in roles
        ],
        "kills": kills_done,
        "late_joins": joins,
        "reference": ref,
        "wall_s": wall_s,
        "queue": counts,
        "jobs": jobs,
        "kernel_libraries_built": sum(
            j["jit_programs_compiled"] for j in jobs.values()
        ),
        "worker_logs": sorted(e["log"] for e in procs.values()),
        "recovery": recovery,
        "preemption": preempt_section,
        "gang": gang_section,
        "autoscale": scale_section,
        "observability": obs_section,
        "violations": violations,
    }


# sites whose injections are counted from worker logs in the fleet
# soak (the log line is faults.py's "injecting fault at <site>")
SITES_IN_LOGS = ("fil.read", "queue.claim", "db.ingest", "clock.skew")


# --------------------------------------------------------------------------
# stream soak
# --------------------------------------------------------------------------

def _run_stream(outdir: str, fil_path: str, device: str = "cuda") -> dict:
    from .. import kernels
    from ..io.sigproc import read_filterbank
    from ..io.stream_source import ReplaySource
    from ..obs.telemetry import RunTelemetry
    from ..stream.driver import StreamConfig, StreamingSearch

    os.makedirs(outdir, exist_ok=True)
    cfg = StreamConfig(
        outdir=outdir, dm_end=20.0, min_snr=7.0, n_widths=6,
        chunk_samples=1024, decimate=8, latency_slo_s=30.0,
        warmup=False,
    )
    tel = RunTelemetry()
    launched0 = dict(kernels.launches)
    with tel.activate():
        fil = read_filterbank(fil_path)
        result = StreamingSearch(cfg, device=device).run(
            ReplaySource(fil, block_samples=512, rate=0.0)
        )
        tel.write(os.path.join(outdir, "telemetry.json"))
    launched = {
        k: n - launched0.get(k, 0) for k, n in kernels.launches.items()
        if n > launched0.get(k, 0)
    }
    return {
        "triggers": [
            (int(c.dm_idx), int(c.sample), int(c.width), float(c.snr))
            for c in result.candidates
        ],
        "n_chunks": result.n_chunks,
        "drops": result.drops,
        # the JAX field counts XLA recompiles past warmup; the port builds
        # kernel libraries, never programs per shape: those this run built
        "jit_programs_steady": int(
            tel.counters.get("kernels.library_builds", 0)
        ),
        "kernel_launches": launched,
        "events": tel.events,
    }


def run_stream_soak(
    workdir: str, faults_spec: str, seed: int, nsamps: int = 1 << 12,
    device: str = "cuda",
) -> dict:
    """Replay the same recording fault-free and under the schedule, on
    ``device``; the stream must emit identical triggers with zero
    drops."""
    from ..resilience import STATS, faults
    from ..resilience.faults import parse_faults

    plan = parse_faults(faults_spec, seed)
    unknown = set(plan.rules) - {"fil.read"}
    if unknown:
        raise ValueError(
            f"stream soak drills fil.read only, got: {sorted(unknown)}"
        )
    [fil_path] = make_observations(
        os.path.join(workdir, "stream_data"), n_obs=1, nsamps=nsamps
    )
    faults.configure(None)
    STATS.reset()
    ref = _run_stream(os.path.join(workdir, "stream_ref"), fil_path, device)
    STATS.reset()
    active = faults.configure(faults_spec, seed)
    try:
        chaos = _run_stream(
            os.path.join(workdir, "stream_chaos"), fil_path, device
        )
    finally:
        faults.configure(None)
    stats = STATS.snapshot()

    violations: list[str] = []
    if not ref["triggers"]:
        raise RuntimeError("reference stream produced no triggers")
    if chaos["triggers"] != ref["triggers"]:
        violations.append(
            f"stream triggers differ: {len(chaos['triggers'])} vs "
            f"{len(ref['triggers'])} reference"
        )
    if chaos["drops"].get("blocks") or chaos["drops"].get("gap_samples"):
        violations.append(f"stream dropped data: {chaos['drops']}")
    if chaos["jit_programs_steady"]:
        violations.append(
            f"{chaos['jit_programs_steady']} steady-state recompile(s) "
            "under faults"
        )
    injected = stats["faults_injected"].get("fil.read", 0)
    if injected and not (
        stats["retries"].get("fil.read") or stats["recoveries"].get("fil.read")
    ):
        violations.append(
            "fil.read fired on the stream but no retry/recovery "
            "recorded handling it"
        )
    kinds = {e["kind"] for e in chaos["events"]}
    if injected and "fault_injected" not in kinds:
        violations.append(
            "injections happened without fault_injected telemetry"
        )
    keys = ("n_chunks", "drops", "kernel_launches")
    return {
        "faults": faults_spec,
        "seed": seed,
        "device": str(device),
        "reference": {k: ref[k] for k in keys},
        "chaos": {k: chaos[k] for k in keys},
        "n_triggers": len(ref["triggers"]),
        "stats": stats,
        "injections": active.to_doc() if active else {},
        "violations": violations,
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-chaos",
        description="Chaos soak: run campaign/stream workloads under a "
        "seeded fault schedule and assert the survival invariants "
        "(exactly-once, bitwise-equal candidates, clean tree, valid "
        "telemetry, bounded + attributed recovery).",
    )
    p.add_argument(
        "--mode", choices=("campaign", "stream", "both", "fleet"),
        default="both",
        help="campaign/stream soak in-process workers; fleet spawns N "
        "REAL `python -m peasoup_tpu_torch.cli.campaign run` "
        "subprocesses and applies a seeded "
        "schedule of SIGKILLs, churn (late join, voluntary leave), "
        "clock skew and per-worker PEASOUP_FAULTS",
    )
    p.add_argument(
        "--faults", default=None,
        help="fault schedule (resilience/faults.py grammar); default: "
        f"campaign {DEFAULT_CAMPAIGN_FAULTS!r}, "
        f"stream {DEFAULT_STREAM_FAULTS!r}",
    )
    p.add_argument("--seed", type=int, default=7)
    p.add_argument(
        "-o", "--workdir", default=None,
        help="soak directory (default: a fresh temp dir)",
    )
    p.add_argument("--n-obs", type=int, default=3)
    p.add_argument(
        "--nsamps", type=int, default=1 << 12,
        help="samples per synthetic observation",
    )
    p.add_argument(
        "--lease", type=float, default=1.0,
        help="campaign claim lease seconds (kill recovery waits it out)",
    )
    p.add_argument(
        "--report", default=None,
        help="chaos_report.json path (default: <workdir>/chaos_report.json)",
    )
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the jobs and the stream run, the fleet's workers "
        "included (default: the CUDA device)",
    )
    fleet = p.add_argument_group("fleet mode")
    fleet.add_argument(
        "--workers", type=int, default=4,
        help="fleet worker subprocesses (default 4)",
    )
    fleet.add_argument(
        "--kills", type=int, default=1,
        help="workers SIGKILLed mid-job (default 1)",
    )
    fleet.add_argument(
        "--leavers", type=int, default=1,
        help="workers leaving voluntarily after one job (default 1)",
    )
    fleet.add_argument(
        "--late-joiners", type=int, default=1,
        help="workers joining after first progress (default 1)",
    )
    fleet.add_argument(
        "--skew", type=float, default=10.0,
        help="clock skew (s) injected into one leaver's reaper "
        "(default 10)",
    )
    fleet.add_argument(
        "--fleet-timeout", type=float, default=900.0,
        help="seconds before an undrained fleet is a violation "
        "(default 900)",
    )
    fleet.add_argument(
        "--gangs", type=int, default=1,
        help="gang-scheduled jobs (nprocs=2 across the pod0 process "
        "group; default 1, 0 disables)",
    )
    fleet.add_argument(
        "--preempts", type=int, default=1,
        help="priority preemptions: urgent obs enqueued mid-soak + a "
        "revoke on a running claim, asserted checkpointed/zero-attempt/"
        "latency-attributed (default 1, 0 disables)",
    )
    fleet.add_argument(
        "--autoscale", action=argparse.BooleanOptionalAction,
        default=True,
        help="run a real AutoscaleController over the fleet and assert "
        "at least one backlog-driven scale-up (default on)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="peasoup-chaos-")
    os.makedirs(workdir, exist_ok=True)
    report: dict = {
        "schema": REPORT_SCHEMA,
        "version": REPORT_VERSION,
        "workdir": os.path.abspath(workdir),
        "mode": args.mode,
    }
    report["device"] = args.device
    try:
        from ..device import resolve_device

        resolve_device(args.device)  # no card for cuda: exit 2
        violations: list[str] = []
        if args.mode in ("campaign", "both"):
            sec = run_campaign_soak(
                workdir,
                args.faults or DEFAULT_CAMPAIGN_FAULTS,
                args.seed,
                n_obs=args.n_obs,
                nsamps=args.nsamps,
                lease_s=args.lease,
                device=args.device,
            )
            report["campaign"] = sec
            violations += [f"campaign: {v}" for v in sec["violations"]]
        if args.mode in ("stream", "both"):
            sec = run_stream_soak(
                workdir,
                args.faults if args.mode == "stream" and args.faults
                else DEFAULT_STREAM_FAULTS,
                args.seed,
                nsamps=args.nsamps,
                device=args.device,
            )
            report["stream"] = sec
            violations += [f"stream: {v}" for v in sec["violations"]]
        if args.mode == "fleet":
            sec = run_fleet_soak(
                workdir,
                args.faults,
                args.seed,
                n_workers=args.workers,
                n_obs=args.n_obs,
                nsamps=args.nsamps,
                lease_s=args.lease,
                kills=args.kills,
                leavers=args.leavers,
                late_joiners=args.late_joiners,
                skew_s=args.skew,
                timeout_s=args.fleet_timeout,
                gangs=args.gangs,
                preempts=args.preempts,
                autoscale=args.autoscale,
                device=args.device,
            )
            report["fleet"] = sec
            violations += [f"fleet: {v}" for v in sec["violations"]]
        report["violations"] = violations
        report["ok"] = not violations
    except Exception as exc:
        import traceback

        traceback.print_exc()
        report["ok"] = False
        report["error"] = f"{type(exc).__name__}: {exc!s:.500}"
        _write_report(report, args)
        print("peasoup-chaos: internal error (exit 2)", file=sys.stderr)
        return 2
    _write_report(report, args)
    if report["ok"]:
        print(
            f"peasoup-chaos: SURVIVED ({args.mode}; "
            f"workdir {workdir})"
        )
        return 0
    print("peasoup-chaos: INVARIANT VIOLATIONS:", file=sys.stderr)
    for v in violations:
        print(f"  - {v}", file=sys.stderr)
    return 1


def _write_report(report: dict, args) -> None:
    path = args.report or os.path.join(
        report["workdir"], "chaos_report.json"
    )
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
        f.write("\n")
    print(f"peasoup-chaos: report -> {path}")


if __name__ == "__main__":
    sys.exit(main())
