"""Campaign rollup: the atomically rewritten ``campaign_status.json``
(the port's copy of the JAX package's campaign/rollup.py: the same
document under the same schema name, so either package's tools read it).

One small JSON snapshot aggregates the whole campaign for operators and
schedulers, the survey-level analogue of a single run's ``status.json``
heartbeat (obs/heartbeat.py): queue depths by derived state, the
running jobs with each one's live stage/progress (read from the per-job
``status.json`` under its job dir), completion throughput and an ETA
extrapolated from the done timestamps, and the failure tallies
(retrying jobs with their last error, quarantined jobs). Workers
rewrite it after every state transition; ``python -m
peasoup_tpu_torch.tools.watch <campaign_dir>`` tails it.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
import time

from .queue import JobQueue
from .registry import WorkerRegistry

CAMPAIGN_SCHEMA = "peasoup_tpu.campaign_status"
CAMPAIGN_VERSION = 1


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def build_status(root: str, queue: JobQueue | None = None) -> dict:
    """Aggregate the campaign directory into one status document."""
    queue = queue or JobQueue(root)
    now = time.time()
    counts = queue.counts()

    running = []
    failures = []
    for jid in queue.job_ids():
        st = queue.state(jid, now)
        job = queue.get_job(jid)
        if st == "running":
            hb = _read_json(os.path.join(root, "jobs", jid, "status.json"))
            claim = _read_json(
                os.path.join(queue.qdir, "claims", f"{jid}.json")
            )
            running.append(
                {
                    "job_id": jid,
                    "worker_id": (claim or {}).get("worker_id"),
                    "stage": (hb or {}).get("stage"),
                    "progress": (hb or {}).get("progress"),
                    "stalled": bool((hb or {}).get("stalled")),
                }
            )
        elif st in ("backoff", "pending") and job and job.attempts:
            failures.append(
                {
                    "job_id": jid,
                    "attempts": job.attempts,
                    "retry_in_s": round(
                        max(0.0, job.next_eligible_unix - now), 3
                    ),
                    "last_error": job.last_error,
                }
            )

    done = queue.done_records()
    throughput = None
    eta_s = None
    if len(done) >= 2:
        ts = sorted(float(d.get("finished_unix", 0)) for d in done)
        span = ts[-1] - ts[0]
        if span > 0:
            throughput = (len(done) - 1) / span  # jobs per second
            remaining = counts["total"] - counts["done"] - counts["quarantined"]
            eta_s = round(remaining / throughput, 3) if remaining else 0.0

    n_candidates = sum(int(d.get("n_candidates", 0) or 0) for d in done)
    warmup_s = sum(float(d.get("warmup_s", 0) or 0) for d in done)
    warmed_jobs = sum(1 for d in done if d.get("warmup_s") is not None)
    tuning_s = sum(float(d.get("tuning_s", 0) or 0) for d in done)
    # per-bucket warmup/tuning tallies: the data warmup-aware claiming
    # (runner._warm_bucket_hint) exploits, surfaced for operators
    warm_buckets: dict[str, dict] = {}
    for d in done:
        b = d.get("bucket")
        if not b:
            continue
        key = ",".join(str(x) for x in b)
        rec = warm_buckets.setdefault(
            key, {"done": 0, "warmup_s": 0.0, "plan": None}
        )
        rec["done"] += 1
        rec["warmup_s"] = round(
            rec["warmup_s"] + float(d.get("warmup_s", 0) or 0), 3
        )
        if d.get("dedisp_plan") is not None:
            rec["plan"] = d["dedisp_plan"]
    # resilience rollup: sum the per-job deltas the runner stores in
    # done records (retries/degradations/faults survived on the way to
    # "done") — campaign-wide recovery accounting without re-reading
    # every job's telemetry manifest
    resilience: dict[str, dict] = {}
    for d in done:
        for table, kv in (d.get("resilience") or {}).items():
            if not isinstance(kv, dict):
                continue
            tgt = resilience.setdefault(table, {})
            for k, v in kv.items():
                tgt[k] = tgt.get(k, 0) + int(v)
    # lost-lease attempts (reaped from under a live run) publish no
    # done record — their survived-fault counters arrive through the
    # queue's per-worker orphaned-resilience spool instead
    # (queue.record_orphaned_resilience), so a recovery the fleet
    # genuinely performed never vanishes from the rollup
    orphaned = queue.orphaned_resilience()
    for rec in orphaned:
        for table, kv in (rec.get("resilience") or {}).items():
            if not isinstance(kv, dict):
                continue
            tgt = resilience.setdefault(table, {})
            for k, v in kv.items():
                tgt[k] = tgt.get(k, 0) + int(v)
    if orphaned:
        resilience["orphaned_attempts"] = {
            "total": len(orphaned),
        }
    quarantined = [
        {
            "job_id": q.get("job_id"),
            "attempts": q.get("attempts"),
            "last_error": q.get("last_error"),
        }
        for q in queue.quarantined()
    ]
    # fleet membership (campaign/registry.py, read-only here) + the
    # per-worker throughput derived from done records — live answers
    # to "who is working" and "who is pulling their weight" for an
    # elastic fleet where workers join and leave mid-campaign
    registry = WorkerRegistry(root)
    live_workers = [
        {
            "worker_id": e.get("worker_id"),
            "hostname": e.get("hostname"),
            "pid": e.get("pid"),
            "jobs_done": e.get("jobs_done", 0),
            "current_job": e.get("current_job"),
            # clamped at zero: a clock-skewed writer can stamp an
            # expiry ahead of this reader's clock, and a NEGATIVE
            # heartbeat age is noise operators learn to distrust
            "last_beat_s": round(
                max(0.0, now - (
                    float(e.get("expires_unix", now)) - registry.lease_s
                )), 3,
            ),
        }
        for e in registry.live(now)
    ]
    live_ids = {w["worker_id"] for w in live_workers}
    per_worker: dict[str, dict] = {}
    for d in done:
        wid = d.get("worker_id") or "?"
        rec = per_worker.setdefault(
            wid, {"done": 0, "first_unix": None, "last_unix": None}
        )
        rec["done"] += 1
        t = float(d.get("finished_unix", 0) or 0)
        if t:
            rec["first_unix"] = min(rec["first_unix"] or t, t)
            rec["last_unix"] = max(rec["last_unix"] or t, t)
    # a departed/reaped worker's rate must AGE OUT: its jobs_per_h was
    # computed over its own active span, so hours later the rollup
    # would still advertise a throughput nobody is delivering. Live
    # workers keep their rate; non-live workers keep it only within a
    # grace window of their last completion.
    rate_decay_s = max(300.0, 10.0 * registry.lease_s)
    for wid, rec in per_worker.items():
        span = (rec["last_unix"] or 0) - (rec["first_unix"] or 0)
        rate = (
            round((rec["done"] - 1) / span * 3600.0, 3)
            if rec["done"] > 1 and span > 0 else None
        )
        rec["live"] = wid in live_ids
        # clamped: under clock skew a done record can be stamped ahead
        # of this reader's clock (negative age = nonsense)
        age = max(0.0, now - (rec["last_unix"] or now))
        rec["last_done_age_s"] = round(age, 3)
        if not rec["live"] and age > rate_decay_s:
            rec["jobs_per_h"] = None
            rec["rate_stale"] = True
        else:
            rec["jobs_per_h"] = rate
    degraded_jobs = sum(1 for d in done if d.get("degraded"))
    # preemption attribution: revoked-and-resumed jobs carry their
    # tally + request->release latency into done records; outstanding
    # requests are revokes still in flight (queue/claims/*.preempt)
    preempted = [d for d in done if d.get("preemptions")]
    latencies = [
        float(x)
        for d in preempted
        for x in (d.get("preempt_latency_s") or [])
    ]
    preemptions = {
        "jobs": len(preempted),
        "total": sum(int(d.get("preemptions", 0)) for d in preempted),
        "outstanding_requests": len(
            glob.glob(
                os.path.join(queue.qdir, "claims", "*.preempt")
            )
        ),
        "latency_s": (
            {
                "mean": round(sum(latencies) / len(latencies), 4),
                "max": round(max(latencies), 4),
            }
            if latencies else None
        ),
    }
    gang_jobs = sum(1 for d in done if d.get("gang"))
    # autoscale decision log (campaign/autoscale.py), embedded so the
    # controller's reasoning rides the same operator surface
    from .autoscale import load_autoscale_log

    autoscale = load_autoscale_log(root)
    if autoscale is not None:
        autoscale = {
            k: autoscale.get(k)
            for k in (
                "controller_id", "last_action_unix", "spawned_total",
                "policy", "decisions",
            )
        }
    # *.corrupt quarantine accumulation (prune with
    # `peasoup-campaign prune --corrupt`)
    corrupt_files = len(
        glob.glob(
            os.path.join(os.path.abspath(root), "**", "*.corrupt"),
            recursive=True,
        )
    )
    # on-demand device-profile captures (obs/profiler.py): capture
    # dirs accumulate under <root>/profiles/ until
    # `peasoup-campaign prune --profiles` reclaims them
    pdir = os.path.join(os.path.abspath(root), "profiles")
    profile_dirs = 0
    profile_bytes = 0
    if os.path.isdir(pdir):
        for name in os.listdir(pdir):
            cap = os.path.join(pdir, name)
            if not os.path.isdir(cap):
                continue
            profile_dirs += 1
            for dp, _, fns in os.walk(cap):
                for fn in fns:
                    try:
                        profile_bytes += os.path.getsize(
                            os.path.join(dp, fn)
                        )
                    except OSError:
                        pass
    # fleet time-series summary (obs/metrics.py): how much history is
    # on disk and where to point `peasoup-campaign metrics`
    from ..obs.metrics import metrics_paths

    mpaths = metrics_paths(root)
    mbytes = 0
    for p in mpaths:
        try:
            mbytes += os.path.getsize(p)
        except OSError:
            pass
    # survey health (obs/alerts.py + obs/health.py): the alerts
    # snapshot (schema-validated; a torn/invalid snapshot is reported,
    # never raised — the rollup must always publish) and the
    # data-quality baselines/outliers over the done records
    from ..obs.alerts import load_alerts, validate_snapshot
    from ..obs.health import data_quality_summary, sentinel_status

    alerts_snapshot = load_alerts(root)
    alerts_section: dict = {"firing": 0, "pending": 0, "resolved": 0}
    try:
        validate_snapshot(alerts_snapshot)
        for a in alerts_snapshot.get("alerts", []):
            st = a.get("state")
            if st in alerts_section:
                alerts_section[st] += 1
        alerts_section["updated_unix"] = alerts_snapshot.get(
            "updated_unix", 0.0
        )
        alerts_section["active"] = [
            {
                "rule": a.get("rule"),
                "state": a.get("state"),
                "severity": a.get("severity"),
                "labels": a.get("labels") or {},
                "value": a.get("value"),
                "message": a.get("message", ""),
                "since_unix": a.get("since_unix"),
            }
            for a in alerts_snapshot.get("alerts", [])
            if a.get("state") in ("pending", "firing")
        ]
    except Exception as exc:
        alerts_section = {"invalid": f"{exc!s:.200}"}
    # multi-tenant view (campaign/tenants.py + usage.py): per-tenant
    # queue-state tallies, quota spec, windowed device-seconds vs
    # budget and the active throttle reason — plus the usage ledger
    # (also written to queue/usage.json by write_status)
    tenants_section: dict = {}
    usage_section: dict = {}
    try:
        from .tenants import TenantRegistry, throttle_map
        from .usage import build_usage

        tenant_entries = TenantRegistry(root).entries()
        if tenant_entries:
            throttles = throttle_map(root, now=now)
            usage_doc = build_usage(root, queue=queue, now=now)
            usage_section = usage_doc.get("tenants", {})
            per_tenant: dict[str, dict] = {
                t.name: {
                    "queued": 0, "running": 0, "throttled": 0,
                    "done": 0, "quarantined": 0,
                }
                for t in tenant_entries
            }
            for jid in queue.job_ids():
                job = queue.get_job(jid)
                if job is None or not job.tenant:
                    continue
                tally = per_tenant.setdefault(job.tenant, {
                    "queued": 0, "running": 0, "throttled": 0,
                    "done": 0, "quarantined": 0,
                })
                st = queue.state(jid, now)
                if st in ("pending", "backoff"):
                    tally["queued"] += 1
                elif st in ("running", "stale"):
                    tally["running"] += 1
                elif st in tally:
                    tally[st] += 1
            quotas = {t.name: t for t in tenant_entries}
            for name, tally in sorted(per_tenant.items()):
                t = quotas.get(name)
                u = usage_section.get(name) or {}
                tenants_section[name] = {
                    **tally,
                    "quota": t.quota_doc() if t else None,
                    "window_device_s": (
                        (u.get("window") or {}).get("device_seconds")
                    ),
                    "device_s_budget": (
                        t.device_seconds if t and t.device_seconds
                        else None
                    ),
                    "throttle": (
                        (throttles.get(name) or {}).get("reason")
                    ),
                }
    except Exception as exc:
        tenants_section = {}
        usage_section = {"invalid": f"{exc!s:.200}"}
    data_quality = data_quality_summary(done)
    sentinels = sentinel_status(root, queue)
    data_quality["sentinels"] = {
        "total": len(sentinels),
        "pending": sum(
            1 for s in sentinels if s.get("status") == "pending"
        ),
        "recovered": sum(
            1 for s in sentinels if s.get("status") == "recovered"
        ),
        "missed": sum(
            1 for s in sentinels if s.get("status") == "missed"
        ),
    }
    return {
        "schema": CAMPAIGN_SCHEMA,
        "version": CAMPAIGN_VERSION,
        "root": os.path.abspath(root),
        "updated_unix": now,
        "queue": counts,
        "done": queue.drained(),
        "running_jobs": running,
        "failures": failures,
        "quarantined": quarantined,
        "throughput_jobs_per_s": throughput,
        "eta_s": eta_s,
        "candidates_total": n_candidates,
        # AOT warmup rollup: seconds spent compiling ahead of data
        # across all workers' first-of-bucket jobs (perf/warmup.py)
        "warmup_total_s": round(warmup_s, 3),
        "warmup_jobs": warmed_jobs,
        # dedispersion auto-tuning rollup (perf/tuning.py): measuring
        # time paid (once per bucket per device) and the per-bucket
        # warm/plan tallies warmup-aware claiming reads
        "tuning_total_s": round(tuning_s, 3),
        "warm_buckets": warm_buckets,
        # what completed jobs survived (resilience/stats.py deltas)
        "resilience": resilience,
        # elastic fleet view: live membership + per-worker throughput
        "fleet": {
            "live": live_workers,
            "workers": per_worker,
        },
        # jobs that completed on a degradation rung (OOM fall-through,
        # crashed helper thread) and quarantined *.corrupt artifacts
        "degraded_jobs": degraded_jobs,
        "corrupt_artifact_files": corrupt_files,
        # per-worker time-series on disk (peasoup-campaign metrics)
        "metrics": {"files": len(mpaths), "bytes": mbytes},
        # device-profile captures on disk (prune with
        # `peasoup-campaign prune --profiles`)
        "profiles": {"captures": profile_dirs, "bytes": profile_bytes},
        # priority preemption: revoked/resumed jobs + revoke latency
        "preemptions": preemptions,
        # gang-scheduled (nprocs > 1) completions
        "gang_jobs": gang_jobs,
        # autoscale controller decision log (None when no controller
        # has acted on this campaign)
        "autoscale": autoscale,
        # survey health: alert lifecycle counts + active alerts
        # (obs/alerts.py snapshot) and the scientific data-quality
        # baselines/outliers/sentinels (obs/health.py)
        "alerts": alerts_section,
        "data_quality": data_quality,
        # multi-tenant view: per-tenant queue tallies + quota/throttle
        # state, and the usage ledger (device-seconds, jobs, bytes,
        # compiles per tenant — campaign/usage.py)
        "tenants": tenants_section,
        "usage": usage_section,
    }


def write_status(root: str, queue: JobQueue | None = None) -> dict:
    """Build + atomically rewrite ``<root>/campaign_status.json``."""
    doc = build_status(root, queue)
    path = os.path.join(root, "campaign_status.json")
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if doc.get("tenants"):
        # the standalone usage ledger beside the snapshot: portal
        # /usage and external accounting read the file, not the rollup
        try:
            from .usage import write_usage

            write_usage(root, queue=queue)
        except Exception:
            pass  # usage must never fail the status write
    return doc


def load_campaign_status(path: str) -> dict:
    """Load + validate a campaign_status.json snapshot."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != CAMPAIGN_SCHEMA:
        raise ValueError(
            f"{path}: not a {CAMPAIGN_SCHEMA} snapshot "
            f"(schema={doc.get('schema')!r})"
        )
    return doc
