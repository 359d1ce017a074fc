"""Tenant submission front end: admission control + audit journal (the
port's copy of the JAX package's campaign/ingest.py, same journal).

Every path an observation can enter a multi-tenant campaign by —
portal POST /submit (obs/portal.py), the watch-folder ingester below,
`peasoup-campaign submit` — funnels through :func:`submit_observation`
so admission policy lives in exactly one place:

1. the tenant must exist (campaign/tenants.py registry);
2. the input file must exist;
3. a duplicate job id (same observation already enqueued, any state)
   is rejected — enqueue is idempotent, and a resubmission must not
   reset another tenant's (or an earlier) job;
4. priority above the tenant's ``priority_max`` ceiling is CLAMPED,
   never rejected (the job still runs, at the class the tenant is
   entitled to), and flagged ``priority_capped`` in the journal;
5. a tenant at its ``max_queued`` ceiling is rejected outright —
   queue-depth pressure is an admission problem, unlike the runtime
   quotas (max_running / device-seconds) which park jobs as
   ``throttled`` at claim time.

Every decision — accepted or rejected, with reason — is journaled
append-only to ``queue/submissions.jsonl`` (who, what, when, via which
door), so operator audit is a log read, not archaeology. The journal
is size-capped by ``peasoup-campaign prune --journals`` via the shared
rotation idiom (obs/metrics.rotate_journal).
"""

from __future__ import annotations

import json
import os
import time

from ..obs import get_logger
from .queue import Job, JobQueue, job_id_for
from .tenants import TenantRegistry, queued_counts

log = get_logger("campaign.ingest")

SUBMISSIONS = "submissions.jsonl"

_SUBMIT_EXTS = (".fil", ".fbk")  # watch-folder drop extensions


def submissions_path(root: str) -> str:
    return os.path.join(os.path.abspath(root), "queue", SUBMISSIONS)


def append_submission(root: str, entry: dict) -> None:
    """Append-only journal write. A single ``write`` of one
    newline-terminated line is atomic at the sizes we emit, matching
    the alerts-journal idiom; readers tolerate a torn tail."""
    path = submissions_path(root)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry, sort_keys=True) + "\n")


def read_submissions(root: str) -> list[dict]:
    """Every parseable journal entry, in append order (a torn final
    line — writer killed mid-append — is skipped, not fatal)."""
    out: list[dict] = []
    try:
        with open(submissions_path(root)) as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    out.append(json.loads(ln))
                except json.JSONDecodeError:
                    continue
    except FileNotFoundError:
        pass
    return out


def submit_observation(
    root: str,
    tenant_name: str,
    input_path: str,
    *,
    priority: int = 0,
    config: dict | None = None,
    pipeline: str = "spsearch",
    via: str = "cli",
    queue: JobQueue | None = None,
    now: float | None = None,
) -> dict:
    """Admit (or reject) one observation for ``tenant_name`` and
    journal the decision. Returns the journal entry, whose
    ``accepted`` / ``reason`` / ``job_id`` fields the callers (portal,
    CLI, watch-folder) render directly. The caller authenticates the
    tenant (the portal by bearer token, the CLI by being the
    operator); this function enforces quota + policy."""
    now = time.time() if now is None else now
    queue = queue or JobQueue(root)
    entry: dict = {
        "t_unix": round(now, 3),
        "via": via,
        "tenant": tenant_name,
        "input": input_path,
        "pipeline": pipeline,
        "priority": int(priority),
        "priority_capped": False,
        "accepted": False,
        "reason": None,
        "job_id": None,
    }

    def _reject(reason: str) -> dict:
        entry["reason"] = reason
        append_submission(root, entry)
        log.warning(
            "submission rejected (%s, via %s): %s — %s",
            tenant_name, via, input_path, reason,
        )
        return entry

    tenant = TenantRegistry(root).get(tenant_name)
    if tenant is None:
        return _reject(f"unknown tenant {tenant_name!r}")
    if not input_path or not os.path.isfile(input_path):
        return _reject(f"input not found: {input_path}")
    job_id = job_id_for(input_path)
    entry["job_id"] = job_id
    if queue.get_job(job_id) is not None:
        return _reject(f"duplicate submission (job {job_id} exists)")
    if tenant.priority_max is not None and priority > tenant.priority_max:
        entry["priority"] = int(tenant.priority_max)
        entry["priority_capped"] = True
    if tenant.max_queued > 0:
        # Check-then-act across processes (CLI, watch ingester and
        # portal each run their own submit_observation): concurrent
        # submissions for one tenant can land between this count and
        # add_job below, over-admitting by at most the number of
        # simultaneous racers. Matching the running_counts contract,
        # that transient is accepted rather than locked away — the
        # very next submission counts every admitted job and the
        # ceiling re-asserts; retracting an already-visible job here
        # would race the workers' claim path instead.
        queued = queued_counts(root).get(tenant_name, 0)
        if queued >= tenant.max_queued:
            return _reject(
                f"max_queued reached ({queued}/{tenant.max_queued})"
            )
    # bucket derivation imports the sigproc reader lazily inside
    # runner.bucket_for_input, keeping this module (and the portal
    # handler that calls it) import-light
    from .runner import PIPELINES, bucket_for_input

    if pipeline not in PIPELINES:
        return _reject(f"unknown pipeline {pipeline!r}")
    job = Job(
        job_id=job_id,
        input=os.path.abspath(input_path),
        pipeline=pipeline,
        config=dict(config or {}),
        bucket=bucket_for_input(input_path),
        priority=int(entry["priority"]),
        tenant=tenant_name,
    )
    if not queue.add_job(job):
        return _reject(f"duplicate submission (job {job_id} exists)")
    entry["accepted"] = True
    append_submission(root, entry)
    log.info(
        "submission accepted (%s, via %s): %s -> job %s prio %d%s",
        tenant_name, via, input_path, job_id, entry["priority"],
        " (priority capped)" if entry["priority_capped"] else "",
    )
    return entry


def ingest_watch_folders(
    root: str,
    queue: JobQueue | None = None,
    pipeline: str = "spsearch",
) -> list[dict]:
    """One poll of every tenant's ``watch_dir``: new filterbank drops
    submit through the same admission path as HTTP (journaled with
    ``via="watch"``). Files whose job id is already enqueued are
    skipped SILENTLY — polling is repetitive by nature and must not
    spam the journal with duplicate rejections. Returns the journal
    entries for this poll's fresh submissions."""
    queue = queue or JobQueue(root)
    out: list[dict] = []
    for tenant in TenantRegistry(root).entries():
        wdir = tenant.watch_dir
        if not wdir or not os.path.isdir(wdir):
            continue
        try:
            names = sorted(os.listdir(wdir))
        except OSError:
            continue
        for name in names:
            if not name.lower().endswith(_SUBMIT_EXTS):
                continue
            path = os.path.join(wdir, name)
            if not os.path.isfile(path):
                continue
            if queue.get_job(job_id_for(path)) is not None:
                continue  # seen on an earlier poll: not a fresh drop
            out.append(
                submit_observation(
                    root, tenant.name, path,
                    pipeline=pipeline, via="watch", queue=queue,
                )
            )
    return out
