"""`peasoup-campaign` of the PyTorch / CUDA port — fault-tolerant
multi-observation orchestration, with every subcommand and flag of the
JAX package's ``peasoup-campaign`` plus ``--device`` on the commands that
run searches (``run``, and ``autoscale`` for the workers it spawns): the
card unless the CPU is asked for. A campaign directory written by either
package is read and served by the other.

Run the pipelines over a manifest (or directory) of filterbanks as one
long-lived worker process; start the same command on N hosts/terminals
for N workers — they coordinate through the campaign directory alone
(file-backed queue with atomic claims, lease expiry, retry/backoff and
quarantine; see campaign/).

    # start (or join) a campaign: one worker per invocation
    python -m peasoup_tpu_torch.cli.campaign run -w camp/ --manifest obs.txt \\
        --pipeline spsearch --config '{"dm_end": 250, "min_snr": 7}'

    # live view (also: python -m peasoup_tpu_torch.tools.watch camp/)
    python -m peasoup_tpu_torch.cli.campaign status -w camp/

    # operator controls
    python -m peasoup_tpu_torch.cli.campaign quarantine-list -w camp/
    python -m peasoup_tpu_torch.cli.campaign retry -w camp/ --all
    python -m peasoup_tpu_torch.cli.campaign ingest -w camp/

Campaign layout: ``campaign.json`` (config, first writer wins),
``queue/`` (job records, claims, done + quarantine markers),
``jobs/<id>/`` (each job's outputs + its own status.json heartbeat,
flight recorder and telemetry manifest), ``candidates.sqlite`` (the
survey candidate database) and ``campaign_status.json`` (the rollup).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from . import add_log_level_arg, add_version_arg


def _load_config_arg(text: str | None) -> dict:
    """--config accepts inline JSON or @path-to-json-file."""
    if not text:
        return {}
    if text.startswith("@"):
        with open(text[1:]) as f:
            return json.load(f)
    return json.loads(text)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="peasoup-campaign",
        description="Peasoup campaign orchestration (PyTorch/CUDA port) - run the "
        "pipelines over many observations with a fault-tolerant "
        "multi-worker queue and a survey candidate database",
    )
    add_version_arg(p)
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser(
        "run", help="enqueue observations (idempotent) and work the "
        "queue until the campaign drains",
    )
    run.add_argument("-w", "--workdir", required=True,
                     help="campaign directory (shared by all workers)")
    run.add_argument("--manifest", default=None,
                     help="observation list: one .fil path per line, or "
                     "JSON lines {'input': ..., 'config': {...}}")
    run.add_argument("--data-dir", default=None,
                     help="enqueue every *.fil under this directory "
                     "instead of (or in addition to) --manifest")
    run.add_argument("--pipeline", default="spsearch",
                     choices=["search", "spsearch", "ffa", "fdas"],
                     help="which pipeline each job runs (default spsearch)")
    run.add_argument("--priority", type=int, default=0,
                     help="priority class for the observations enqueued "
                     "by THIS invocation (higher claims sooner — and may "
                     "preempt a running lower-priority claim; a "
                     "per-entry 'priority' in a JSON manifest line "
                     "overrides; default 0)")
    run.add_argument("--nprocs", type=int, default=1,
                     help="gang-schedule the observations enqueued by "
                     "THIS invocation across N worker processes of one "
                     "--group (search/spsearch pipelines; a per-entry "
                     "'nprocs' in a JSON manifest line overrides; "
                     "default 1 = no gang)")
    run.add_argument("--group", default=None,
                     help="process-group name for gang-scheduled jobs: "
                     "workers sharing a --group form one gang pool (the "
                     "lexicographically-first live member leads claims)")
    run.add_argument("--config", default=None,
                     help="pipeline config overrides as inline JSON or "
                     "@file.json (keys = SearchConfig/SinglePulseConfig "
                     "fields)")
    run.add_argument("--lease", type=float, default=60.0,
                     help="claim lease seconds; a worker dead past this "
                     "loses its job to the reaper (default 60)")
    run.add_argument("--max-attempts", type=int, default=3,
                     help="failures before quarantine (default 3)")
    run.add_argument("--backoff", type=float, default=2.0,
                     help="retry backoff base seconds, doubled per "
                     "attempt (default 2)")
    run.add_argument("--bucket-nsamps", default=None,
                     help="comma-separated explicit nsamps bucket ladder "
                     "(default: powers of two and 3*2^(k-1))")
    run.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                     default=True,
                     help="build and load each new bucket's kernels on a "
                     "background thread before its first job touches "
                     "data (default on; --no-warmup disables)")
    run.add_argument("--tune", action=argparse.BooleanOptionalAction,
                     default=False,
                     help="auto-tuned dedispersion plans: each new "
                     "bucket resolves exact-vs-subband + per-device "
                     "shape knobs on the warmup thread and persists "
                     "the winner in the campaign tuning cache "
                     "(warm buckets re-measure nothing)")
    run.add_argument("--tuning-cache", default="",
                     help="tuning_cache.json path (default: "
                     "<workdir>/tuning_cache.json, shared by all "
                     "workers)")
    run.add_argument("--warmup-mode", default="dryrun",
                     choices=["dryrun", "aot"],
                     help="dryrun = run the pipeline once over a "
                     "synthetic bucket-shaped observation (costs one "
                     "observation's device work); aot = build every "
                     "kernel and run the program registry once "
                     "(cheaper) (default dryrun)")
    run.add_argument("--max-jobs", type=int, default=None,
                     help="stop this worker after N jobs (default: run "
                     "until the campaign drains)")
    run.add_argument("--no-drain", action="store_true",
                     help="exit when nothing is immediately claimable "
                     "instead of waiting for running/backoff jobs")
    run.add_argument("--worker-id", default=None,
                     help="override the worker identity (default "
                     "hostname-pid)")
    run.add_argument("--poll", type=float, default=1.0,
                     help="seconds between queue polls while waiting "
                     "(default 1)")
    run.add_argument("--metrics", action=argparse.BooleanOptionalAction,
                     default=True,
                     help="per-worker time-series metrics under "
                     "queue/workers/ (obs/metrics.py; read with "
                     "`peasoup-campaign metrics`; default on)")
    run.add_argument("--trace", action=argparse.BooleanOptionalAction,
                     default=True,
                     help="per-job trace span files under jobs/<id>/ "
                     "(obs/trace.py; export with `peasoup-campaign "
                     "trace`; default on)")
    add_log_level_arg(run)
    run.add_argument("-v", "--verbose", action="store_true")
    run.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="where the jobs run (default: the CUDA device)")

    st = sub.add_parser("status", help="print the campaign rollup")
    st.add_argument("-w", "--workdir", required=True)
    st.add_argument("--json", action="store_true",
                    help="print the raw campaign_status.json document")

    rt = sub.add_parser(
        "retry", help="re-queue quarantined jobs (reset attempts)"
    )
    rt.add_argument("-w", "--workdir", required=True)
    rt.add_argument("job_ids", nargs="*", help="job ids to re-queue")
    rt.add_argument("--all", action="store_true",
                    help="re-queue every quarantined job")

    ql = sub.add_parser(
        "quarantine-list", help="list quarantined jobs with last errors"
    )
    ql.add_argument("-w", "--workdir", required=True)

    ing = sub.add_parser(
        "ingest", help="(re)ingest every completed job's outputs into "
        "the sqlite candidate database",
    )
    ing.add_argument("-w", "--workdir", required=True)

    pe = sub.add_parser(
        "preempt", help="revoke a running claim: the victim worker "
        "checkpoints at the next DM-block boundary and releases the "
        "job with zero attempts consumed (it resumes later, "
        "bitwise-equal); a victim unresponsive past the grace "
        "deadline is escalated to the lease reaper",
    )
    pe.add_argument("-w", "--workdir", required=True)
    pe.add_argument("job_id", help="the job whose claim to revoke")
    pe.add_argument("--grace", type=float, default=60.0,
                    help="seconds before an unresponsive victim is "
                    "reaped (default 60)")

    asc = sub.add_parser(
        "autoscale", help="run the fleet autoscale controller: spawn "
        "real workers when the backlog outruns the fleet, retire idle "
        "ones when it drains — bounded by --min/--max with a cooldown, "
        "decisions logged into campaign_status.json",
    )
    asc.add_argument("-w", "--workdir", required=True)
    asc.add_argument("--min", type=int, default=1, dest="min_workers")
    asc.add_argument("--max", type=int, default=4, dest="max_workers")
    asc.add_argument("--cooldown", type=float, default=60.0)
    asc.add_argument("--backlog-per-worker", type=float, default=2.0)
    asc.add_argument("--poll", type=float, default=5.0)
    asc.add_argument("--max-runtime", type=float, default=None,
                     help="stop the controller after N seconds "
                     "(default: run until the campaign drains)")
    asc.add_argument("--spawn-arg", action="append", default=[],
                     help="extra argument forwarded to each spawned "
                     "`peasoup-campaign run` (repeatable, e.g. "
                     "--spawn-arg=--no-warmup)")
    asc.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="where the spawned workers run (default: the CUDA "
                     "device)")

    me = sub.add_parser(
        "metrics", help="aggregate every worker's time-series metrics "
        "(queue/workers/*.metrics.jsonl) and print the Prometheus text "
        "exposition; --serve exposes it on a stdlib HTTP endpoint",
    )
    me.add_argument("-w", "--workdir", required=True)
    me.add_argument("--json", action="store_true",
                    help="print the raw samples (one JSON object per "
                    "worker) instead of the exposition")
    me.add_argument("--serve", action="store_true",
                    help="serve GET /metrics forever (Prometheus "
                    "scrape target; ctrl-C to stop)")
    me.add_argument("--port", type=int, default=9099)
    me.add_argument("--host", default="127.0.0.1")

    tr = sub.add_parser(
        "trace", help="export one or more jobs' cross-process trace "
        "spans as Chrome trace-event JSON (load at ui.perfetto.dev): "
        "a preempted-and-resumed job or an N-member gang renders as "
        "ONE connected timeline, one track per worker",
    )
    tr.add_argument("-w", "--workdir", required=True)
    tr.add_argument("job_ids", nargs="*",
                    help="jobs to export (default: every job with "
                    "trace files)")
    tr.add_argument("-o", "--output", default=None,
                    help="output trace JSON path (default: "
                    "<workdir>/trace.json)")
    tr.add_argument("--no-autoscale", action="store_true",
                    help="omit the autoscale decision instants from "
                    "the campaign track")

    pf = sub.add_parser(
        "profile", help="request a bounded on-demand torch.profiler "
        "capture from a LIVE worker: a profile.request file lands "
        "beside its registry entry, the worker observes it on its "
        "next beat and captures into <workdir>/profiles/ (guarded "
        "no-op on the CPU backend)",
    )
    pf.add_argument("-w", "--workdir", required=True)
    pf.add_argument("worker_id", help="the worker to profile (see "
                    "`peasoup-campaign status` fleet view)")
    pf.add_argument("--seconds", type=float, default=5.0,
                    help="capture duration (bounded at 60s; default 5)")

    pr = sub.add_parser(
        "prune", help="delete accumulated campaign artifacts: "
        "*.corrupt quarantine forensics (--corrupt) and on-demand "
        "torch.profiler capture directories (--profiles) — both grow "
        "forever otherwise",
    )
    pr.add_argument("-w", "--workdir", required=True)
    pr.add_argument("--corrupt", action="store_true",
                    help="prune *.corrupt quarantine files (the flag "
                    "keeps the verb explicit)")
    pr.add_argument("--profiles", action="store_true",
                    help="prune on-demand device-profile capture "
                    "directories under <workdir>/profiles/ "
                    "(peasoup-campaign profile output; counted in the "
                    "rollup's profiles section)")
    pr.add_argument("--journals", action="store_true",
                    help="rotate the append-only journals (alerts, "
                    "per-tenant alert routes, submissions) down to a "
                    "size cap, keeping the newest complete lines; "
                    "restart-safe — alert state lives in the snapshot, "
                    "not the journal")
    pr.add_argument("--max-bytes", type=int, default=1 << 20,
                    help="journal size cap for --journals (rotate when "
                    "larger, keep roughly half; default 1 MiB)")
    pr.add_argument("--older-than-days", type=float, default=0.0,
                    help="only prune artifacts older than N days "
                    "(default 0 = all)")
    pr.add_argument("--dry-run", action="store_true",
                    help="list what would be deleted without deleting")

    sv = sub.add_parser(
        "serve", help="serve the per-campaign live status portal "
        "(stdlib HTTP, read-only): /metrics (Prometheus exposition "
        "incl. the ALERTS series), /status, /alerts, /jobs/<id>, the "
        "sift report and bowtie plot",
    )
    sv.add_argument("-w", "--workdir", required=True)
    sv.add_argument("--port", type=int, default=9100)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--max-requests", type=int, default=None,
                    help="serve N requests then exit (for tests/gates; "
                    "default: serve forever)")
    sv.add_argument("--data-root", action="append", default=[],
                    dest="data_roots", metavar="DIR",
                    help="allow POST /submit inputs under DIR "
                    "(repeatable); a tenant's own watch_dir is always "
                    "allowed, anything else is rejected 403")

    al = sub.add_parser(
        "alerts", help="print the campaign's alerts snapshot "
        "(obs/alerts.py); --evaluate runs one evaluation round of the "
        "default SLO/data-quality/sentinel rules first",
    )
    al.add_argument("-w", "--workdir", required=True)
    al.add_argument("--evaluate", action="store_true",
                    help="evaluate the rules against the current "
                    "metrics before printing (workers also do this "
                    "continuously while running)")
    al.add_argument("--json", action="store_true",
                    help="print the raw alerts.json snapshot")

    se = sub.add_parser(
        "sentinel", help="enqueue a synthetic-pulsar injection "
        "sentinel at low priority: the campaign searches it like any "
        "observation, and the alert engine pages when the known "
        "candidate is NOT recovered — an end-to-end scientific "
        "validity probe",
    )
    se.add_argument("-w", "--workdir", required=True)
    se.add_argument("--check", action="store_true",
                    help="report recovery status of existing sentinels "
                    "instead of enqueueing a new one")
    se.add_argument("--min-snr", type=float, default=7.0,
                    help="S/N the recovered candidate must reach "
                    "(default 7)")
    se.add_argument("--dm-tol", type=float, default=5.0,
                    help="DM match tolerance in pc/cm^3 (default 5)")
    se.add_argument("--time-tol", type=float, default=0.05,
                    help="arrival-time match tolerance in seconds "
                    "(default 0.05)")
    se.add_argument("--nsamps", type=int, default=1 << 12,
                    help="synthetic observation length (default 4096)")

    te = sub.add_parser(
        "tenant", help="manage the multi-tenant registry "
        "(queue/tenants/<name>.json): add mints a bearer token, list "
        "shows quotas and live throttle state, rotate-token mints a "
        "replacement secret (the old token is rejected immediately), "
        "set-quota edits only the quota flags given — both admin "
        "actions are journaled to queue/submissions.jsonl",
    )
    te.add_argument("-w", "--workdir", required=True)
    te.add_argument("action", choices=["add", "list", "show", "remove",
                                       "rotate-token", "set-quota"])
    te.add_argument("name", nargs="?", default="",
                    help="tenant name (all actions except list)")
    te.add_argument("--token", default="",
                    help="bearer token (default: minted)")
    te.add_argument("--max-queued", type=int, default=None,
                    help="max non-terminal jobs (0 = unlimited)")
    te.add_argument("--max-running", type=int, default=None,
                    help="max concurrent running jobs (0 = unlimited)")
    te.add_argument("--device-seconds", type=float, default=None,
                    help="device-seconds budget per rolling window "
                    "(0 = unlimited)")
    te.add_argument("--window-s", type=float, default=None,
                    help="rolling budget window (default 3600)")
    te.add_argument("--priority-max", type=int, default=None,
                    help="priority ceiling; higher submissions are "
                    "clamped (default: none; set-quota: -1 clears "
                    "the ceiling)")
    te.add_argument("--watch-dir", default=None,
                    help="folder polled by `ingest-folder`; dropped "
                    ".fil/.fbk files are auto-submitted")

    sm = sub.add_parser(
        "submit", help="submit one observation as a tenant: "
        "quota-checked admission, journaled append-only to "
        "queue/submissions.jsonl whether accepted or rejected",
    )
    sm.add_argument("-w", "--workdir", required=True)
    sm.add_argument("tenant", help="tenant name")
    sm.add_argument("input", help="observation file (.fil/.fbk)")
    sm.add_argument("--priority", type=int, default=0)
    sm.add_argument("--pipeline", default="spsearch")
    sm.add_argument("--config", default=None,
                    help="per-job config overrides (JSON or @file)")

    inf = sub.add_parser(
        "ingest-folder", help="poll every tenant's watch folder once "
        "and submit fresh .fil/.fbk drops through the same "
        "quota-checked admission as HTTP/CLI submissions",
    )
    inf.add_argument("-w", "--workdir", required=True)
    inf.add_argument("--pipeline", default="spsearch")
    inf.add_argument("--poll", type=float, default=0.0,
                     help="keep polling every N seconds (default 0 = "
                     "one pass)")
    inf.add_argument("--max-runtime", type=float, default=None,
                     help="stop polling after N seconds")
    return p


def _cmd_run(args) -> int:
    from ..campaign.queue import JobQueue
    from ..campaign.rollup import write_status
    from ..campaign.runner import (
        CampaignConfig,
        enqueue_entries,
        parse_manifest,
        run_worker,
        save_campaign_config,
    )
    from ..device import resolve_device
    from ..obs import configure_logging

    configure_logging(args.log_level, args.verbose)
    resolve_device(args.device)  # no card where one is asked for: raise first
    ladder = (
        [int(x) for x in args.bucket_nsamps.split(",")]
        if args.bucket_nsamps else None
    )
    campaign = save_campaign_config(
        args.workdir,
        CampaignConfig(
            pipeline=args.pipeline,
            config=_load_config_arg(args.config),
            lease_s=args.lease,
            max_attempts=args.max_attempts,
            backoff_base_s=args.backoff,
            bucket_nsamps=ladder,
            warmup=args.warmup,
            warmup_mode=args.warmup_mode,
            tune=args.tune,
            tuning_cache=args.tuning_cache,
            metrics=args.metrics,
            trace=args.trace,
        ),
    )
    queue = JobQueue(
        args.workdir,
        lease_s=campaign.lease_s,
        max_attempts=campaign.max_attempts,
        backoff_base_s=campaign.backoff_base_s,
    )
    entries = []
    if args.manifest:
        entries.extend(parse_manifest(args.manifest))
    if args.data_dir:
        entries.extend(
            {"input": p}
            for p in sorted(
                glob.glob(os.path.join(args.data_dir, "**", "*.fil"),
                          recursive=True)
            )
        )
    added = enqueue_entries(
        queue, entries, campaign.pipeline, campaign.bucket_nsamps,
        priority=args.priority, nprocs=args.nprocs,
    )
    counts = queue.counts()
    print(
        f"campaign {os.path.abspath(args.workdir)}: enqueued {added} new "
        f"of {len(entries)} listed ({counts['total']} total jobs)"
    )
    if counts["total"] == 0:
        print("nothing to do (empty campaign)")
        return 1
    worker_id = args.worker_id or JobQueue.default_worker_id()
    tally = run_worker(
        args.workdir,
        worker_id=worker_id,
        max_jobs=args.max_jobs,
        drain=not args.no_drain,
        poll_s=args.poll,
        group=args.group,
        device=args.device,
    )
    status = write_status(args.workdir, queue)
    q = status["queue"]
    print(
        f"worker {worker_id}: {tally['done']} done, "
        f"{tally['failed']} failed, {tally['quarantined']} quarantined "
        f"(campaign: {q['done']}/{q['total']} done, "
        f"{q['quarantined']} quarantined)"
    )
    return 0 if q["quarantined"] == 0 and q["done"] == q["total"] else 2


def _cmd_status(args) -> int:
    from ..campaign.rollup import write_status
    from ..tools.watch import render_campaign_status

    doc = write_status(args.workdir)
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        sys.stdout.write(render_campaign_status(doc))
    return 0


def _cmd_retry(args) -> int:
    from ..campaign.queue import JobQueue
    from ..campaign.rollup import write_status
    from ..campaign.runner import load_campaign_config

    campaign = load_campaign_config(args.workdir)
    queue = JobQueue(
        args.workdir,
        lease_s=campaign.lease_s,
        max_attempts=campaign.max_attempts,
        backoff_base_s=campaign.backoff_base_s,
    )
    ids = list(args.job_ids)
    if args.all:
        ids.extend(
            q["job_id"] for q in queue.quarantined()
            if q.get("job_id") not in ids
        )
    if not ids:
        print("nothing to retry (no job ids given; use --all?)")
        return 1
    n = 0
    for jid in ids:
        if queue.retry(jid):
            print(f"re-queued {jid}")
            n += 1
        else:
            print(f"{jid}: not quarantined, skipping")
    write_status(args.workdir, queue)
    return 0 if n else 1


def _cmd_quarantine_list(args) -> int:
    from ..campaign.queue import JobQueue

    queue = JobQueue(args.workdir)
    rows = queue.quarantined()
    if not rows:
        print("quarantine is empty")
        return 0
    for q in rows:
        print(
            f"{q.get('job_id')}  attempts={q.get('attempts')}  "
            f"input={q.get('input')}\n    {q.get('last_error')}"
        )
    return 0


def _cmd_ingest(args) -> int:
    from ..campaign.db import DB_FILENAME, CandidateDB
    from ..campaign.queue import JobQueue

    queue = JobQueue(args.workdir)
    done = queue.done_records()
    if not done:
        print("no completed jobs to ingest")
        return 1
    total = {"periodicity": 0, "single_pulse": 0}
    with CandidateDB(os.path.join(args.workdir, DB_FILENAME)) as db:
        for rec in done:
            jid = rec["job_id"]
            job_dir = os.path.join(args.workdir, "jobs", jid)
            try:
                counts = db.ingest_job(jid, job_dir, rec.get("input", ""))
            except Exception as exc:
                print(f"{jid}: ingest failed: {exc}")
                continue
            for k, v in counts.items():
                total[k] += v
        summary = db.counts()
    print(
        f"ingested {len(done)} jobs: {total['periodicity']} periodicity "
        f"+ {total['single_pulse']} single-pulse candidates "
        f"({summary['observations']} observations in the database)"
    )
    return 0


def _cmd_preempt(args) -> int:
    from ..campaign.queue import JobQueue
    from ..campaign.rollup import write_status

    queue = JobQueue(args.workdir)
    if not queue.request_preempt(
        args.job_id, requester="operator", grace_s=args.grace
    ):
        print(
            f"{args.job_id}: no live claim to preempt "
            f"(state: {queue.state(args.job_id)})"
        )
        return 1
    write_status(args.workdir, queue)
    print(
        f"preempt requested on {args.job_id} (grace {args.grace:g}s); "
        "the victim will checkpoint and release"
    )
    return 0


def _cmd_autoscale(args) -> int:
    from ..campaign.autoscale import AutoscaleController, AutoscalePolicy
    from ..campaign.rollup import write_status

    try:
        controller = AutoscaleController(
            args.workdir,
            AutoscalePolicy(
                min_workers=args.min_workers,
                max_workers=args.max_workers,
                cooldown_s=args.cooldown,
                backlog_per_worker=args.backlog_per_worker,
            ),
            extra_args=args.spawn_arg,
            device=args.device,
        )
    except ValueError as exc:
        print(f"autoscale: {exc}", file=sys.stderr)
        return 2
    decisions = controller.run(
        poll_s=args.poll, max_runtime_s=args.max_runtime
    )
    write_status(args.workdir)
    ups = sum(1 for d in decisions if d["action"] == "up")
    print(
        f"autoscale: {ups} scale-up(s), {len(decisions) - ups} "
        f"retirement(s); decision log in "
        f"{os.path.join(args.workdir, 'autoscale.json')}"
    )
    return 0


def _cmd_metrics(args) -> int:
    from ..obs.metrics import (
        fleet_samples,
        metrics_paths,
        prometheus_exposition,
        serve_metrics,
    )

    if args.serve:
        try:
            serve_metrics(args.workdir, port=args.port, host=args.host)
        except KeyboardInterrupt:
            pass
        return 0
    if not metrics_paths(args.workdir):
        print(
            f"no metrics files under {args.workdir}/queue/workers/ "
            "(campaign never ran, or ran with --no-metrics)",
            file=sys.stderr,
        )
        return 1
    samples = fleet_samples(args.workdir)
    if args.json:
        print(json.dumps(samples, indent=2))
    else:
        sys.stdout.write(prometheus_exposition(samples))
    return 0


def _cmd_trace(args) -> int:
    from ..campaign.autoscale import load_autoscale_log
    from ..obs.trace import (
        export_chrome_trace,
        load_spans,
        trace_paths,
        trace_summary,
    )

    jobs_dir = os.path.join(args.workdir, "jobs")
    job_ids = list(args.job_ids)
    if not job_ids and os.path.isdir(jobs_dir):
        job_ids = sorted(
            j for j in os.listdir(jobs_dir)
            if trace_paths(os.path.join(jobs_dir, j))
        )
    spans = []
    for jid in job_ids:
        spans.extend(load_spans(trace_paths(os.path.join(jobs_dir, jid))))
    if not spans:
        print(
            f"no trace spans under {jobs_dir} "
            "(campaign never ran, or ran with --no-trace)",
            file=sys.stderr,
        )
        return 1
    extra = None
    if not args.no_autoscale:
        scale = load_autoscale_log(args.workdir) or {}
        extra = [
            {
                "name": f"autoscale:{d.get('action')}",
                "ts_unix": float(d.get("unix", 0.0)),
                "args": {
                    "worker_id": d.get("worker_id"),
                    "reason": d.get("reason"),
                },
            }
            for d in scale.get("decisions") or []
        ]
    doc = export_chrome_trace(spans, extra_instants=extra)
    out = args.output or os.path.join(args.workdir, "trace.json")
    # atomic publish: the default path lands inside the campaign dir,
    # where a watcher (or a second trace invocation) may read it while
    # a soak is still running (PSP101)
    from ..campaign.queue import _atomic_write_json

    _atomic_write_json(out, doc)
    for jid in job_ids:
        summ = trace_summary(
            load_spans(trace_paths(os.path.join(jobs_dir, jid)))
        )
        flag = "" if summ["connected"] else "  *** DISCONNECTED ***"
        print(
            f"{jid}: {summ['n_spans']} spans across "
            f"{len(summ['workers'])} worker(s) "
            f"[{', '.join(summ['workers'])}]"
            f"  trace_id={','.join(summ['trace_ids'])}{flag}"
        )
    print(
        f"exported {len(doc['traceEvents'])} trace events -> {out}\n"
        "view: open https://ui.perfetto.dev and load the file "
        "(or chrome://tracing)"
    )
    return 0


def _cmd_profile(args) -> int:
    from ..campaign.registry import WorkerRegistry

    registry = WorkerRegistry(args.workdir)
    live = {e.get("worker_id") for e in registry.live()}
    if args.worker_id not in live:
        print(
            f"{args.worker_id}: not a live worker "
            f"(live: {sorted(w for w in live if w)})",
            file=sys.stderr,
        )
        return 1
    registry.request_profile(
        args.worker_id, seconds=args.seconds, requester="operator"
    )
    print(
        f"profile requested for {args.worker_id} ({args.seconds:g}s); "
        f"the capture lands under "
        f"{os.path.join(args.workdir, 'profiles')}/ and is announced "
        "in the worker's metrics stream (profile_captures_total)"
    )
    return 0


def _cmd_prune(args) -> int:
    import shutil

    if not args.corrupt and not args.profiles and not args.journals:
        print(
            "prune: nothing selected (pass --corrupt for *.corrupt "
            "quarantine files, --profiles for device-profile capture "
            "directories, and/or --journals to rotate the append-only "
            "journals)"
        )
        return 1
    root = os.path.abspath(args.workdir)
    if args.journals:
        from ..obs.metrics import rotate_journal

        qdir = os.path.join(root, "queue")
        paths = [
            os.path.join(qdir, "alerts.jsonl"),
            os.path.join(qdir, "submissions.jsonl"),
        ]
        paths.extend(sorted(
            glob.glob(os.path.join(qdir, "alerts.*.jsonl"))
        ))
        for path in paths:
            if not os.path.exists(path):
                continue
            before = os.path.getsize(path)
            if args.dry_run:
                if before > args.max_bytes:
                    print(
                        f"prune: would rotate {path} "
                        f"({before} > {args.max_bytes} bytes)"
                    )
                continue
            if rotate_journal(path, args.max_bytes):
                print(
                    f"prune: rotated {path} "
                    f"({before} -> {os.path.getsize(path)} bytes)"
                )
        if not args.corrupt and not args.profiles:
            return 0
    now_unix = time.time()
    cutoff = now_unix - args.older_than_days * 86400.0
    selected: list[tuple[str, bool]] = []  # (path, is_dir)
    if args.corrupt:
        for path in sorted(
            glob.glob(os.path.join(root, "**", "*.corrupt"),
                      recursive=True)
        ):
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue  # pruned by a racing invocation
            if mtime <= cutoff:
                selected.append((path, False))
    if args.profiles:
        pdir = os.path.join(root, "profiles")
        for name in sorted(os.listdir(pdir)) if os.path.isdir(
            pdir
        ) else []:
            path = os.path.join(pdir, name)
            if not os.path.isdir(path):
                continue
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            if mtime <= cutoff:
                selected.append((path, True))
    verb = "would delete" if args.dry_run else "deleted"
    pruned = 0
    for path, is_dir in selected:
        if not args.dry_run:
            try:
                if is_dir:
                    shutil.rmtree(path)
                else:
                    os.unlink(path)
            except OSError as exc:
                print(f"prune: {path}: {exc}")
                continue
        pruned += 1
        print(f"prune: {verb} {path}")
    print(
        f"prune: {verb} {pruned} artifact(s)"
        + (
            f" older than {args.older_than_days:g} day(s)"
            if args.older_than_days else ""
        )
    )
    return 0


def _cmd_serve(args) -> int:
    from ..obs.portal import serve_portal

    try:
        serve_portal(
            args.workdir,
            port=args.port,
            host=args.host,
            max_requests=args.max_requests,
            data_roots=args.data_roots,
        )
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_alerts(args) -> int:
    from ..obs.alerts import evaluate_campaign, load_alerts

    if args.evaluate:
        snap = evaluate_campaign(args.workdir)
    else:
        snap = load_alerts(args.workdir)
    if args.json:
        print(json.dumps(snap, indent=2))
        return 0
    alerts = snap.get("alerts") or []
    if not alerts:
        print("no alerts (campaign healthy, or never evaluated)")
        return 0
    firing = 0
    for a in alerts:
        labels = a.get("labels") or {}
        lbl = " ".join(f"{k}={v}" for k, v in sorted(labels.items()))
        if a.get("state") == "firing":
            firing += 1
        line = (
            f"[{a.get('state'):>8}] {a.get('severity', '?'):<4} "
            f"{a.get('rule')}"
        )
        if lbl:
            line += f"  {lbl}"
        if a.get("message"):
            line += f"  {a['message']}"
        print(line)
    return 2 if firing else 0


def _cmd_sentinel(args) -> int:
    from ..obs.health import enqueue_sentinel, sentinel_status

    if args.check:
        rows = sentinel_status(args.workdir)
        if not rows:
            print("no sentinels enqueued")
            return 0
        missed = 0
        for r in rows:
            if r["status"] == "missed":
                missed += 1
            print(
                f"[{r['status']:>9}] {r['job_id']}  "
                f"dm={r.get('dm', 0):g} t={r.get('time_s', 0):g}s  "
                f"{r.get('detail', '')}"
            )
        return 2 if missed else 0
    doc = enqueue_sentinel(
        args.workdir,
        min_snr=args.min_snr,
        dm_tol=args.dm_tol,
        time_tol_s=args.time_tol,
        nsamps=args.nsamps,
    )
    print(
        f"sentinel enqueued as {doc['job_id']} (priority -1): "
        f"injected DM {doc['dm']:g} at t={doc['time_s']:g}s; recovery "
        "is checked after the job completes and ingests "
        "(`peasoup-campaign sentinel --check`, or the "
        "sentinel_unrecovered alert)"
    )
    return 0


def _tenant_audit(workdir: str, action: str, tenant: str, **extra) -> None:
    """Journal a tenant admin action to queue/submissions.jsonl — the
    same append-only audit trail as submissions, so `who changed what
    when` reads off one file. Secrets never land in the journal: token
    rotation records only a correlation suffix."""
    import time as _time

    from ..campaign.ingest import append_submission

    entry = {
        "t_unix": round(_time.time(), 3),
        "via": "cli",
        "kind": "tenant_admin",
        "action": action,
        "tenant": tenant,
    }
    entry.update(extra)
    append_submission(workdir, entry)


def _cmd_tenant(args) -> int:
    import dataclasses

    from ..campaign.tenants import Tenant, TenantRegistry, throttle_map

    reg = TenantRegistry(args.workdir)
    if args.action != "list" and not args.name:
        print(f"tenant {args.action}: a tenant name is required",
              file=sys.stderr)
        return 2
    if args.action == "add":
        try:
            t = reg.create(Tenant(
                name=args.name,
                token=args.token,
                max_queued=args.max_queued or 0,
                max_running=args.max_running or 0,
                device_seconds=args.device_seconds or 0.0,
                window_s=(
                    3600.0 if args.window_s is None else args.window_s
                ),
                priority_max=args.priority_max,
                watch_dir=args.watch_dir or "",
            ))
        except FileExistsError:
            print(f"tenant add: {args.name!r} already exists",
                  file=sys.stderr)
            return 1
        except ValueError as exc:
            print(f"tenant add: {exc}", file=sys.stderr)
            return 2
        print(f"tenant {t.name} created; token: {t.token}")
        return 0
    if args.action == "rotate-token":
        import uuid

        t = reg.get(args.name)
        if t is None:
            print(f"tenant rotate-token: no such tenant {args.name!r}",
                  file=sys.stderr)
            return 1
        new_token = args.token or uuid.uuid4().hex
        reg.update(dataclasses.replace(t, token=new_token))
        # the registry record is the single source of truth for
        # by_token, so the old secret stops authenticating the moment
        # the atomic rewrite lands
        _tenant_audit(
            args.workdir, "rotate-token", t.name,
            token_suffix=new_token[-6:],
        )
        print(f"tenant {t.name} token rotated; new token: {new_token}")
        print("(the previous token is invalid immediately)")
        return 0
    if args.action == "set-quota":
        t = reg.get(args.name)
        if t is None:
            print(f"tenant set-quota: no such tenant {args.name!r}",
                  file=sys.stderr)
            return 1
        changes: dict = {}
        if args.max_queued is not None:
            changes["max_queued"] = int(args.max_queued)
        if args.max_running is not None:
            changes["max_running"] = int(args.max_running)
        if args.device_seconds is not None:
            changes["device_seconds"] = float(args.device_seconds)
        if args.window_s is not None:
            changes["window_s"] = float(args.window_s)
        if args.priority_max is not None:
            changes["priority_max"] = (
                None if args.priority_max < 0 else int(args.priority_max)
            )
        if args.watch_dir is not None:
            changes["watch_dir"] = args.watch_dir
        if not changes:
            print("tenant set-quota: no quota flags given (nothing to "
                  "change)", file=sys.stderr)
            return 2
        reg.update(dataclasses.replace(t, **changes))
        _tenant_audit(args.workdir, "set-quota", t.name, changes=changes)
        print(f"tenant {t.name} quota updated: " + ", ".join(
            f"{k}={v}" for k, v in sorted(changes.items())
        ))
        return 0
    if args.action == "remove":
        if reg.remove(args.name):
            print(f"tenant {args.name} removed (historical usage and "
                  "done records keep their stamp)")
            return 0
        print(f"tenant remove: no such tenant {args.name!r}",
              file=sys.stderr)
        return 1
    if args.action == "show":
        t = reg.get(args.name)
        if t is None:
            print(f"tenant show: no such tenant {args.name!r}",
                  file=sys.stderr)
            return 1
        print(json.dumps(t.to_doc(), indent=2))
        return 0
    throttles = throttle_map(args.workdir)
    entries = reg.entries()
    if not entries:
        print("no tenants (peasoup-campaign tenant add <name> ...)")
        return 0
    for t in entries:
        quota = ", ".join(
            f"{k}={v}" for k, v in sorted(t.quota_doc().items())
            if v not in (0, 0.0, None) or k == "window_s"
        )
        line = f"{t.name}  {quota or 'unlimited'}"
        thr = throttles.get(t.name)
        if thr:
            line += f"  *** THROTTLED: {thr['reason']} ***"
        print(line)
    return 0


def _cmd_submit(args) -> int:
    from ..campaign.ingest import submit_observation

    entry = submit_observation(
        args.workdir,
        args.tenant,
        args.input,
        priority=args.priority,
        config=_load_config_arg(args.config) or None,
        pipeline=args.pipeline,
        via="cli",
    )
    if entry["accepted"]:
        print(f"submitted {entry['job_id']} for tenant {args.tenant}"
              + ("  (priority clamped to tenant ceiling)"
                 if entry.get("priority_capped") else ""))
        return 0
    print(f"submit rejected: {entry['reason']}", file=sys.stderr)
    return 1


def _cmd_ingest_folder(args) -> int:
    from ..campaign.ingest import ingest_watch_folders

    t0 = time.perf_counter()
    while True:
        entries = ingest_watch_folders(
            args.workdir, pipeline=args.pipeline
        )
        for e in entries:
            state = "accepted" if e["accepted"] else (
                f"rejected ({e['reason']})"
            )
            print(f"ingest-folder: {e['tenant']}: {e['input']} {state}")
        if not args.poll:
            return 0
        if (
            args.max_runtime is not None
            and time.perf_counter() - t0 >= args.max_runtime
        ):
            return 0
        time.sleep(args.poll)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return {
        "run": _cmd_run,
        "status": _cmd_status,
        "retry": _cmd_retry,
        "quarantine-list": _cmd_quarantine_list,
        "ingest": _cmd_ingest,
        "preempt": _cmd_preempt,
        "autoscale": _cmd_autoscale,
        "metrics": _cmd_metrics,
        "trace": _cmd_trace,
        "profile": _cmd_profile,
        "prune": _cmd_prune,
        "serve": _cmd_serve,
        "alerts": _cmd_alerts,
        "sentinel": _cmd_sentinel,
        "tenant": _cmd_tenant,
        "submit": _cmd_submit,
        "ingest-folder": _cmd_ingest_folder,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
