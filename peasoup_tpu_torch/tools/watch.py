"""Tail/render a live ``status.json`` heartbeat or a campaign rollup.

    python -m peasoup_tpu_torch.tools.watch run/status.json
    python -m peasoup_tpu_torch.tools.watch run/status.json --once
    python -m peasoup_tpu_torch.tools.watch campaign_dir/          # rollup
    python -m peasoup_tpu_torch.tools.watch campaign_dir/campaign_status.json

The heartbeat (obs/heartbeat.py, enabled per run with
``--status-json``) atomically rewrites the snapshot every few seconds;
this tool polls it and prints one compact line-block per NEW snapshot
(keyed on ``seq``), so it composes with ``tee``/log collectors instead
of fighting the terminal. It exits when the run reports ``done`` (or
immediately with ``--once``), and flags a heartbeat whose
``updated_unix`` has gone stale — the difference between a run that is
slow and a process that is gone.

Campaign mode: pointed at a campaign directory (or its
``campaign_status.json``) it renders the survey-level rollup instead —
queue depths, the running jobs with each one's live stage/progress,
throughput/ETA and the failure/quarantine tallies (the file is
rewritten by every worker after each state transition; see
campaign/rollup.py). The two snapshot kinds are told apart
by their ``schema`` key, so one watch invocation works on both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _bar(frac: float, width: int = 24) -> str:
    filled = int(round(max(0.0, min(1.0, frac)) * width))
    return "#" * filled + "." * (width - filled)


def _fmt_s(v) -> str:
    return f"{v * 1e3:.0f}ms" if isinstance(v, (int, float)) else "-"


def render_streaming(sec: dict) -> list[str]:
    """Lines for a status snapshot's ``streaming`` section (written by
    stream/driver.py; schema-dispatched on the key like
    the campaign rollup view)."""
    lines = []
    rate = sec.get("input_rate_sps")
    bits = [
        f"  stream: chunk {sec.get('chunks_done', 0)}  "
        f"triggers={sec.get('triggers', 0)}  "
        f"events={sec.get('events', 0)}"
    ]
    if rate:
        bits.append(f"in {rate:,.0f} samp/s")
    lines.append("  ".join(bits))
    depth = sec.get("queue_depth_blocks")
    if depth is not None:
        lines.append(
            f"  queue {depth}/{sec.get('queue_capacity_blocks', '?')} "
            f"blocks ({sec.get('policy', '?')})  "
            f"{sec.get('chunks_behind', 0):g} chunks behind real-time"
        )
    lat = sec.get("latency_s") or {}
    slo = lat.get("slo")
    misses = lat.get("misses", 0)
    line = (
        f"  latency p50 {_fmt_s(lat.get('p50'))}  "
        f"p95 {_fmt_s(lat.get('p95'))}  "
        f"max {_fmt_s(lat.get('max'))}"
        + (f"  SLO {_fmt_s(slo)}" if slo is not None else "")
    )
    if misses:
        line += f"  *** {misses} SLO MISS{'ES' if misses > 1 else ''} ***"
    lines.append(line)
    drops = sec.get("drops") or {}
    dropped = drops.get("blocks", 0)
    gaps = sec.get("gap_samples", 0)
    if dropped or gaps:
        lines.append(
            f"  *** DROPPED {dropped} blocks "
            f"({drops.get('samples', 0)} samples); "
            f"{gaps} samples zero-filled ***"
        )
    steady = sec.get("jit_programs_steady", 0)
    if steady:
        lines.append(
            f"  *** {steady} steady-state recompile(s): a shape leaked ***"
        )
    return lines


def render_resilience(sec: dict) -> list[str]:
    """Lines for a status snapshot's ``resilience`` section (written by
    resilience/stats.py): only what differs from a clean
    run is shown, so a healthy process renders nothing."""
    lines = []

    def _total(table: str) -> int:
        return sum((sec.get(table) or {}).values())

    bits = []
    for table, label in (
        ("retries", "retries"),
        ("recoveries", "recovered"),
        ("degradations", "degradations"),
        ("corrupt_artifacts", "quarantined artifacts"),
    ):
        n = _total(table)
        if n:
            bits.append(f"{label}={n}")
    faults = sec.get("faults_injected") or {}
    if faults:
        bits.append(
            "faults injected: "
            + " ".join(f"{k}x{v}" for k, v in sorted(faults.items()))
        )
    if bits:
        lines.append("  resilience: " + "  ".join(bits))
    crashes = sec.get("thread_crashes") or {}
    if crashes:
        lines.append(
            "  *** DEGRADED: background thread crash(es): "
            + " ".join(f"{k}x{v}" for k, v in sorted(crashes.items()))
            + " ***"
        )
    giveups = sec.get("giveups") or {}
    if giveups:
        lines.append(
            "  *** retry budget exhausted at: "
            + " ".join(f"{k}x{v}" for k, v in sorted(giveups.items()))
            + " ***"
        )
    return lines


def render_sift(sec: dict) -> list[str]:
    """Lines for a status snapshot's ``sift`` section (written by
    sift/service.py): the current pass and whichever
    tallies exist yet."""
    bits = [f"pass={sec.get('stage', '?')}"]
    for key, label in (
        ("observations", "obs"),
        ("periodicity", "periodicity"),
        ("single_pulse", "single-pulse"),
        ("folded", "folded"),
        ("known", "known"),
        ("catalogue", "catalogue"),
        ("n_sp_sources", "repeat-SP"),
    ):
        if sec.get(key) is not None:
            bits.append(f"{label}={sec[key]}")
    return ["  sift: " + "  ".join(bits)]


def render_status(st: dict, stale_after: float = 0.0) -> str:
    """One compact text block for a status snapshot."""
    prog = st.get("progress") or {}
    head = (
        f"run {st.get('run_id', '?')}  "
        f"p{st.get('pid', '?')}@{st.get('hostname', '?')}  "
        f"stage={st.get('stage') or '-'}  "
        f"up {st.get('uptime_s', 0.0):.1f}s  seq={st.get('seq', '?')}"
    )
    lines = [head]
    total = prog.get("total")
    if prog:
        frac = prog.get("frac")
        rate = prog.get("rate_per_s")
        eta = prog.get("eta_s")
        unit = prog.get("unit") or ""
        bits = []
        if frac is not None:
            bits.append(f"[{_bar(frac)}] {frac * 100.0:5.1f}%")
        bits.append(
            f"{prog.get('done', 0):g}"
            + (f"/{total:g}" if total else "")
            + (f" {unit}" if unit else "")
        )
        if rate:
            bits.append(f"{rate:.3g} {unit or 'units'}/s")
        if eta is not None:
            bits.append(f"ETA {eta:.1f}s")
        lines.append("  " + "  ".join(bits))
    mem = (st.get("gauges") or {}).get("memory.peak_bytes")
    if mem:
        lines.append(f"  device memory high-water: {mem / 1e9:.2f} GB")
    if isinstance(st.get("streaming"), dict):
        lines.extend(render_streaming(st["streaming"]))
    if isinstance(st.get("sift"), dict):
        lines.extend(render_sift(st["sift"]))
    if isinstance(st.get("resilience"), dict):
        lines.extend(render_resilience(st["resilience"]))
    if st.get("stalled"):
        lines.append(
            f"  *** STALLED: no progress for "
            f"{st.get('last_progress_age_s', 0.0):.0f}s ***"
        )
    # audit: ignore[PSA006] -- staleness vs an on-disk epoch stamp
    age = time.time() - st.get("updated_unix", time.time())
    if stale_after and age > stale_after:
        lines.append(
            f"  *** heartbeat STALE: last update {age:.0f}s ago — "
            f"process dead or wedged? ***"
        )
    for rec in (st.get("events_tail") or [])[-3:]:
        extra = " ".join(
            f"{k}={v}"
            for k, v in rec.items()
            if k not in ("t", "kind")
        )
        lines.append(
            f"  [{rec.get('t', 0.0):9.3f}s] {rec.get('kind', '?')}  "
            f"{extra}"
        )
    if st.get("done"):
        lines.append("  run complete.")
    return "\n".join(lines) + "\n"


def render_alerts(sec: dict) -> list[str]:
    """Lines for a campaign rollup's ``alerts`` section (written by
    obs/alerts.py via the rollup): active alerts loud,
    resolved as a tally, nothing when the campaign is healthy."""
    lines: list[str] = []
    if sec.get("invalid"):
        return [f"  *** alerts snapshot invalid: {sec['invalid']} ***"]
    firing = sec.get("firing", 0)
    pending = sec.get("pending", 0)
    resolved = sec.get("resolved", 0)
    if firing or pending or resolved:
        lines.append(
            f"  alerts: {firing} firing  {pending} pending  "
            f"{resolved} resolved"
        )
    for a in sec.get("active") or []:
        labels = a.get("labels") or {}
        lbl = " ".join(f"{k}={v}" for k, v in sorted(labels.items()))
        mark = "***" if a.get("state") == "firing" else "  -"
        line = (
            f"  {mark} [{a.get('severity', '?')}] {a.get('rule', '?')}"
            f" ({a.get('state')})"
        )
        if lbl:
            line += f"  {lbl}"
        if a.get("message"):
            line += f": {a['message']}"
        lines.append(line)
    return lines


def render_data_quality(sec: dict) -> list[str]:
    """Lines for a campaign rollup's ``data_quality`` section
    (obs/health.py summaries): baselines + outliers + injection
    sentinel tallies; quiet when there is nothing to say."""
    lines: list[str] = []
    base = sec.get("baselines") or {}
    if base and sec.get("jobs"):
        bits = [f"  data quality over {sec['jobs']} job(s):"]
        for metric, rec in sorted(base.items()):
            bits.append(
                f"{metric} med {rec.get('median', 0):.3g}"
            )
        lines.append("  ".join(bits))
    outliers = sec.get("outliers") or []
    for o in outliers:
        labels = o.get("labels") or {}
        lines.append(
            f"  *** DQ outlier: job {labels.get('job', '?')} "
            f"{labels.get('metric', '?')} z={o.get('value', '?')} ***"
        )
    sent = sec.get("sentinels") or {}
    if sent.get("total"):
        line = (
            f"  sentinels: {sent.get('recovered', 0)} recovered  "
            f"{sent.get('pending', 0)} pending"
        )
        if sent.get("missed"):
            line += f"  *** {sent['missed']} MISSED ***"
        lines.append(line)
    return lines


def render_tenants(
    sec: dict, usage: dict | None = None, alerts: dict | None = None
) -> list[str]:
    """Lines for a campaign rollup's ``tenants`` section: one row per
    tenant (queued/running/throttled, device-seconds vs budget, firing
    alerts), throttled tenants loud.  Tolerant of pre-tenant rollup
    schemas — every field is optional."""
    if not sec:
        return []
    usage = usage or {}
    firing: dict[str, int] = {}
    for a in (alerts or {}).get("active") or []:
        t = (a.get("labels") or {}).get("tenant")
        if t and a.get("state") == "firing":
            firing[t] = firing.get(t, 0) + 1
    lines = [f"  tenants: {len(sec)}"]
    for name in sorted(sec):
        rec = sec[name] if isinstance(sec[name], dict) else {}
        bits = [
            f"    {name}  q={rec.get('queued', 0)}"
            f" run={rec.get('running', 0)}"
            f" thr={rec.get('throttled', 0)}"
            f" done={rec.get('done', 0)}"
        ]
        wdev = rec.get("window_device_s")
        budget = rec.get("device_s_budget")
        if wdev is not None:
            bits.append(
                f"dev-s {wdev:.1f}/{budget:.0f}"
                if budget else f"dev-s {wdev:.1f}"
            )
        u = usage.get(name) or {}
        if u.get("jobs_failed"):
            bits.append(f"failed={u['jobs_failed']}")
        if firing.get(name):
            bits.append(f"{firing[name]} alert(s) firing")
        if rec.get("throttle"):
            bits.append(f"*** THROTTLED: {rec['throttle']} ***")
        lines.append("  ".join(bits))
    return lines


def render_campaign_status(st: dict, stale_after: float = 0.0) -> str:
    """One compact text block for a campaign_status.json rollup."""
    q = st.get("queue") or {}
    total = q.get("total", 0)
    done = q.get("done", 0)
    head = (
        f"campaign {st.get('root', '?')}\n"
        f"  [{_bar(done / total if total else 0.0)}] "
        f"{done}/{total} done  "
        f"running={q.get('running', 0)}  pending={q.get('pending', 0)}"
        f"+{q.get('backoff', 0)} backing off  "
        f"stale={q.get('stale', 0)}  quarantined={q.get('quarantined', 0)}"
    )
    if q.get("throttled"):
        head += f"  throttled={q['throttled']}"
    lines = [head]
    thr = st.get("throughput_jobs_per_s")
    if thr:
        eta = st.get("eta_s")
        lines.append(
            f"  throughput {thr * 3600.0:.3g} jobs/h"
            + (f"  ETA {eta:.0f}s" if eta is not None else "")
        )
    if st.get("candidates_total"):
        lines.append(f"  candidates so far: {st['candidates_total']}")
    fleet = st.get("fleet") or {}
    live = fleet.get("live") or []
    if live:
        lines.append(f"  fleet: {len(live)} worker(s) live")
        per_worker = fleet.get("workers") or {}
        for w in live:
            wid = w.get("worker_id", "?")
            rate = (per_worker.get(wid) or {}).get("jobs_per_h")
            bits = [
                f"    {wid}  host={w.get('hostname', '?')}"
                f"  done={w.get('jobs_done', 0)}"
            ]
            if rate is not None:
                bits.append(f"{rate:.3g} jobs/h")
            if w.get("current_job"):
                bits.append(f"on {w['current_job']}")
            lines.append("  ".join(bits))
    pre = st.get("preemptions") or {}
    if pre.get("jobs") or pre.get("outstanding_requests"):
        lat = pre.get("latency_s") or {}
        bits = [
            f"  preemptions: {pre.get('total', 0)} revoke(s) over "
            f"{pre.get('jobs', 0)} job(s)"
        ]
        if lat.get("mean") is not None:
            bits.append(
                f"latency mean {lat['mean']:.3g}s max {lat['max']:.3g}s"
            )
        if pre.get("outstanding_requests"):
            bits.append(f"{pre['outstanding_requests']} in flight")
        lines.append("  ".join(bits))
    if st.get("gang_jobs"):
        lines.append(f"  gang jobs done: {st['gang_jobs']}")
    scale = st.get("autoscale") or {}
    if scale.get("decisions"):
        last = scale["decisions"][-1]
        ups = sum(1 for d in scale["decisions"] if d.get("action") == "up")
        downs = len(scale["decisions"]) - ups
        lines.append(
            f"  autoscale: {ups} up / {downs} down; last "
            f"{last.get('action')} {last.get('worker_id')} "
            f"({last.get('reason')})"
        )
    if st.get("degraded_jobs"):
        lines.append(
            f"  *** {st['degraded_jobs']} job(s) completed DEGRADED "
            "(OOM fall-through / crashed helper thread) ***"
        )
    if st.get("corrupt_artifact_files"):
        lines.append(
            f"  {st['corrupt_artifact_files']} quarantined *.corrupt "
            "artifact(s) (prune: peasoup-campaign prune --corrupt)"
        )
    if st.get("warmup_total_s") or st.get("tuning_total_s"):
        lines.append(
            f"  warmup {st.get('warmup_total_s', 0.0):.1f}s over "
            f"{st.get('warmup_jobs', 0)} jobs"
            + (
                f"  tuning {st['tuning_total_s']:.1f}s"
                if st.get("tuning_total_s") else ""
            )
        )
    for key, rec in sorted((st.get("warm_buckets") or {}).items()):
        plan = rec.get("plan") or {}
        if plan:
            lines.append(
                f"  bucket {key}: {rec.get('done', 0)} done, plan "
                f"{plan.get('engine', '?')}"
                + (
                    f"(nsub={plan.get('subbands')})"
                    if plan.get("engine") == "subband" else ""
                )
                + f" block={plan.get('dedisp_block', '?')} "
                f"[{plan.get('source', '?')}]"
            )
    if isinstance(st.get("tenants"), dict) and st["tenants"]:
        lines.extend(render_tenants(
            st["tenants"],
            usage=st.get("usage") if isinstance(st.get("usage"), dict)
            else None,
            alerts=st.get("alerts") if isinstance(st.get("alerts"), dict)
            else None,
        ))
    if isinstance(st.get("alerts"), dict):
        lines.extend(render_alerts(st["alerts"]))
    if isinstance(st.get("data_quality"), dict):
        lines.extend(render_data_quality(st["data_quality"]))
    if isinstance(st.get("resilience"), dict) and st["resilience"]:
        lines.extend(render_resilience(st["resilience"]))
    for rj in st.get("running_jobs") or []:
        prog = rj.get("progress") or {}
        frac = prog.get("frac")
        bits = [f"  run {rj.get('job_id')}  "
                f"worker={rj.get('worker_id', '?')}  "
                f"stage={rj.get('stage') or '-'}"]
        if frac is not None:
            bits.append(f"{frac * 100.0:5.1f}%")
        if rj.get("stalled"):
            bits.append("*** STALLED ***")
        lines.append("  ".join(bits))
    for fl in st.get("failures") or []:
        lines.append(
            f"  retrying {fl.get('job_id')} (attempt {fl.get('attempts')},"
            f" in {fl.get('retry_in_s', 0):.0f}s): {fl.get('last_error')}"
        )
    for ql in st.get("quarantined") or []:
        lines.append(
            f"  QUARANTINED {ql.get('job_id')} after "
            f"{ql.get('attempts')} attempts: {ql.get('last_error')}"
        )
    # audit: ignore[PSA006] -- staleness vs an on-disk epoch stamp
    age = time.time() - st.get("updated_unix", time.time())
    if stale_after and age > stale_after:
        lines.append(
            f"  *** rollup STALE: last update {age:.0f}s ago — "
            f"no worker alive? ***"
        )
    if st.get("done"):
        lines.append("  campaign complete.")
    return "\n".join(lines) + "\n"


_SPARK = " ▁▂▃▄▅▆▇█"


def _sparkline_row(values: list[float | None], width: int) -> str:
    """Unicode sparkline over per-bin values (None = no data)."""
    present = [v for v in values if v is not None]
    if not present:
        return "·" * width
    lo, hi = min(present), max(present)
    span = (hi - lo) or 1.0
    out = []
    for v in values:
        if v is None:
            out.append("·")
        else:
            idx = 1 + int((v - lo) / span * (len(_SPARK) - 2))
            out.append(_SPARK[min(len(_SPARK) - 1, idx)])
    return "".join(out)


def _binned(
    recs: list[dict], t_lo: float, t_hi: float, width: int,
    reduce: str = "last",
) -> list[float | None]:
    """Bin time-ordered samples into ``width`` slots. ``reduce``:
    'last' (gauge semantics), 'sum' (histogram counts), 'max'."""
    bins: list[list[float]] = [[] for _ in range(width)]
    span = (t_hi - t_lo) or 1.0
    for rec in recs:
        t = float(rec.get("t", 0.0))
        if t < t_lo or t > t_hi:
            continue
        i = min(width - 1, int((t - t_lo) / span * width))
        bins[i].append(float(rec.get("value", 0.0)))
    out: list[float | None] = []
    for b in bins:
        if not b:
            out.append(None)
        elif reduce == "sum":
            out.append(sum(b))
        elif reduce == "max":
            out.append(max(b))
        else:
            out.append(b[-1])
    return out


def render_metrics_history(
    samples_by_source: dict, width: int = 48, window_s: float = 3600.0
) -> str:
    """The historical timeline view over a campaign's per-worker
    time-series files (obs/metrics.py): queue depth, completion and
    preemption-latency series rendered as sparklines — "what happened
    over the last hour" without re-running the soak."""
    from ..obs.metrics import series

    all_t = [
        float(r.get("t", 0.0))
        for recs in samples_by_source.values()
        for r in recs
    ]
    if not all_t:
        return "no metrics samples found\n"
    t_hi = max(all_t)
    t_lo = max(min(all_t), t_hi - window_s)
    span = max(1.0, t_hi - t_lo)
    lines = [
        f"metrics history: {len(samples_by_source)} worker(s), "
        f"{len(all_t)} samples over {span:.0f}s"
    ]

    def _row(label: str, values: list, unit: str = "") -> None:
        present = [v for v in values if v is not None]
        if not present:
            return
        lines.append(
            f"  {label:<26} {_sparkline_row(values, width)}  "
            f"min {min(present):g}  max {max(present):g}{unit}"
        )

    for state in ("pending", "running", "done"):
        recs = [
            r
            for r in series(samples_by_source, "queue_depth", "gauge")
            if (r.get("labels") or {}).get("state") == state
        ]
        _row(f"queue depth [{state}]", _binned(recs, t_lo, t_hi, width, "max"))
    _row(
        "jobs done (fleet)",
        _binned(
            series(samples_by_source, "jobs_done_total", "counter"),
            t_lo, t_hi, width, "max",
        ),
    )
    lat = series(
        samples_by_source, "preemption_latency_seconds", "hist"
    )
    _row(
        "preempt latency (s)", _binned(lat, t_lo, t_hi, width, "max"),
    )
    _row(
        "claim wait (s)",
        _binned(
            series(samples_by_source, "claim_wait_seconds", "hist"),
            t_lo, t_hi, width, "max",
        ),
    )
    _row(
        "device mem peak (GB)",
        [
            (v / 1e9 if v is not None else None)
            for v in _binned(
                series(
                    samples_by_source, "device_memory_peak_bytes",
                    "gauge",
                ),
                t_lo, t_hi, width, "max",
            )
        ],
    )
    if len(lines) == 1:
        lines.append("  (no renderable series yet)")
    return "\n".join(lines) + "\n"


def resolve_status_path(path: str) -> str:
    """A directory argument resolves to the campaign rollup inside it
    when one exists (else the single-run status.json)."""
    if os.path.isdir(path):
        camp = os.path.join(path, "campaign_status.json")
        if os.path.exists(camp):
            return camp
        return os.path.join(path, "status.json")
    return path


def _read(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None  # not yet written, or mid-replace on exotic fs


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="peasoup-watch",
        description="Tail/render a live status.json heartbeat",
    )
    p.add_argument(
        "status",
        help="path to a run's status.json, a campaign_status.json, or "
        "a campaign directory",
    )
    p.add_argument(
        "--interval", type=float, default=1.0,
        help="poll interval in seconds (default 1)",
    )
    p.add_argument(
        "--once", action="store_true",
        help="render the current snapshot once and exit",
    )
    p.add_argument(
        "--timeout", type=float, default=0.0,
        help="give up after this many seconds without a snapshot "
        "appearing (default: wait forever)",
    )
    p.add_argument(
        "--history", action="store_true",
        help="render the campaign's historical metrics timeline "
        "(queue depth / throughput / preemption latency sparklines "
        "from queue/workers/*.metrics.jsonl) and exit",
    )
    p.add_argument(
        "--window", type=float, default=3600.0,
        help="with --history: how many trailing seconds to render "
        "(default 3600)",
    )
    args = p.parse_args(argv)

    if args.history:
        from ..obs.metrics import fleet_samples

        root = (
            args.status if os.path.isdir(args.status)
            else os.path.dirname(os.path.abspath(args.status))
        )
        samples = fleet_samples(root)
        if not samples:
            sys.stderr.write(
                f"no metrics files under {root}/queue/workers/\n"
            )
            return 1
        sys.stdout.write(
            render_metrics_history(samples, window_s=args.window)
        )
        return 0

    t0 = time.monotonic()
    last_seq = None
    stale_after = max(10.0, 5 * args.interval)
    path = resolve_status_path(args.status)
    while True:
        st = _read(path)
        if st is None:
            # a campaign rollup may appear after the first worker
            # starts — re-resolve directory arguments while waiting
            path = resolve_status_path(args.status)
            if args.once or (
                args.timeout and time.monotonic() - t0 > args.timeout
            ):
                sys.stderr.write(f"no status at {path}\n")
                return 1
            time.sleep(args.interval)
            continue
        campaign = st.get("schema") == "peasoup_tpu.campaign_status"
        # campaign rollups have no seq: key change detection on the
        # writer's timestamp instead
        seq = st.get("updated_unix") if campaign else st.get("seq")
        if seq != last_seq or args.once:
            last_seq = seq
            render = render_campaign_status if campaign else render_status
            sys.stdout.write(render(st, stale_after=stale_after))
            sys.stdout.flush()
        if args.once or st.get("done"):
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    raise SystemExit(main())
