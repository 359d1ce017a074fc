"""Render, diff, or merge ``telemetry.json`` run manifests: the port's
copy of the JAX package's tools/report.py, over the manifests either
package writes (obs/telemetry.py keeps the JAX schema name and version).

    python -m peasoup_tpu_torch.tools.report run/telemetry.json
    python -m peasoup_tpu_torch.tools.report before.json after.json  # diff
    python -m peasoup_tpu_torch.tools.report --merge telemetry.proc*.json \\
        -o merged.json                                               # merge

One manifest renders the stage-timer table (the superset of
overview.xml's <execution_times>), counters/gauges (candidate counts
per stage, memory high-water marks, kernel launches), compile stats, the
adaptive-event log, and — when the run was captured with
``--capture-device-trace`` — the per-scope device-time/bytes table
from tools/scope_trace.py. Two manifests render aligned timers and
counters with absolute and relative deltas.

``--merge`` combines the per-process manifest shards a multi-process run
writes (``telemetry.procN.json``, tagged with ``process_index`` /
``hostname``) into ONE merged manifest carrying per-host summaries and
straggler/imbalance statistics: per-stage time spread across hosts
with slowest-host attribution, and wall-clock imbalance. The merged
manifest is itself schema-valid, so it renders and diffs like any
other.

Readers here must tolerate manifests from OLDER schema versions —
every key newer than v1 is accessed with ``.get()`` so a legacy
manifest renders instead of KeyError'ing. The platform line names the
framework the manifest records (``jax`` for the JAX package's, ``torch``
for the port's); everything else renders as the JAX tool renders it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..obs.telemetry import (
    MANIFEST_SCHEMA,
    MANIFEST_VERSION,
    load_manifest,
)


def _fmt_val(v) -> str:
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _section(title: str) -> list[str]:
    return ["", title, "-" * len(title)]


def render(man: dict, max_events: int = 30) -> str:
    """Pretty-print one manifest (plain, aborted, or merged)."""
    lines = [
        f"telemetry manifest v{man.get('version', '?')}"
        f"  run_id={man.get('run_id', '?')}",
        f"  created: {time.strftime('%Y-%m-%d %H:%M:%SZ', time.gmtime(man.get('created_unix', 0)))}"
        f"  host={man.get('hostname', '?')}  pid={man.get('pid', '?')}",
    ]
    if man.get("process_count", 1) > 1:
        lines.append(
            f"  shard: process {man.get('process_index', 0)}/"
            f"{man.get('process_count', 1)}"
        )
    if man.get("aborted"):
        lines.append(
            f"  ABORTED ({man.get('abort_reason', '?')}) at stage "
            f"{man.get('stage_at_abort', '?')} — partial manifest"
        )
    plat = man.get("platform") or {}
    if plat:
        devs = plat.get("devices") or []
        framework = "torch" if "torch" in plat and "jax" not in plat else "jax"
        lines.append(
            f"  platform: {framework} {plat.get(framework, '?')} "
            f"backend={plat.get('backend', '?')} "
            f"devices={len(devs)} "
            f"process {plat.get('process_index', 0)}/"
            f"{plat.get('process_count', 1)}"
        )
    ctx = man.get("context") or {}
    for k in sorted(ctx):
        lines.append(f"  {k}: {_fmt_val(ctx[k])}")

    if man.get("merged"):
        lines += _render_merged_sections(man)

    timers = man.get("timers") or {}
    if timers:
        lines += _section("stage timers")
        width = max(len(k) for k in timers)
        for k, v in sorted(timers.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:<{width}}  {v:10.3f} s")

    for name in ("counters", "gauges"):
        table = man.get(name) or {}
        if table:
            lines += _section(name)
            width = max(len(k) for k in table)
            for k in sorted(table):
                lines.append(f"  {k:<{width}}  {_fmt_val(table[k])}")

    jit = man.get("jit") or {}
    if jit:
        lines += _section("jit compile/lowering")
        width = max(len(k) for k in jit)
        for k in sorted(jit):
            st = jit[k]
            lines.append(
                f"  {k:<{width}}  {st.get('count', 0):5d} x  "
                f"{st.get('seconds', 0.0):8.3f} s"
            )

    events = man.get("events") or []
    if events:
        lines += _section(f"adaptive events ({len(events)})")
        for rec in events[:max_events]:
            extra = " ".join(
                f"{k}={_fmt_val(v)}"
                for k, v in rec.items()
                if k not in ("t", "kind")
            )
            lines.append(
                f"  [{rec.get('t', 0.0):10.3f}s] {rec.get('kind', '?')}"
                f"  {extra}"
            )
        if len(events) > max_events:
            lines.append(f"  ... {len(events) - max_events} more")

    dt = man.get("device_trace")
    if dt:
        lines += _section("device trace (per-scope attribution)")
        lines.append(f"  device busy: {dt.get('device_s', 0.0) * 1e3:.1f} ms")
        phases = dt.get("phases") or {}
        for k in sorted(phases, key=lambda k: -phases[k]):
            lines.append(f"    phase {k:<8} {phases[k] * 1e3:10.1f} ms")
        for row in dt.get("table") or []:
            lines.append(
                f"    {row['seconds'] * 1e3:10.1f} ms  "
                f"{row['gigabytes']:8.2f} GB  {row['scope']}"
            )
    return "\n".join(lines) + "\n"


def _render_merged_sections(man: dict) -> list[str]:
    hosts = man.get("hosts") or []
    lines = _section(f"hosts ({len(hosts)})")
    for h in hosts:
        flags = "  ABORTED" if h.get("aborted") else ""
        lines.append(
            f"  p{h.get('process_index', 0):<3d} "
            f"{h.get('hostname', '?'):<20} "
            f"{h.get('duration_s', 0.0):10.3f} s  "
            f"run_id={h.get('run_id', '?')}{flags}"
        )
    strag = (man.get("straggler") or {}).get("timers") or {}
    if strag:
        lines += _section("per-host stage-time spread (straggler view)")
        width = max(len(k) for k in strag)
        lines.append(
            f"  {'stage':<{width}}  {'min':>9}  {'max':>9}  "
            f"{'spread':>9}  slowest"
        )
        for k, st in sorted(
            strag.items(), key=lambda kv: -kv[1].get("spread", 0.0)
        ):
            lines.append(
                f"  {k:<{width}}  {st.get('min', 0.0):8.3f}s  "
                f"{st.get('max', 0.0):8.3f}s  "
                f"{st.get('spread', 0.0):8.3f}s  "
                f"p{st.get('slowest', {}).get('process_index', '?')}"
                f"@{st.get('slowest', {}).get('hostname', '?')}"
            )
    imb = (man.get("straggler") or {}).get("imbalance")
    if imb:
        lines.append(
            f"  wall-clock imbalance: slowest/mean = "
            f"{imb.get('ratio', 1.0):.3f} "
            f"(slowest p{imb.get('slowest', {}).get('process_index', '?')}"
            f"@{imb.get('slowest', {}).get('hostname', '?')})"
        )
    return lines


def render_timeline(man: dict, width: int = 60) -> str:
    """Historical timeline view of one run: the ``stage`` transition
    events rendered as a gantt over the run's wall clock, with the
    remaining adaptive events as markers — "what was this run doing
    when" from the manifest alone (no live heartbeat needed)."""
    events = man.get("events") or []
    duration = float(man.get("duration_s") or 0.0)
    stages: list[tuple[str, float, float]] = []  # (name, t0, t1)
    cur: tuple[str, float] | None = None
    for rec in events:
        if rec.get("kind") != "stage":
            continue
        t = float(rec.get("t", 0.0))
        if cur is not None:
            stages.append((cur[0], cur[1], t))
        cur = (str(rec.get("name", "?")), t)
    if cur is not None:
        stages.append((cur[0], cur[1], max(duration, cur[1])))
    if not stages:
        return (
            "no stage events in this manifest (older writer?) — "
            "nothing to draw\n"
        )
    total = max(duration, stages[-1][2]) or 1.0
    lines = [
        f"timeline: run {man.get('run_id', '?')}  "
        f"{total:.3f}s wall  ({len(stages)} stage segments)",
        f"  {'stage':<16} 0s{' ' * (width - 6)}{total:8.2f}s",
    ]
    for name, t0, t1 in stages:
        lo = int(t0 / total * width)
        hi = max(lo + 1, int(t1 / total * width))
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        lines.append(f"  {name:<16} |{bar}|  {t1 - t0:8.3f}s")
    marks = [" "] * width
    other = [r for r in events if r.get("kind") != "stage"]
    for rec in other:
        i = min(width - 1, int(float(rec.get("t", 0.0)) / total * width))
        marks[i] = "*"
    if other:
        lines.append(f"  {'events':<16} |{''.join(marks)}|  ({len(other)})")
    return "\n".join(lines) + "\n"


def diff(a: dict, b: dict, max_events: int = 0) -> str:
    """Aligned comparison of two manifests (timers + counters/gauges):
    the 'why did this BENCH number move' view."""
    lines = [
        f"diff: {a.get('run_id', '?')}  ->  {b.get('run_id', '?')}",
        f"  duration: {a.get('duration_s', 0.0):.3f} s -> "
        f"{b.get('duration_s', 0.0):.3f} s",
    ]
    for name in ("timers", "counters", "gauges"):
        ta, tb = a.get(name) or {}, b.get(name) or {}
        keys = sorted(set(ta) | set(tb))
        if not keys:
            continue
        lines += _section(name)
        width = max(len(k) for k in keys)
        for k in keys:
            va, vb = ta.get(k), tb.get(k)
            if va is None:
                lines.append(f"  {k:<{width}}  (new) -> {_fmt_val(vb)}")
            elif vb is None:
                lines.append(f"  {k:<{width}}  {_fmt_val(va)} -> (gone)")
            else:
                delta = vb - va
                pct = f" ({delta / va * 100.0:+.1f}%)" if va else ""
                lines.append(
                    f"  {k:<{width}}  {_fmt_val(va)} -> {_fmt_val(vb)}"
                    f"  [{delta:+.6g}{pct}]"
                )
    ea, eb = len(a.get("events") or []), len(b.get("events") or [])
    lines += _section("events")
    lines.append(f"  count: {ea} -> {eb}")
    return "\n".join(lines) + "\n"


def merge_manifests(shards: list[dict]) -> dict:
    """Combine per-host manifest shards into one merged manifest with
    straggler/imbalance statistics.

    Merge semantics: ``timers``/``gauges`` take the MAX across hosts
    (a stage is only done when the slowest host is done; gauges are
    high-water marks), ``counters`` SUM (work done), events concatenate
    tagged with their host. The ``straggler`` section carries per-stage
    min/max/mean/spread with slowest-host attribution — the question a
    merged view exists to answer is "which host is dragging the run".
    """
    if not shards:
        raise ValueError("no shards to merge")
    shards = sorted(
        shards,
        key=lambda m: (
            m.get(
                "process_index",
                (m.get("platform") or {}).get("process_index", 0),
            ),
            m.get("hostname", ""),
        ),
    )
    hosts = []
    for man in shards:
        # keep only numeric timers: a malformed shard value must not
        # poison the straggler math or the merged manifest's schema
        timers = {
            k: v
            for k, v in (man.get("timers") or {}).items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        host = {
            "process_index": man.get(
                "process_index",
                (man.get("platform") or {}).get("process_index", 0),
            ),
            "hostname": man.get("hostname", "?"),
            "pid": man.get("pid"),
            "run_id": man.get("run_id", "?"),
            "aborted": bool(man.get("aborted", False)),
            "n_events": len(man.get("events") or []),
            "timers": timers,
        }
        # duration is OPTIONAL: an aborted/partial shard without one
        # must not enter the imbalance ranking as a phantom 0.0 s
        # "fastest host"
        if isinstance(man.get("duration_s"), (int, float)):
            host["duration_s"] = float(man["duration_s"])
        hosts.append(host)

    def _host_ref(h: dict) -> dict:
        return {
            "process_index": h["process_index"],
            "hostname": h["hostname"],
        }

    timer_keys = sorted({k for h in hosts for k in h["timers"]})
    straggler_timers: dict[str, dict] = {}
    merged_timers: dict[str, float] = {}
    for k in timer_keys:
        # a shard can be missing a stage entirely (aborted before
        # reaching it, older writer, partial manifest) or carry a
        # non-numeric value: SKIP those hosts rather than KeyError or
        # rank a phantom 0.0 as the fastest host; the entry records who
        # was missing so the straggler view stays honest
        vals = [
            (h["timers"][k], h)
            for h in hosts
            if isinstance(h["timers"].get(k), (int, float))
            and not isinstance(h["timers"].get(k), bool)
        ]
        if not vals:
            continue
        vmin, vmax = (
            min(v for v, _ in vals),
            max(v for v, _ in vals),
        )
        mean = sum(v for v, _ in vals) / len(vals)
        slowest = max(vals, key=lambda vh: vh[0])[1]
        merged_timers[k] = vmax
        if len(vals) > 1:
            straggler_timers[k] = {
                "min": vmin,
                "max": vmax,
                "mean": mean,
                "spread": vmax - vmin,
                "spread_frac": (vmax - vmin) / mean if mean else 0.0,
                "n_hosts": len(vals),
                "slowest": _host_ref(slowest),
            }
            if len(vals) < len(hosts):
                present = {id(h) for _, h in vals}
                straggler_timers[k]["missing"] = [
                    _host_ref(h) for h in hosts if id(h) not in present
                ]

    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    for man in shards:
        for k, v in (man.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in (man.get("gauges") or {}).items():
            gauges[k] = max(gauges.get(k, v), v)

    events = []
    for man, h in zip(shards, hosts):
        for rec in man.get("events") or []:
            events.append({**rec, "process_index": h["process_index"]})
    events.sort(key=lambda r: r.get("t", 0.0))

    durations = [
        (h["duration_s"], h) for h in hosts if "duration_s" in h
    ]
    if durations:
        dmax = max(v for v, _ in durations)
        dmean = sum(v for v, _ in durations) / len(durations)
        slowest_host = max(durations, key=lambda vh: vh[0])[1]
    else:  # every shard partial: no imbalance ranking to compute
        dmax = dmean = 0.0
        slowest_host = hosts[0]

    merged = {
        "schema": MANIFEST_SCHEMA,
        "version": MANIFEST_VERSION,
        "run_id": shards[0].get("run_id", "?"),
        "created_unix": min(
            m.get("created_unix", 0.0) for m in shards
        ),
        "duration_s": dmax,
        "merged": True,
        "n_hosts": len(hosts),
        "process_count": max(
            m.get("process_count", len(hosts)) for m in shards
        ),
        "context": shards[0].get("context") or {},
        "hosts": hosts,
        "timers": merged_timers,
        "counters": {k: counters[k] for k in sorted(counters)},
        "gauges": {k: gauges[k] for k in sorted(gauges)},
        "jit": {},
        "events": events,
        "device_trace": None,
        "straggler": {
            "timers": straggler_timers,
            "imbalance": {
                "max_s": dmax,
                "mean_s": dmean,
                "ratio": dmax / dmean if dmean else 1.0,
                "slowest": _host_ref(slowest_host),
            },
        },
    }
    if any(h["aborted"] for h in hosts):
        merged["aborted"] = True
        merged["abort_reason"] = "; ".join(
            f"p{h['process_index']}" for h in hosts if h["aborted"]
        )
    return merged


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="peasoup-report",
        description="Render, diff, or merge telemetry.json run manifests",
    )
    p.add_argument(
        "manifests", nargs="+",
        help="one manifest to render, two to diff (old new), or N "
        "per-host shards with --merge",
    )
    p.add_argument(
        "--events", type=int, default=30,
        help="max adaptive events to render (default 30)",
    )
    p.add_argument(
        "--merge", action="store_true",
        help="combine per-host manifest shards (telemetry.procN.json) "
        "into one merged manifest with straggler statistics",
    )
    p.add_argument(
        "-o", "--output", default=None,
        help="with --merge: write the merged manifest JSON here "
        "(still renders the summary to stdout)",
    )
    p.add_argument(
        "--timeline", action="store_true",
        help="render one manifest's stage transitions as a wall-clock "
        "gantt (the historical what-was-it-doing-when view)",
    )
    args = p.parse_args(argv)
    if args.timeline:
        if len(args.manifests) != 1:
            p.error("--timeline expects exactly one manifest")
        sys.stdout.write(render_timeline(load_manifest(args.manifests[0])))
        return 0
    if args.merge:
        if len(args.manifests) < 2:
            p.error("--merge expects at least two per-host shards")
        merged = merge_manifests(
            [load_manifest(m) for m in args.manifests]
        )
        if args.output:
            with open(args.output, "w") as f:
                json.dump(merged, f, indent=2)
                f.write("\n")
        sys.stdout.write(render(merged, max_events=args.events))
        return 0
    if len(args.manifests) > 2:
        p.error("expected one manifest (render) or two (diff)")
    mans = [load_manifest(m) for m in args.manifests]
    if len(mans) == 1:
        sys.stdout.write(render(mans[0], max_events=args.events))
    else:
        sys.stdout.write(diff(mans[0], mans[1]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
