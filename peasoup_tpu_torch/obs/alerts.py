"""Declarative SLO/alerting engine over the fleet metrics series (the
port's copy of the JAX package's obs/alerts.py, the same rules, snapshot
and journal).

The fleet records raw time series (obs/metrics.py); nothing else
*interprets* them — an operator had to eyeball sparklines to notice a
stalled worker or a failure burst. This module is the interpretation
layer: a small declarative rule engine evaluated over the existing
``MetricsRecorder`` files, with a Prometheus-shaped alert lifecycle.

Rule kinds (each rule is a plain dict — the grammar is data, so the
check gate and tests can inject short windows):

- ``threshold`` — select a scalar from one metric over a trailing
  window (``last``/``sum``/``max``/``min`` over gauges, ``increase``/
  ``rate`` over cumulative counters, ``p50``/``p95``/``p99``/``max``
  over raw histogram observations) and compare against a bound, with
  an optional ``for_s`` pending hold.
- ``absence`` — "no sample of metric M for live worker X within
  ``window_s``" (the heartbeat-stall shape; one alert per worker).
- ``burn_rate`` — multi-window error-budget burn over an SLO
  objective: the bad/total counter ratio must exceed ``factor`` times
  the budget in EVERY window to fire (the fast window catches the
  spike, the slow window suppresses blips).
- ``data_quality`` / ``sentinel`` — finding-driven: the conditions are
  computed by :mod:`peasoup_tpu_torch.obs.health` (median/MAD z-score
  outliers, unrecovered synthetic injections) and passed in; the
  engine owns only the lifecycle.

Lifecycle per (rule, label set): inactive → ``pending`` → ``firing``
→ ``resolved`` (kept ``RESOLVED_RETENTION_S`` then dropped). Every
transition is appended to ``<root>/queue/alerts.jsonl`` (append-only,
like the recorders) and the current state is atomically rewritten to
``<root>/queue/alerts.json`` (tmp + ``os.replace``) — the snapshot the
portal, rollup and ``watch`` read. Concurrent evaluators (several
workers share one campaign) serialise through an ``O_CREAT|O_EXCL``
lock file with stale takeover; a loser skips the round and returns the
current snapshot — alerting is level-based, the next round catches up.

Counters are written as running totals carried across file rotation
(obs/metrics.py), so windowed ``increase`` stays monotone through a
rotation and a resolved alert does not re-fire from replayed deltas; a
process restart (total resets to zero) is treated as a counter reset,
Prometheus-style.

Evaluation must never fail the caller (the runner evaluates beside its
status rollup): :func:`evaluate_campaign` traps everything and returns
the last good snapshot.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
import uuid

from .log import get_logger
from .metrics import _label_str, fleet_samples

log = get_logger("obs.alerts")

ALERTS_SCHEMA = "peasoup_tpu.alerts"
ALERTS_VERSION = 1

# a resolved alert stays visible in the snapshot this long (operators
# want to see what JUST resolved), then drops out
RESOLVED_RETENTION_S = 3600.0

# a crashed evaluator's lock is taken over after this long
LOCK_STALE_S = 60.0

_SCHEMA_PATH = os.path.join(
    os.path.dirname(__file__), "alerts.schema.json"
)

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


def load_alerts_schema() -> dict:
    with open(_SCHEMA_PATH) as f:
        return json.load(f)


def validate_snapshot(doc: dict, schema: dict | None = None) -> None:
    """Validate an alerts snapshot against the checked-in schema
    (raises :class:`~peasoup_tpu_torch.obs.schema.SchemaError`)."""
    from .schema import validate

    validate(doc, schema or load_alerts_schema())


def default_rules(heartbeat_s: float = 2.0) -> list[dict]:
    """The stock survey-health rule set over the metrics the campaign
    and streaming layers already record. ``heartbeat_s`` sizes the
    worker-stall absence window (3x the beat interval, floored so a
    scheduling hiccup is not a page)."""
    return [
        {
            "name": "worker_heartbeat_stalled",
            "kind": "absence",
            "metric": "worker_heartbeat_unix",
            "window_s": max(3.0 * float(heartbeat_s), 5.0),
            "severity": "page",
        },
        {
            # SLO: >= 90% of finished jobs succeed
            "name": "job_failure_burn_rate",
            "kind": "burn_rate",
            "bad": "jobs_failed_total",
            "good": "jobs_done_total",
            "objective": 0.9,
            "windows": [[300.0, 6.0], [1800.0, 3.0]],
            "severity": "page",
        },
        {
            # SLO: >= 95% of streaming chunks inside latency_slo_s
            "name": "chunk_latency_slo_burn",
            "kind": "burn_rate",
            "bad": "chunk_slo_miss_total",
            "total": "chunks_total",
            "objective": 0.95,
            "windows": [[300.0, 6.0], [1800.0, 3.0]],
            "severity": "page",
        },
        {
            "name": "preemption_latency_p95",
            "kind": "threshold",
            "metric": "preemption_latency_seconds",
            "metric_kind": "hist",
            "select": "p95",
            "op": ">",
            "value": 60.0,
            "window_s": 1800.0,
            "severity": "warn",
        },
        {
            # recompile budget: steady-state reuse is the whole point
            # of the bucket ladder; a recompile storm is a regression
            "name": "jit_recompile_budget",
            "kind": "threshold",
            "metric": "jit_programs_compiled_total",
            "metric_kind": "counter",
            "select": "increase",
            "op": ">",
            "value": 50.0,
            "window_s": 3600.0,
            "severity": "warn",
        },
        {"name": "data_quality", "kind": "data_quality",
         "severity": "warn"},
        {"name": "sentinel_unrecovered", "kind": "sentinel",
         "severity": "page"},
        {
            # a tenant parked at its quota ceiling (max_running or
            # device-seconds window) — findings computed by
            # campaign/tenants.throttle_map, routed to the tenant's
            # own journal so THEIR operator sees it without grepping
            # the fleet's
            "name": "tenant_quota_exhausted",
            "kind": "tenant_quota",
            "severity": "warn",
            "route": "tenant",
        },
        {
            # the fleet-wide job_failure_burn_rate above says "the
            # survey is failing"; this one says WHOSE jobs are — the
            # same SLO evaluated per tenant label value
            "name": "tenant_job_failure_burn_rate",
            "kind": "burn_rate",
            "bad": "jobs_failed_total",
            "good": "jobs_done_total",
            "objective": 0.9,
            "windows": [[300.0, 6.0], [1800.0, 3.0]],
            "by": "tenant",
            "severity": "page",
            "route": "tenant",
        },
    ]


def tenant_journal_path(root: str, tenant: str) -> str:
    """The per-tenant alert journal a ``route: "tenant"`` rule's
    transitions are copied to (tenant value sanitised: it becomes a
    file name)."""
    safe = "".join(
        c if c.isalnum() or c in "-_" else "_" for c in str(tenant)
    )[:48] or "_"
    return os.path.join(
        os.path.abspath(root), "queue", f"alerts.{safe}.jsonl"
    )


# --------------------------------------------------------------------------
# selectors over the fleet samples
# --------------------------------------------------------------------------

def counter_increase(
    samples_by_source: dict[str, list[dict]],
    name: str,
    t_lo: float,
    t_hi: float,
) -> float:
    """Windowed increase of a cumulative counter summed across the
    fleet: positive deltas between consecutive samples of one
    (source, labels) series inside ``(t_lo, t_hi]``; a value drop is a
    process-restart reset (the new total IS the increase since it).
    The sample before the window seeds the baseline, so rotation (which
    keeps the newest tail with totals carried in recorder memory)
    never replays old deltas."""
    total = 0.0
    for samples in samples_by_source.values():
        prev: dict[tuple, float] = {}
        for rec in samples:
            if rec.get("name") != name or rec.get("kind") != "counter":
                continue
            t = float(rec.get("t", 0.0))
            v = float(rec.get("value", 0.0))
            key = tuple(sorted((rec.get("labels") or {}).items()))
            if t <= t_lo:
                prev[key] = v
                continue
            if t > t_hi:
                continue
            base = prev.get(key)
            if base is None or v < base:
                total += v  # series born (or reset) inside the window
            else:
                total += v - base
            prev[key] = v
    return total


def _gauge_last(
    samples_by_source: dict, name: str, t_lo: float, t_hi: float
) -> dict[str, float]:
    """Latest in-window gauge value per source."""
    out: dict[str, tuple[float, float]] = {}
    for src, samples in samples_by_source.items():
        for rec in samples:
            if rec.get("name") != name or rec.get("kind") != "gauge":
                continue
            t = float(rec.get("t", 0.0))
            if t <= t_lo or t > t_hi:
                continue
            if src not in out or t >= out[src][0]:
                out[src] = (t, float(rec.get("value", 0.0)))
    return {src: v for src, (_, v) in out.items()}


def _hist_observations(
    samples_by_source: dict, name: str, t_lo: float, t_hi: float
) -> list[float]:
    out = []
    for samples in samples_by_source.values():
        for rec in samples:
            if rec.get("name") != name or rec.get("kind") != "hist":
                continue
            t = float(rec.get("t", 0.0))
            if t_lo < t <= t_hi:
                out.append(float(rec.get("value", 0.0)))
    return out


def _quantile(vals: list[float], q: float) -> float:
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


# --------------------------------------------------------------------------
# rule evaluation: each evaluator returns the ACTIVE findings
# [(labels, value, message)]; anything previously alerting that is not
# reported active this round resolves
# --------------------------------------------------------------------------

def _eval_threshold(rule: dict, samples: dict, now: float) -> list:
    window = float(rule.get("window_s", 900.0))
    t_lo, t_hi = now - window, now
    sel = rule.get("select", "last")
    kind = rule.get("metric_kind", "gauge")
    metric = rule["metric"]
    value: float | None = None
    if kind == "counter":
        inc = counter_increase(samples, metric, t_lo, t_hi)
        value = inc / window if sel == "rate" else inc
    elif kind == "hist":
        obs = _hist_observations(samples, metric, t_lo, t_hi)
        if obs:
            if sel in ("p50", "p95", "p99"):
                value = _quantile(obs, float(sel[1:]) / 100.0)
            elif sel == "max":
                value = max(obs)
            else:
                value = sum(obs) / len(obs)
    else:
        per_src = _gauge_last(samples, metric, t_lo, t_hi)
        if per_src:
            if sel == "sum":
                value = sum(per_src.values())
            elif sel == "max":
                value = max(per_src.values())
            elif sel == "min":
                value = min(per_src.values())
            else:  # "last": newest value fleet-wide
                value = _gauge_last(
                    {"_": [r for v in samples.values() for r in v]},
                    metric, t_lo, t_hi,
                ).get("_")
    if value is None:
        return []  # no data in window -> no alert
    bound = float(rule["value"])
    if not _OPS[rule.get("op", ">")](value, bound):
        return []
    return [(
        {},
        float(value),
        f"{metric} {sel} {value:.4g} {rule.get('op', '>')} "
        f"{bound:.4g} over {window:.0f}s",
    )]


def _eval_absence(
    rule: dict, samples: dict, now: float,
    live_sources: list[str] | None,
) -> list:
    metric = rule["metric"]
    window = float(rule.get("window_s", 10.0))
    sources = (
        sorted(live_sources) if live_sources is not None
        else sorted(samples)
    )
    out = []
    for src in sources:
        ts = [
            float(r.get("t", 0.0))
            for r in samples.get(src, [])
            if r.get("name") == metric
        ]
        if not ts:
            continue  # never reported: give a fresh worker the benefit
        age = now - max(ts)
        if age > window:
            out.append((
                {"worker": src},
                age,
                f"no {metric} sample from {src} for {age:.1f}s "
                f"(window {window:.1f}s)",
            ))
    return out


def _counter_label_values(
    samples: dict, names: set, label: str
) -> list[str]:
    """Every value the ``label`` takes across the named counters."""
    vals: set[str] = set()
    for ss in samples.values():
        for rec in ss:
            if rec.get("name") in names and rec.get("kind") == "counter":
                v = (rec.get("labels") or {}).get(label)
                if v:
                    vals.add(str(v))
    return sorted(vals)


def _filter_by_label(samples: dict, label: str, value: str) -> dict:
    return {
        src: [
            r for r in ss
            if (r.get("labels") or {}).get(label) == value
        ]
        for src, ss in samples.items()
    }


def _eval_burn_rate(rule: dict, samples: dict, now: float) -> list:
    by = rule.get("by")
    if by:
        # per-label-value grouping: the same SLO evaluated over each
        # slice of the counters (e.g. ``by: "tenant"`` — one alert per
        # burning tenant, labelled so routing can fan it out)
        names = {
            n for n in (
                rule.get("bad"), rule.get("good"), rule.get("total")
            ) if n
        }
        inner = {k: v for k, v in rule.items() if k != "by"}
        out = []
        for val in _counter_label_values(samples, names, by):
            sub = _filter_by_label(samples, by, val)
            for labels, value, msg in _eval_burn_rate(inner, sub, now):
                out.append((
                    {**labels, by: val}, value, f"{msg} [{by}={val}]",
                ))
        return out
    budget = 1.0 - float(rule["objective"])
    first_ratio = None
    for window_s, factor in rule.get("windows", [[300.0, 6.0]]):
        t_lo = now - float(window_s)
        bad = counter_increase(samples, rule["bad"], t_lo, now)
        if rule.get("total"):
            total = counter_increase(samples, rule["total"], t_lo, now)
        else:
            total = bad + counter_increase(
                samples, rule["good"], t_lo, now
            )
        if total <= 0:
            return []  # no traffic in a window -> nothing is burning
        ratio = bad / total
        if ratio <= float(factor) * budget:
            return []  # ALL windows must burn
        if first_ratio is None:
            first_ratio = ratio
    if first_ratio is None:
        return []
    return [(
        {},
        float(first_ratio),
        f"{rule['bad']} error ratio {first_ratio:.3f} burns "
        f">{budget:.3f} budget in every window",
    )]


def _eval_findings(findings: list[dict] | None) -> list:
    out = []
    for f in findings or []:
        labels = {
            str(k): str(v)
            for k, v in (f.get("labels") or {}).items()
        }
        out.append((
            labels,
            float(f.get("value", 1.0)),
            str(f.get("message", "")),
        ))
    return out


# --------------------------------------------------------------------------
# the engine: lifecycle + persistence
# --------------------------------------------------------------------------

def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class AlertEngine:
    """Evaluate the rule set for one campaign and persist the alert
    lifecycle under ``<root>/queue/``. Stateless across instances: the
    previous round's states are restored from the snapshot, so any
    worker (or the CLI) can run a round."""

    def __init__(
        self,
        root: str,
        rules: list[dict] | None = None,
        lock_stale_s: float = LOCK_STALE_S,
    ) -> None:
        self.root = os.path.abspath(root)
        self.rules = (
            [dict(r) for r in rules] if rules is not None
            else default_rules()
        )
        qdir = os.path.join(self.root, "queue")
        self.snapshot_path = os.path.join(qdir, "alerts.json")
        self.log_path = os.path.join(qdir, "alerts.jsonl")
        self.lock_path = os.path.join(qdir, "alerts.lock")
        self.lock_stale_s = float(lock_stale_s)
        self._lock_token: str | None = None

    # --- persistence --------------------------------------------------
    def load_snapshot(self) -> dict:
        doc = _read_json(self.snapshot_path)
        if not isinstance(doc, dict) or doc.get("schema") != ALERTS_SCHEMA:
            return {
                "schema": ALERTS_SCHEMA,
                "version": ALERTS_VERSION,
                "updated_unix": 0.0,
                "alerts": [],
            }
        return doc

    def _acquire_lock(self, now: float) -> bool:
        os.makedirs(os.path.dirname(self.lock_path), exist_ok=True)
        for _ in range(2):
            try:
                fd = os.open(
                    self.lock_path,
                    os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                )
            except FileExistsError:
                doc = _read_json(self.lock_path)
                if doc is not None:
                    held_unix = float(doc.get("t_unix", 0.0))
                    if now - held_unix <= self.lock_stale_s:
                        return False  # live evaluator owns the round
                else:
                    # TORN lock: unreadable is either a holder that
                    # died between the O_CREAT|O_EXCL and the document
                    # publish, or a LIVE acquirer still inside that
                    # window. Age-gate on st_ctime before taking over
                    # — an immediate takeover here stole the round
                    # from a perfectly live evaluator (found by the mc
                    # alerts_lock scenario)
                    try:
                        age = now - os.stat(self.lock_path).st_ctime
                    except OSError:
                        continue  # released in the gap: retry create
                    if age <= self.lock_stale_s:
                        return False
                # stale (or aged-out torn) lock: win the takeover via
                # a rename race, then retry the exclusive create
                reaped = self.lock_path + f".{uuid.uuid4().hex[:8]}.reap"
                try:
                    os.rename(self.lock_path, reaped)
                    os.unlink(reaped)
                except OSError:
                    pass  # another evaluator won the takeover
                continue
            token = uuid.uuid4().hex
            with os.fdopen(fd, "w") as f:
                json.dump(
                    {"pid": os.getpid(), "t_unix": now, "token": token},
                    f,
                )
            self._lock_token = token
            return True
        return False

    def _release_lock(self) -> None:
        """Token-verified release. A blind unlink here deleted a lock
        another evaluator had legitimately taken over after deciding
        ours was stale — mutual exclusion silently lapsed for a round
        (found by the mc alerts_release_race scenario). Rename the
        lock aside, confirm the tombstone still carries OUR token,
        and restore a mismatch via link so a new holder's lock (or
        its own re-acquire in the gap) is never clobbered."""
        token, self._lock_token = self._lock_token, None
        tomb = self.lock_path + f".{uuid.uuid4().hex[:8]}.reap"
        try:
            os.rename(self.lock_path, tomb)
        except OSError:
            return  # taken over and released already — same outcome
        doc = _read_json(tomb)
        if doc is None or doc.get("token") != token:
            try:
                os.link(tomb, self.lock_path)
            except OSError:
                pass  # the new holder re-created it first: they win
        try:
            os.unlink(tomb)
        except OSError:
            pass

    def _append_transitions(self, transitions: list[dict]) -> None:
        if not transitions:
            return
        lines = "".join(
            json.dumps(t, separators=(",", ":")) + "\n"
            for t in transitions
        )
        with open(self.log_path, "a") as f:
            f.write(lines)
        self._route_transitions(transitions)

    def _route_transitions(self, transitions: list[dict]) -> None:
        """Fan transitions of ``route:``-scoped rules out to per-value
        journals: a rule with ``route: "tenant"`` copies each of its
        transitions to ``queue/alerts.<labels[tenant]>.jsonl`` — the
        tenant's own audit trail, beside (never instead of) the
        fleet-wide journal."""
        routes = {
            r["name"]: r["route"]
            for r in self.rules if r.get("route")
        }
        if not routes:
            return
        by_journal: dict[str, list[str]] = {}
        for t in transitions:
            label = routes.get(t.get("rule"))
            if not label:
                continue
            val = (t.get("labels") or {}).get(label)
            if not val:
                continue
            by_journal.setdefault(str(val), []).append(
                json.dumps(t, separators=(",", ":")) + "\n"
            )
        for val, lines in by_journal.items():
            try:
                with open(
                    tenant_journal_path(self.root, val), "a"
                ) as f:
                    f.write("".join(lines))
            except OSError:
                log.debug(
                    "per-tenant alert journal append failed (%s)",
                    val, exc_info=True,
                )

    def _write_snapshot(self, doc: dict) -> None:
        d = os.path.dirname(self.snapshot_path)
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=2)
                f.write("\n")
            os.replace(tmp, self.snapshot_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # --- evaluation ---------------------------------------------------
    def evaluate(
        self,
        samples: dict[str, list[dict]] | None = None,
        now: float | None = None,
        dq_findings: list[dict] | None = None,
        sentinel_findings: list[dict] | None = None,
        live_sources: list[str] | None = None,
        tenant_findings: list[dict] | None = None,
    ) -> dict:
        """Run one evaluation round and return the new snapshot (or
        the current one when another evaluator holds the lock)."""
        now = time.time() if now is None else float(now)
        if samples is None:
            samples = fleet_samples(self.root)
        if not self._acquire_lock(now):
            return self.load_snapshot()
        try:
            return self._evaluate_locked(
                samples, now, dq_findings, sentinel_findings,
                live_sources, tenant_findings,
            )
        finally:
            self._release_lock()

    def _evaluate_locked(
        self, samples, now, dq_findings, sentinel_findings,
        live_sources, tenant_findings=None,
    ) -> dict:
        prev_doc = self.load_snapshot()
        prev = {
            (a.get("rule"), _labels_key(a.get("labels") or {})): a
            for a in prev_doc.get("alerts", [])
        }
        active: dict[tuple, dict] = {}
        for rule in self.rules:
            kind = rule.get("kind", "threshold")
            try:
                if kind == "threshold":
                    found = _eval_threshold(rule, samples, now)
                elif kind == "absence":
                    found = _eval_absence(
                        rule, samples, now, live_sources
                    )
                elif kind == "burn_rate":
                    found = _eval_burn_rate(rule, samples, now)
                elif kind == "data_quality":
                    found = _eval_findings(dq_findings)
                elif kind == "sentinel":
                    found = _eval_findings(sentinel_findings)
                elif kind == "tenant_quota":
                    found = _eval_findings(tenant_findings)
                else:
                    log.warning("unknown alert rule kind: %r", kind)
                    continue
            except Exception:
                # a broken rule must not take the round down
                log.warning(
                    "alert rule %r failed to evaluate",
                    rule.get("name"), exc_info=True,
                )
                continue
            for labels, value, message in found:
                key = (rule["name"], _labels_key(labels))
                ent = {
                    "rule": rule["name"],
                    "labels": {
                        str(k): str(v) for k, v in labels.items()
                    },
                    "severity": str(rule.get("severity", "warn")),
                    "value": float(value),
                    "message": str(message)[:400],
                }
                if "value" in rule and kind != "data_quality":
                    try:
                        ent["threshold"] = float(rule["value"])
                    except (TypeError, ValueError):
                        pass
                active[key] = ent

        transitions: list[dict] = []
        next_alerts: list[dict] = []

        def _log_transition(ent, frm, to):
            transitions.append({
                "t_unix": now,
                "rule": ent["rule"],
                "labels": ent.get("labels") or {},
                "from": frm,
                "to": to,
                "value": ent.get("value"),
                "message": ent.get("message", ""),
            })

        for key, ent in active.items():
            pv = prev.get(key)
            pstate = pv.get("state") if pv else None
            for_s = 0.0
            for rule in self.rules:
                if rule["name"] == key[0]:
                    for_s = float(rule.get("for_s", 0.0))
                    break
            if pstate == "firing":
                ent.update({
                    "state": "firing",
                    "since_unix": pv["since_unix"],
                    "pending_since_unix": pv.get(
                        "pending_since_unix", pv["since_unix"]
                    ),
                    "firing_since_unix": pv.get(
                        "firing_since_unix", pv["since_unix"]
                    ),
                })
            elif pstate == "pending":
                pending_since = pv.get(
                    "pending_since_unix", pv["since_unix"]
                )
                ent.update({
                    "since_unix": pv["since_unix"],
                    "pending_since_unix": pending_since,
                })
                if now - pending_since >= for_s:
                    ent["state"] = "firing"
                    ent["firing_since_unix"] = now
                    _log_transition(ent, "pending", "firing")
                else:
                    ent["state"] = "pending"
            else:
                # inactive (or resolved) -> a fresh pending episode
                ent.update({
                    "state": "pending",
                    "since_unix": now,
                    "pending_since_unix": now,
                })
                _log_transition(ent, pstate or "inactive", "pending")
                if for_s <= 0.0:
                    ent["state"] = "firing"
                    ent["firing_since_unix"] = now
                    _log_transition(ent, "pending", "firing")
            next_alerts.append(ent)

        for key, pv in prev.items():
            if key in active:
                continue
            pstate = pv.get("state")
            if pstate == "pending":
                _log_transition(pv, "pending", "inactive")
            elif pstate == "firing":
                ent = dict(pv)
                ent["state"] = "resolved"
                ent["resolved_unix"] = now
                _log_transition(ent, "firing", "resolved")
                next_alerts.append(ent)
            elif pstate == "resolved":
                if now - float(
                    pv.get("resolved_unix", 0.0)
                ) <= RESOLVED_RETENTION_S:
                    next_alerts.append(pv)

        next_alerts.sort(
            key=lambda a: (a.get("rule", ""), _labels_key(
                a.get("labels") or {}
            ))
        )
        doc = {
            "schema": ALERTS_SCHEMA,
            "version": ALERTS_VERSION,
            "updated_unix": now,
            "alerts": next_alerts,
        }
        self._append_transitions(transitions)
        self._write_snapshot(doc)
        if transitions:
            log.info(
                "alerts: %d transition(s): %s",
                len(transitions),
                ", ".join(
                    f"{t['rule']}:{t['from']}->{t['to']}"
                    for t in transitions[:6]
                ),
            )
        return doc


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None  # absent, mid-replace, or torn: treat as absent


def load_alerts(root: str) -> dict:
    """The current alerts snapshot for a campaign (empty when none)."""
    return AlertEngine(root, rules=[]).load_snapshot()


# --------------------------------------------------------------------------
# exposition + one-stop campaign evaluation
# --------------------------------------------------------------------------

def alerts_exposition(snapshot: dict) -> str:
    """Render pending/firing alerts as the Prometheus ``ALERTS``
    convention series (appended to the campaign's /metrics body)."""
    lines: list[str] = []
    for a in snapshot.get("alerts", []):
        if a.get("state") not in ("pending", "firing"):
            continue
        labels = {
            "alertname": a.get("rule", ""),
            "alertstate": a["state"],
            "severity": a.get("severity", "warn"),
            **(a.get("labels") or {}),
        }
        lines.append(f"ALERTS{_label_str(labels)} 1")
    if not lines:
        return ""
    return "# TYPE ALERTS gauge\n" + "\n".join(lines) + "\n"


def evaluate_campaign(
    root: str,
    rules: list[dict] | None = None,
    now: float | None = None,
    queue=None,
    registry=None,
    samples: dict[str, list[dict]] | None = None,
) -> dict:
    """Evaluate the full survey-health round for one campaign: fleet
    metrics + data-quality findings + sentinel recoveries + registry
    liveness. Never raises (the runner calls this beside its status
    rollup): any failure returns the last good snapshot."""
    try:
        from ..campaign.queue import JobQueue
        from ..campaign.registry import WorkerRegistry
        from .health import quality_findings, sentinel_findings

        if queue is None:
            queue = JobQueue(root)
        if registry is None:
            registry = WorkerRegistry(root)
        if samples is None:
            samples = fleet_samples(root)
        heartbeat_s = max(
            1.0, float(getattr(registry, "lease_s", 10.0)) / 3.0
        )
        engine = AlertEngine(
            root,
            rules=rules if rules is not None
            else default_rules(heartbeat_s=heartbeat_s),
        )
        live = sorted(
            e.get("worker_id", "")
            for e in registry.live()
        )
        tenant_findings: list[dict] = []
        try:
            from ..campaign.tenants import throttle_map

            tenant_findings = [
                {
                    "labels": {"tenant": name},
                    "value": 1.0,
                    "message": str(f.get("reason", "over quota")),
                }
                for name, f in sorted(
                    throttle_map(root, now=now).items()
                )
            ]
        except Exception:
            log.warning(
                "tenant quota findings failed", exc_info=True
            )
        return engine.evaluate(
            samples=samples,
            now=now,
            dq_findings=quality_findings(queue.done_records()),
            sentinel_findings=sentinel_findings(root, queue),
            live_sources=[w for w in live if w],
            tenant_findings=tenant_findings,
        )
    except Exception:
        log.warning("alert evaluation failed", exc_info=True)
        return load_alerts(root)
