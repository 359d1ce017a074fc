"""Process-global resilience accounting (the port's copy of the JAX
package's resilience/stats.py).

Every retry, degradation rung, quarantined artifact, injected fault
and crashed background thread increments a counter here, so one
``resilience`` section in status.json / the telemetry manifest answers
"what has this process survived so far" without grepping the event
log. Counters are process-lifetime (a campaign worker accumulates
across jobs); per-job attribution comes from ``delta_since`` snapshots
recorded into campaign done records, and per-event attribution from
the telemetry event stream.

Deliberately dependency-free (stdlib only): obs.telemetry registers
the snapshot as a status section at construction time, so importing
anything from obs here would cycle.
"""

from __future__ import annotations

import threading

_TABLES = (
    "retries",
    "recoveries",
    "giveups",
    "degradations",
    "corrupt_artifacts",
    "faults_injected",
    "thread_crashes",
    "preemptions",
)


class ResilienceStats:
    """Thread-safe counter tables keyed by site/rung/thread name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tables: dict[str, dict[str, int]] = {
            t: {} for t in _TABLES
        }

    def reset(self) -> None:
        with self._lock:
            self._tables = {t: {} for t in _TABLES}

    def _incr(self, table: str, key: str, by: int = 1) -> None:
        with self._lock:
            tab = self._tables[table]
            tab[key] = tab.get(key, 0) + by

    # --- recording (one verb per taxonomy outcome) --------------------
    def retry(self, site: str) -> None:
        self._incr("retries", site)

    def recovered(self, site: str) -> None:
        self._incr("recoveries", site)

    def giveup(self, site: str) -> None:
        self._incr("giveups", site)

    def degradation(self, ladder: str, rung: str) -> None:
        self._incr("degradations", f"{ladder}:{rung}")

    def corrupt_artifact(self, kind: str) -> None:
        self._incr("corrupt_artifacts", kind)

    def fault_injected(self, site: str) -> None:
        self._incr("faults_injected", site)

    def thread_crashed(self, name: str) -> None:
        self._incr("thread_crashes", name)

    def preemption(self, kind: str) -> None:
        """A claim revoked (``kind``: "requested" / "released" /
        "reaped" / "retire") — the scheduling half of elasticity, kept
        in its own table so preemptive scheduling never reads as
        failure recovery."""
        self._incr("preemptions", kind)

    # --- reading ------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serialisable view: the status.json/manifest
        ``resilience`` section. ``degraded`` flags states an operator
        should look at (a dead background thread, a retry budget spent
        without recovery)."""
        with self._lock:
            tables = {t: dict(v) for t, v in self._tables.items()}
        out: dict = {t: tables[t] for t in _TABLES}
        out["degraded"] = bool(
            tables["thread_crashes"] or tables["giveups"]
        )
        out["total_faults_injected"] = sum(
            tables["faults_injected"].values()
        )
        return out

    def delta_since(self, base: dict) -> dict:
        """Counter deltas vs an earlier ``snapshot()`` — the per-job
        resilience record the campaign runner stores in done records
        (so the rollup can aggregate without double counting)."""
        now = self.snapshot()
        out: dict = {}
        for t in _TABLES:
            before = base.get(t, {}) or {}
            d = {
                k: v - before.get(k, 0)
                for k, v in now[t].items()
                if v - before.get(k, 0)
            }
            if d:
                out[t] = d
        return out


STATS = ResilienceStats()
