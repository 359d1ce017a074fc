"""Live run status: the ``status.json`` heartbeat and stall watchdog (the
port's copy of the JAX package's obs/heartbeat.py).

A long survey job is opaque from the outside — the telemetry manifest
only materialises when the run *finishes*. :class:`Heartbeat` is the
live layer: a daemon thread that atomically rewrites a small
``status.json`` snapshot every ``interval`` seconds, driven entirely by
the run's :class:`~peasoup_tpu_torch.obs.telemetry.RunTelemetry` (current
stage, progress counter + rate/ETA, device-memory gauges, event tail).
Schedulers poll it for liveness (``updated_unix`` going stale means the process is
gone or wedged).

The thread doubles as the **stall watchdog**: when no progress signal
(stage, progress counter, event count, counters) advances for
``stall_timeout`` seconds it emits a structured ``stall`` event into the
telemetry log and a warning log line — so a hung collective or a wedged
device call is visible both live (``"stalled": true`` in status.json)
and post-mortem (the event survives into the manifest / flight dump).

The heartbeat never *fails* a run: every snapshot write is wrapped, and
the thread is a daemon so an aborted run cannot hang on join. A beat reads
only host-side counters of the caching allocator
(``RunTelemetry.capture_device_memory``): it never synchronises a card's
stream or waits on a kernel.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

from .log import get_logger

STATUS_SCHEMA = "peasoup_tpu.status"
# v2: optional named status sections from
# RunTelemetry.set_status_section (e.g. the streaming driver's
# "streaming" block with input rate / queue depth / latency-vs-SLO /
# drop tallies). Watchers .get() them; absent for batch runs.
STATUS_VERSION = 2

log = get_logger("obs.heartbeat")


def _atomic_write_json(path: str, doc: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)


def load_status(path: str) -> dict:
    """Load + validate a status.json snapshot."""
    with open(path) as f:
        st = json.load(f)
    if st.get("schema") != STATUS_SCHEMA:
        raise ValueError(
            f"{path}: not a {STATUS_SCHEMA} snapshot "
            f"(schema={st.get('schema')!r})"
        )
    return st


class Heartbeat:
    """Daemon thread rewriting ``path`` with a live run snapshot.

    Use as a context manager, or ``start()`` / ``stop()`` explicitly;
    ``stop()`` writes one final snapshot with ``"done": true`` so a
    watcher can distinguish a finished run from a dead one.
    """

    def __init__(
        self,
        telemetry,
        path: str,
        interval: float = 5.0,
        stall_timeout: float = 300.0,
        event_tail: int = 8,
    ) -> None:
        self._tel = telemetry
        self.path = path
        self.interval = max(0.01, float(interval))
        self.stall_timeout = float(stall_timeout)
        self.event_tail = int(event_tail)
        self._seq = 0
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        # rate/ETA from successive snapshots of the progress counter
        self._prev_progress: tuple[float, float] | None = None  # (t, done)
        self._rate: float | None = None
        # stall watchdog state
        self._last_token = None
        self._last_change = time.perf_counter()
        self._stalled = False

    # --- lifecycle ----------------------------------------------------
    def start(self) -> "Heartbeat":
        if self._thread is not None:
            return self
        # audit: ignore[PSA009] -- threading.Event is internally locked
        self._stop_evt.clear()
        self._beat()  # immediate first snapshot: liveness from t=0
        self._thread = threading.Thread(
            target=self._run, name="peasoup-heartbeat", daemon=True
        )
        self._thread.start()
        log.debug(
            "heartbeat started: %s every %.3gs (stall watchdog %.3gs)",
            self.path, self.interval, self.stall_timeout,
        )
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=max(1.0, 2 * self.interval))
        self._thread = None
        self._beat(final=True)

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- the beat -----------------------------------------------------
    def _run(self) -> None:
        # crash guard (resilience policy): _beat swallows per-snapshot
        # failures already, but if the loop itself ever dies the run
        # must not lose its liveness signal invisibly — the guard
        # emits a structured thread_crashed event and flips the
        # resilience status section to degraded. Lazy import: obs is
        # below resilience in the import graph.
        from ..resilience import guard_thread

        guard_thread(
            "peasoup-heartbeat", self._beat_loop, telemetry=self._tel
        )

    def _beat_loop(self) -> None:
        while not self._stop_evt.wait(self.interval):
            self._beat()

    def _progress_token(self):
        """Anything whose advance counts as liveness for the watchdog."""
        tel = self._tel
        prog = tel.progress_state
        return (
            tel.current_stage,
            prog.get("done") if prog else None,
            len(tel.events),
            round(sum(tel.counters.values()), 6) if tel.counters else 0.0,
        )

    def _check_stall(self, now: float) -> None:
        token = self._progress_token()
        if token != self._last_token:
            self._last_token = token
            self._last_change = now
            if self._stalled:
                self._stalled = False
                self._tel.event(
                    "stall_recovered", stage=self._tel.current_stage
                )
                log.warning(
                    "run progressing again (stage %s)",
                    self._tel.current_stage,
                )
                self._last_token = self._progress_token()
            return
        if (
            not self._stalled
            and self.stall_timeout > 0
            and now - self._last_change > self.stall_timeout
        ):
            self._stalled = True
            stalled_for = round(now - self._last_change, 3)
            self._tel.event(
                "stall",
                stage=self._tel.current_stage,
                stalled_for_s=stalled_for,
                stall_timeout_s=self.stall_timeout,
            )
            log.warning(
                "no progress for %.1fs (stage %s): run may be stalled",
                stalled_for, self._tel.current_stage,
            )
            # absorb our own event so the watchdog doesn't see it as
            # progress and oscillate stall/recovered every timeout
            self._last_token = self._progress_token()

    def _snapshot(self, final: bool) -> dict:
        tel = self._tel
        now = time.perf_counter()
        prog = dict(tel.progress_state) if tel.progress_state else None
        if prog is not None:
            done, total = prog["done"], prog.get("total")
            if self._prev_progress is not None:
                t_prev, d_prev = self._prev_progress
                if done > d_prev and now > t_prev:
                    self._rate = (done - d_prev) / (now - t_prev)
            self._prev_progress = (now, done)
            prog["rate_per_s"] = (
                round(self._rate, 6) if self._rate else None
            )
            if total:
                prog["frac"] = round(done / total, 6)
                prog["eta_s"] = (
                    round((total - done) / self._rate, 3)
                    if self._rate and done < total
                    else (0.0 if done >= total else None)
                )
        # audit: ignore[PSA009] -- single writer: only the beat thread
        # increments, and stop() joins it before the final beat
        self._seq += 1
        sections = {}
        try:
            sections = tel.snapshot_sections()
        except Exception:
            pass  # a section provider must never fail the beat
        return {
            "schema": STATUS_SCHEMA,
            "version": STATUS_VERSION,
            "run_id": tel.run_id,
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "seq": self._seq,
            "updated_unix": time.time(),
            "uptime_s": round(now - tel._t0, 3),
            "done": bool(final),
            "stage": tel.current_stage,
            "progress": prog,
            "stalled": self._stalled,
            "last_progress_age_s": round(now - self._last_change, 3),
            "counters": dict(tel.counters),
            "gauges": dict(tel.gauges),
            "events_tail": list(tel.events[-self.event_tail :]),
        } | {
            k: v for k, v in sections.items()
            # a section can never shadow a core snapshot key
            if k not in (
                "schema", "version", "run_id", "pid", "hostname", "seq",
                "updated_unix", "uptime_s", "done", "stage", "progress",
                "stalled", "last_progress_age_s", "counters", "gauges",
                "events_tail",
            )
        }

    def _beat(self, final: bool = False) -> None:
        try:
            self._tel.capture_device_memory("heartbeat")
            self._check_stall(time.perf_counter())
            _atomic_write_json(self.path, self._snapshot(final))
        except Exception:
            # the heartbeat must never take the run down with it
            log.debug("heartbeat write failed", exc_info=True)
