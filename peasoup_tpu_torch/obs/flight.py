"""Crash flight recorder: forensics for runs that never finish (the
port's copy of the JAX package's obs/flight.py).

The telemetry manifest is written at the *end* of a successful run — a
preempted, OOM-killed or wedged survey job leaves nothing behind.
:class:`FlightRecorder` closes that gap:

- it keeps a **bounded ring buffer** of the most recent telemetry
  events (subscribed via ``RunTelemetry.add_listener``, seeded with the
  tail already recorded), so the dump stays small no matter how long
  the run was;
- it installs **SIGTERM / SIGINT handlers** and a ``sys.excepthook``
  so that a kill, a Ctrl-C or an uncaught fatal exception dumps a
  ``flight.json`` (reason, stage, progress, context, counters/gauges,
  the event ring) *and* a partial telemetry manifest marked
  ``"aborted": true`` — checkpoint-resume tooling can then report what
  was lost.

After dumping a signal is re-delivered with the previous disposition
restored, so exit codes (``128+signum``) and parent process semantics
are unchanged. The recorder dumps **at most once**; install/close are
idempotent and restore the previous handlers. Signal handlers are only
installed from the main thread (CPython restriction); elsewhere the
recorder still captures events and can be dumped explicitly.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import sys
import threading
import time
import traceback
from collections import deque

from .log import get_logger

FLIGHT_SCHEMA = "peasoup_tpu.flight"
FLIGHT_VERSION = 1

log = get_logger("obs.flight")


def load_flight(path: str) -> dict:
    """Load + validate a flight.json dump."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != FLIGHT_SCHEMA:
        raise ValueError(
            f"{path}: not a {FLIGHT_SCHEMA} dump "
            f"(schema={doc.get('schema')!r})"
        )
    return doc


class FlightRecorder:
    """Ring buffer + abort handlers dumping ``flight.json`` and a
    partial (``aborted``) telemetry manifest.

    ``manifest_path`` is where the partial manifest goes on abort —
    usually the same path the run would have written its final
    ``telemetry.json`` to (the abort dump simply pre-empts it)."""

    def __init__(
        self,
        telemetry,
        path: str,
        manifest_path: str | None = None,
        ring: int = 256,
    ) -> None:
        self._tel = telemetry
        self.path = path
        self.manifest_path = manifest_path
        self._ring: deque = deque(telemetry.events[-ring:], maxlen=ring)
        self._dumped = False
        self._installed = False
        self._prev_handlers: dict[int, object] = {}
        self._prev_excepthook = None
        telemetry.add_listener(self._on_event)

    # --- event feed ---------------------------------------------------
    def _on_event(self, rec: dict) -> None:
        self._ring.append(rec)

    # --- install / restore --------------------------------------------
    def install(self) -> "FlightRecorder":
        if self._installed:
            return self
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev_handlers[sig] = signal.signal(
                        sig, self._on_signal
                    )
                except (ValueError, OSError):  # non-main ctx, rare
                    pass
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        self._installed = True
        log.debug("flight recorder armed: %s", self.path)
        return self

    def close(self) -> None:
        """Restore previous handlers and stop recording (idempotent)."""
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        self._tel.remove_listener(self._on_event)
        self._installed = False

    def __enter__(self) -> "FlightRecorder":
        return self.install()

    def __exit__(self, exc_type, exc, tb) -> None:
        # a propagating exception is a dying run: dump before unwinding
        # (deterministic, unlike excepthook which only fires if nothing
        # up-stack catches it)
        if exc is not None and not isinstance(exc, GeneratorExit):
            self.dump(
                f"exception:{exc_type.__name__}",
                exception="".join(
                    traceback.format_exception_only(exc_type, exc)
                ).strip(),
            )
        self.close()

    # --- the dump -----------------------------------------------------
    def dump(
        self,
        reason: str,
        signum: int | None = None,
        exception: str | None = None,
    ) -> dict | None:
        """Write flight.json + the partial manifest (at most once)."""
        if self._dumped:
            return None
        self._dumped = True
        tel = self._tel
        doc = {
            "schema": FLIGHT_SCHEMA,
            "version": FLIGHT_VERSION,
            "run_id": tel.run_id,
            "pid": os.getpid(),
            "hostname": socket.gethostname(),
            "written_unix": time.time(),
            "uptime_s": round(time.perf_counter() - tel._t0, 3),
            "reason": reason,
            "signum": signum,
            "exception": exception,
            "stage": tel.current_stage,
            "progress": dict(tel.progress_state)
            if tel.progress_state
            else None,
            "context": dict(tel.context),
            "counters": dict(tel.counters),
            "gauges": dict(tel.gauges),
            "events": list(self._ring),
        }
        try:
            # live status sections (e.g. the streaming driver's queue/
            # latency/drop state) are abort forensics too
            doc.update(
                {
                    k: v
                    for k, v in tel.snapshot_sections().items()
                    if k not in doc
                }
            )
        except Exception:
            pass  # a section provider must never block the dump
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2)
                f.write("\n")
            os.replace(tmp, self.path)
            log.error(
                "flight recorder dumped (%s) -> %s", reason, self.path
            )
        except Exception:
            log.exception("flight recorder dump failed")
        if self.manifest_path:
            try:
                tel.write(
                    self.manifest_path, aborted=True, abort_reason=reason
                )
                log.error(
                    "partial telemetry manifest (aborted) -> %s",
                    self.manifest_path,
                )
            except Exception:
                log.exception("partial manifest write failed")
        return doc

    # --- abort paths --------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        self.dump(f"signal:{name}", signum=signum)
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            # chain (e.g. the default SIGINT handler raising
            # KeyboardInterrupt so the run unwinds normally)
            signal.signal(signum, prev)
            prev(signum, frame)
            return
        # re-deliver with the previous (or default) disposition so the
        # exit status is the conventional 128+signum
        signal.signal(
            signum, prev if prev is not None else signal.SIG_DFL
        )
        os.kill(os.getpid(), signum)

    def _excepthook(self, exc_type, exc, tb) -> None:
        self.dump(
            f"exception:{exc_type.__name__}",
            exception="".join(
                traceback.format_exception_only(exc_type, exc)
            ).strip(),
        )
        hook = self._prev_excepthook or sys.__excepthook__
        hook(exc_type, exc, tb)
