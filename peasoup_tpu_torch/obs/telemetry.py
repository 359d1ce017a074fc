"""Run-scoped telemetry (the port's copy of the JAX package's
obs/telemetry.py): the measurement layer under every run.

One :class:`RunTelemetry` object lives for the duration of a CLI run. It
collects:

- **stage timers**: monotonic (``perf_counter``) per-stage wall time;
  the keys mirror the ``<execution_times>`` table in overview.xml,
- **counters / gauges**: trial counts, candidate counts per stage,
  per-card memory high-water marks (``torch.cuda.max_memory_allocated``),
- **events**: every adaptive decision the drivers take (out-of-memory
  shrink-retry with old/new ``dm_block``, cluster-slot escalation,
  wave/chunk geometry, checkpoint resume) as structured records with a
  monotonic offset,
- **device trace** (opt-in, ``--capture-device-trace``): per-scope
  device time from ``torch.profiler``, folded in by
  ``tools/scope_trace.py``.

The manifest is the JAX package's, versioned ``telemetry.json``, and
validates against the port's copy of its schema
(``obs/manifest.schema.json``). Its ``jit`` section stays empty: the port
compiles nothing per shape. The kernels' libraries that a run builds with
``nvcc`` count under the ``kernels.library_builds`` counter.

Propagation is ambient: the drivers call :func:`current` to get the run's
telemetry (activated by the CLI with ``RunTelemetry.activate``). When
nothing is active, :data:`NOOP` absorbs every call at near-zero cost.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import socket
import sys
import time

MANIFEST_SCHEMA = "peasoup_tpu.telemetry"
# v2: top-level process_index/process_count (per-host shard tagging for
# tools/report.py --merge) and the optional aborted/abort_reason pair
# written by the crash flight recorder (obs/flight.py). Readers must
# .get() keys newer than a manifest's version — see tools/report.py.
# v3: optional status sections (e.g. the streaming driver's
# ``streaming`` block) snapshotted into the manifest at write time.
MANIFEST_VERSION = 3

_ACTIVE: contextvars.ContextVar["RunTelemetry | None"] = (
    contextvars.ContextVar("peasoup_tpu_torch_telemetry", default=None)
)

def current() -> "RunTelemetry":
    """The active run's telemetry, or the module-level no-op sink."""
    return _ACTIVE.get() or NOOP


class RunTelemetry:
    """Counters, gauges, stage timers and an event log for one run."""

    def __init__(
        self,
        run_id: str | None = None,
        capture_device_trace: bool = False,
        enabled: bool = True,
    ) -> None:
        self.enabled = enabled
        self.run_id = run_id or (
            time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            + f"-{os.getpid()}"
        )
        self.capture_device_trace = capture_device_trace
        self.created_unix = time.time()
        self._t0 = time.perf_counter()
        self.context: dict = {}
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.timers: dict[str, float] = {}
        self.events: list[dict] = []
        self.device_trace: dict | None = None
        # live state read by the heartbeat/flight-recorder layer
        self.current_stage: str | None = None
        self._stage_stack: list[str] = []
        self.progress_state: dict = {}
        self._listeners: list = []
        # named live-status providers (name -> zero-arg callable or
        # plain dict); snapshotted by the status.json heartbeat AND
        # into the manifest — how a long-lived driver (the streaming
        # loop) exposes a structured section without the heartbeat
        # knowing its schema
        self.status_sections: dict = {}
        if enabled:
            # every run carries the process's resilience accounting
            # (retries, degradations, injected faults, thread crashes)
            # as a status section in status.json and the manifest.
            # stats.py is dependency-free, so no import cycle.
            from ..resilience.stats import STATS

            self.status_sections["resilience"] = STATS.snapshot

    # --- recording ----------------------------------------------------
    def set_context(self, **fields) -> None:
        """Free-form run context (command, input file, config knobs)."""
        if self.enabled:
            self.context.update(fields)

    def incr(self, name: str, by: float = 1) -> None:
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + by

    def gauge(self, name: str, value: float) -> None:
        """Last-write-wins point-in-time value."""
        if self.enabled:
            self.gauges[name] = value

    def gauge_max(self, name: str, value: float) -> None:
        """High-water-mark gauge."""
        if self.enabled:
            self.gauges[name] = max(self.gauges.get(name, value), value)

    def event(self, kind: str, **fields) -> dict | None:
        """Append a structured record to the adaptive-event log. Field
        values must be JSON-serialisable (stringify exceptions)."""
        if not self.enabled:
            return None
        rec = {
            "t": round(time.perf_counter() - self._t0, 6),
            "kind": kind,
            **fields,
        }
        self.events.append(rec)
        for fn in self._listeners:
            try:
                fn(rec)
            except Exception:
                pass  # a broken listener must never fail the run
        return rec

    def set_status_section(self, name: str, provider) -> None:
        """Register a named status section: ``provider`` is a zero-arg
        callable returning a JSON-serialisable dict (or a plain dict).
        Heartbeat snapshots and the manifest embed it top-level under
        ``name`` (pick names the schema knows, e.g. ``streaming``)."""
        if self.enabled:
            self.status_sections[name] = provider

    def snapshot_sections(self) -> dict:
        """Evaluate every registered status section (a failing provider
        yields an ``error`` stub rather than failing the snapshot)."""
        out = {}
        for name, provider in self.status_sections.items():
            try:
                out[name] = provider() if callable(provider) else provider
            except Exception as exc:
                out[name] = {"error": f"{type(exc).__name__}: {exc!s:.200}"}
        return out

    def add_listener(self, fn) -> None:
        """Subscribe ``fn(record)`` to every event as it is recorded
        (the flight recorder's ring-buffer feed)."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def set_stage(self, name: str) -> None:
        """Mark the run's current pipeline stage (drivers that time
        stages manually call this at each phase boundary; drivers using
        :meth:`stage` get it for free). Recorded as a ``stage`` event so
        the flight recorder and manifest keep the transition history."""
        if not self.enabled or name == self.current_stage:
            return
        self.current_stage = name
        self.event("stage", name=name)

    def set_progress(
        self, done: float, total: float | None = None, unit: str = ""
    ) -> None:
        """Update the run's live progress counter (read by the
        status.json heartbeat for rate/ETA and by the stall watchdog)."""
        if not self.enabled:
            return
        self.progress_state = {
            "done": float(done),
            "total": float(total) if total is not None else None,
            "unit": unit,
            "t": round(time.perf_counter() - self._t0, 6),
            "updated_unix": time.time(),
        }

    @contextlib.contextmanager
    def stage(self, name: str):
        """Accumulating monotonic stage timer (same key space as the
        overview.xml ``<execution_times>`` table). Also tracks the
        run's *current* stage for the live status.json heartbeat."""
        t0 = time.perf_counter()
        if self.enabled:
            self._stage_stack.append(name)
            self.set_stage(name)
        try:
            yield
        finally:
            if self.enabled:
                self.timers[name] = self.timers.get(name, 0.0) + (
                    time.perf_counter() - t0
                )
                if self._stage_stack and self._stage_stack[-1] == name:
                    self._stage_stack.pop()
                if self._stage_stack:
                    self.set_stage(self._stage_stack[-1])

    def add_timer(self, name: str, seconds: float) -> None:
        """Merge an externally measured duration into a stage timer."""
        if self.enabled:
            self.timers[name] = self.timers.get(name, 0.0) + seconds

    def merge_timers(self, timers: dict[str, float]) -> None:
        for k, v in timers.items():
            self.add_timer(k, float(v))

    def capture_device_memory(self, tag: str) -> None:
        """The high-water mark of the caching allocator over every local
        card (``torch.cuda.max_memory_allocated``: a host-side counter of
        the allocator, which neither synchronises nor waits on a stream).
        Nothing on a host without a card."""
        if not self.enabled:
            return
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return
        peak = max(
            (int(torch.cuda.max_memory_allocated(i))
             for i in range(torch.cuda.device_count())),
            default=0,
        )
        if peak:
            self.gauge_max(f"memory.{tag}.peak_bytes", peak)
            self.gauge_max("memory.peak_bytes", peak)

    # --- activation ---------------------------------------------------
    @contextlib.contextmanager
    def activate(self):
        """Make this object the run's ambient telemetry (``current()``)
        for the duration of the with-block."""
        token = _ACTIVE.set(self if self.enabled else None)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    @contextlib.contextmanager
    def device_capture(self, device="cuda"):
        """Opt-in profiler capture: run the block under ``torch.profiler``
        and fold the per-scope device-time attribution
        (tools/scope_trace.py) into the manifest: CUDA kernels on a card,
        CPU operators' own time where ``device`` is the CPU. No-op unless
        ``capture_device_trace`` was requested (tracing costs wall time and
        memory); raises where the profiler recorded no kernel of a run
        that launched some."""
        if not (self.enabled and self.capture_device_trace):
            yield
            return
        from ..tools.scope_trace import scope_trace

        with scope_trace(device) as res:
            yield
        self.device_trace = {
            "device_s": res.device_s,
            "device": res.device,
            "phases": res.phase_seconds(),
            "table": [
                {"scope": k, "seconds": s, "launches": n}
                for k, s, n in res.table()
            ],
            "kernels": res.kernel_table(),
            "launches": res.launched,
            "lost_launches": res.lost,
        }

    # --- serialisation ------------------------------------------------
    def _platform(self) -> dict:
        info: dict = {"python": sys.version.split()[0]}
        try:
            import torch
            import torch.distributed as dist

            info["torch"] = torch.__version__
            info["cuda"] = torch.version.cuda
            cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
            info["backend"] = "cuda" if cards else "cpu"
            if dist.is_available() and dist.is_initialized():
                info["process_index"] = dist.get_rank()
                info["process_count"] = dist.get_world_size()
            else:
                info["process_index"] = 0
                info["process_count"] = 1
            info["devices"] = [
                {"id": i, "platform": "gpu", "kind": torch.cuda.get_device_name(i)}
                for i in range(cards)
            ] or [{"id": 0, "platform": "cpu", "kind": "cpu"}]
        except Exception:
            pass  # platform info must never fail a run
        return info

    def to_manifest(
        self, aborted: bool = False, abort_reason: str | None = None
    ) -> dict:
        """The versioned run manifest. Key order is fixed (schema and
        version lead) so manifests diff cleanly in text tools too.
        ``aborted=True`` marks a partial manifest dumped by the flight
        recorder for a run that did not complete."""
        plat = self._platform()
        man = {
            "schema": MANIFEST_SCHEMA,
            "version": MANIFEST_VERSION,
            "run_id": self.run_id,
            "created_unix": self.created_unix,
            "duration_s": round(time.perf_counter() - self._t0, 6),
            "hostname": socket.gethostname(),
            "pid": os.getpid(),
            # per-host shard tags, duplicated from platform so the
            # --merge reader need not reach into nested dicts
            "process_index": int(plat.get("process_index", 0)),
            "process_count": int(plat.get("process_count", 1)),
            "platform": plat,
            "context": self.context,
            "timers": {k: self.timers[k] for k in sorted(self.timers)},
            "counters": {
                k: self.counters[k] for k in sorted(self.counters)
            },
            "gauges": {k: self.gauges[k] for k in sorted(self.gauges)},
            "jit": {},  # the port compiles nothing per shape
            "events": self.events,
            "device_trace": self.device_trace,
        }
        for name, val in self.snapshot_sections().items():
            if name not in man:  # sections can never shadow core keys
                man[name] = val
        if aborted:
            man["aborted"] = True
            man["abort_reason"] = abort_reason
            man["stage_at_abort"] = self.current_stage
            man["progress_at_abort"] = (
                dict(self.progress_state) if self.progress_state else None
            )
        return man

    def write(
        self,
        path: str,
        aborted: bool = False,
        abort_reason: str | None = None,
    ) -> dict:
        """Serialise the manifest to ``path`` (atomic replace) and
        return it."""
        man = self.to_manifest(aborted=aborted, abort_reason=abort_reason)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(man, f, indent=2)
            f.write("\n")
        os.replace(tmp, path)
        return man


NOOP = RunTelemetry(enabled=False)


def load_manifest(path: str) -> dict:
    """Load + validate a telemetry.json manifest."""
    with open(path) as f:
        man = json.load(f)
    if man.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(
            f"{path}: not a {MANIFEST_SCHEMA} manifest "
            f"(schema={man.get('schema')!r})"
        )
    if int(man.get("version", 0)) > MANIFEST_VERSION:
        raise ValueError(
            f"{path}: manifest version {man.get('version')} is newer "
            f"than this reader (supports <= {MANIFEST_VERSION})"
        )
    return man
