"""Cross-process trace correlation: one job, one connected trace (the
port's copy of the JAX package's obs/trace.py).

A job's lifecycle can be scattered across processes: claimed by one
worker, preempted and resumed by another, or fanned out across the
processes of a multi-process run. This module stitches them together:

- a **trace id** (:func:`new_trace_id`) is shared by every process that
  touches the job (the campaign queue mints it at enqueue), so each tags
  its spans with the same id;
- each process appends **span records** to its own ``trace-<worker>.jsonl``
  (single writer per file, one JSON line per finished span: a killed
  process stops appending and never tears the file);
- :func:`export_chrome_trace` merges span files into one Chrome
  trace-event / Perfetto JSON, one track per worker process.

Span sources: the :class:`Tracer` bridges the run's telemetry (stage
transitions become spans, adaptive events become instants), and the
drivers' wave loops mark waves and checkpoint saves through the ambient
:func:`job_span` helper, a no-op (one contextvar read) when no tracer is
active.
"""

from __future__ import annotations

import contextlib
import contextvars
import glob as _glob
import json
import os
import threading
import time
import uuid
import zlib

from .log import get_logger

log = get_logger("obs.trace")

TRACE_SCHEMA = "peasoup_tpu.trace"
TRACE_VERSION = 1

_ACTIVE: contextvars.ContextVar["Tracer | None"] = contextvars.ContextVar(
    "peasoup_tpu_torch_tracer", default=None
)

# telemetry event kinds that flip the stage span (emitted by
# RunTelemetry.set_stage); everything else becomes an instant
_STAGE_KIND = "stage"


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:12]


def current_tracer() -> "Tracer | None":
    return _ACTIVE.get()


@contextlib.contextmanager
def job_span(name: str, cat: str = "job", flow_id=None, **args):
    """Span on the ambient tracer (no-op when none is active) — how
    deep pipeline code marks waves/checkpoints without threading a
    tracer through every signature."""
    tracer = _ACTIVE.get()
    if tracer is None or not tracer.enabled:
        yield
        return
    with tracer.span(name, cat=cat, flow_id=flow_id, **args):
        yield


def flow_id_for(*parts) -> int:
    """Deterministic Perfetto flow id from shared coordinates — every
    rank of a gang computes the SAME id for the same (gang, context,
    round) without any extra exchange, which is what lets the
    leader's barrier-wait span link to each member's wave span."""
    key = "|".join(str(p) for p in parts).encode()
    return zlib.crc32(key) & 0xFFFFFFFF


def job_instant(name: str, **args) -> None:
    tracer = _ACTIVE.get()
    if tracer is not None and tracer.enabled:
        tracer.instant(name, **args)


class Tracer:
    """Span writer for ONE process's view of one trace.

    Spans are written when they END (one line per complete span), so a
    process killed mid-span leaves no torn record. :meth:`close` ends
    any still-open spans (flagged ``"forced_end": true``) — a graceful
    exit therefore never leaves an unclosed span, which is exactly the
    invariant the chaos gate asserts.
    """

    def __init__(
        self,
        path: str,
        trace_id: str,
        worker: str = "",
        enabled: bool = True,
    ) -> None:
        self.path = path
        self.trace_id = trace_id or new_trace_id()
        self.worker = worker
        self.enabled = bool(enabled)
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._open: dict[str, dict] = {}  # span_id -> partial record
        self._stage_span: str | None = None  # open stage span id
        self._attached: list[tuple] = []  # (telemetry, listener)
        self._closed = False

    # --- recording ----------------------------------------------------
    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(line)
        except OSError:
            log.debug("trace append failed: %s", self.path, exc_info=True)

    def _base(
        self, name: str, cat: str, args: dict, flow_id=None
    ) -> dict:
        rec: dict = {
            "trace_id": self.trace_id,
            "span_id": new_span_id(),
            "name": str(name),
            "cat": str(cat),
            "worker": self.worker,
            "pid": self.pid,
            "tid": threading.current_thread().name,
        }
        if flow_id is not None:
            # cross-process link: spans sharing a flow id (e.g. a gang
            # barrier round computed identically on every rank) render
            # as connected arrows in Perfetto
            rec["flow_id"] = int(flow_id)
        if args:
            rec["args"] = args
        return rec

    def begin(
        self, name: str, cat: str = "job", flow_id=None, **args
    ) -> str:
        """Open a span; returns its id for :meth:`end`."""
        if not self.enabled:
            return ""
        rec = self._base(name, cat, args, flow_id=flow_id)
        now_unix = time.time()  # span walls are epochs shared across hosts
        rec["ts_unix"] = now_unix
        rec["_t0"] = time.perf_counter()
        with self._lock:
            self._open[rec["span_id"]] = rec
        return rec["span_id"]

    def end(self, span_id: str, **args) -> None:
        if not (self.enabled and span_id):
            return
        with self._lock:
            rec = self._open.pop(span_id, None)
        if rec is None:
            return
        rec["dur_s"] = round(time.perf_counter() - rec.pop("_t0"), 6)
        if args:
            rec["args"] = {**rec.get("args", {}), **args}
        self._write(rec)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "job", flow_id=None, **args):
        sid = self.begin(name, cat=cat, flow_id=flow_id, **args)
        try:
            yield
        finally:
            self.end(sid)

    def instant(self, name: str, cat: str = "event", **args) -> None:
        if not self.enabled:
            return
        rec = self._base(name, cat, args)
        now_unix = time.time()
        rec["ts_unix"] = now_unix
        rec["dur_s"] = 0.0
        rec["instant"] = True
        self._write(rec)

    def span_at(
        self,
        name: str,
        ts_unix: float,
        dur_s: float,
        cat: str = "sched",
        **args,
    ) -> None:
        """An externally measured span (claim wait, revoke latency):
        the caller supplies the wall-clock start and duration."""
        if not self.enabled:
            return
        rec = self._base(name, cat, args)
        rec["ts_unix"] = float(ts_unix)
        rec["dur_s"] = max(0.0, float(dur_s))
        self._write(rec)

    # --- the telemetry bridge -----------------------------------------
    def attach(self, telemetry) -> None:
        """Subscribe to a RunTelemetry's event stream: ``stage``
        events open/close stage spans, everything else lands as an
        instant — so dedispersion/search/writing spans come for free
        from the stage timers the drivers already maintain."""
        if not self.enabled:
            return
        created_unix = getattr(telemetry, "created_unix", None)
        if created_unix is None:
            created_unix = time.time()

        def _on_event(rec: dict) -> None:
            ts_unix = created_unix + float(rec.get("t", 0.0))
            kind = rec.get("kind", "event")
            args = {
                k: v for k, v in rec.items() if k not in ("t", "kind")
            }
            if kind == _STAGE_KIND:
                with self._lock:
                    prev = self._open.pop(self._stage_span or "", None)
                if prev is not None:
                    prev["dur_s"] = round(
                        time.perf_counter() - prev.pop("_t0"), 6
                    )
                    self._write(prev)
                srec = self._base(
                    f"stage:{args.get('name', '?')}", "stage", {}
                )
                srec["ts_unix"] = ts_unix
                srec["_t0"] = time.perf_counter()
                with self._lock:
                    self._open[srec["span_id"]] = srec
                    self._stage_span = srec["span_id"]
            else:
                irec = self._base(kind, "event", args)
                irec["ts_unix"] = ts_unix
                irec["dur_s"] = 0.0
                irec["instant"] = True
                self._write(irec)

        telemetry.add_listener(_on_event)
        self._attached.append((telemetry, _on_event))

    # --- lifecycle ----------------------------------------------------
    @contextlib.contextmanager
    def activate(self):
        """Make this the ambient tracer (:func:`job_span`)."""
        token = _ACTIVE.set(self if self.enabled else None)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def close(self) -> None:
        """Detach listeners and end any still-open spans (flagged) —
        after close, the file contains no unclosed spans."""
        if self._closed:
            return
        self._closed = True
        for tel, fn in self._attached:
            try:
                tel.remove_listener(fn)
            except Exception:
                pass
        with self._lock:
            open_now = list(self._open.values())
            self._open.clear()
            self._stage_span = None
        for rec in open_now:
            rec["dur_s"] = round(time.perf_counter() - rec.pop("_t0"), 6)
            rec["forced_end"] = True
            self._write(rec)


# --------------------------------------------------------------------------
# reading + export
# --------------------------------------------------------------------------

def trace_paths(job_dir: str) -> list[str]:
    """Every process's span file under one job directory."""
    return sorted(
        _glob.glob(os.path.join(job_dir, "trace-*.jsonl"))
        + _glob.glob(os.path.join(job_dir, "trace.jsonl"))
    )


def load_spans(paths) -> list[dict]:
    """Span records from one or more trace files, time-ordered. Torn
    trailing lines (a writer killed mid-append) are skipped."""
    if isinstance(paths, str):
        paths = [paths]
    out: list[dict] = []
    for path in paths:
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "trace_id" in rec:
                out.append(rec)
    out.sort(key=lambda r: r.get("ts_unix", 0.0))
    return out


def trace_summary(spans: list[dict]) -> dict:
    """Connectivity + hygiene summary: the chaos gate's questions.
    ``connected`` is True when every span shares one trace id;
    ``unclosed`` counts spans that never recorded a duration (a span
    record without ``dur_s`` can only come from a writer bug — killed
    writers simply don't write — so the gate pins it at zero)."""
    trace_ids = sorted({s.get("trace_id", "") for s in spans})
    workers = sorted({s.get("worker", "") for s in spans if s.get("worker")})
    unclosed = sum(
        1 for s in spans
        if not isinstance(s.get("dur_s"), (int, float))
    )
    # flow linkage: a flow id is "linked" when spans from more than
    # one worker process carry it (the gang-barrier invariant)
    flow_workers: dict[int, set] = {}
    for s in spans:
        fid = s.get("flow_id")
        if isinstance(fid, int):
            flow_workers.setdefault(fid, set()).add(
                s.get("worker") or f"pid{s.get('pid', 0)}"
            )
    return {
        "n_spans": len(spans),
        "trace_ids": trace_ids,
        "connected": len(trace_ids) == 1 and bool(spans),
        "workers": workers,
        "unclosed": unclosed,
        "forced_ends": sum(1 for s in spans if s.get("forced_end")),
        "span_names": sorted({s.get("name", "") for s in spans}),
        "n_flows": len(flow_workers),
        "flows_linked": sum(
            1 for ws in flow_workers.values() if len(ws) > 1
        ),
    }


def export_chrome_trace(
    spans: list[dict], extra_instants: list[dict] | None = None
) -> dict:
    """Merge span records into Chrome trace-event JSON (Perfetto
    loads it directly). One "process" track per worker, named via
    metadata events; timestamps are microseconds relative to the
    earliest span so the viewer opens at t=0. ``extra_instants``
    (e.g. autoscale decisions) are campaign-level events rendered on
    their own track: dicts with name/ts_unix[/args]."""
    extra = list(extra_instants or [])
    all_ts = [
        s["ts_unix"]
        for s in spans + extra
        if isinstance(s.get("ts_unix"), (int, float))
    ]
    t0 = min(all_ts) if all_ts else 0.0
    workers = sorted(
        {s.get("worker") or f"pid{s.get('pid', 0)}" for s in spans}
    )
    pid_of = {w: i + 1 for i, w in enumerate(workers)}
    events: list[dict] = []
    for w in workers:
        events.append(
            {
                "ph": "M", "name": "process_name", "pid": pid_of[w],
                "tid": 0, "args": {"name": w},
            }
        )
    flow_members: dict[int, list[dict]] = {}
    for s in spans:
        w = s.get("worker") or f"pid{s.get('pid', 0)}"
        ts_us = (float(s.get("ts_unix", t0)) - t0) * 1e6
        args = dict(s.get("args") or {})
        args["trace_id"] = s.get("trace_id")
        base = {
            "name": s.get("name", "?"),
            "cat": s.get("cat", "job"),
            "pid": pid_of[w],
            "tid": str(s.get("tid", "main")),
            "ts": round(ts_us, 1),
            "args": args,
        }
        if s.get("instant"):
            events.append({**base, "ph": "i", "s": "t"})
        else:
            events.append(
                {
                    **base,
                    "ph": "X",
                    "dur": round(
                        max(0.0, float(s.get("dur_s") or 0.0)) * 1e6, 1
                    ),
                }
            )
            fid = s.get("flow_id")
            if isinstance(fid, int):
                flow_members.setdefault(fid, []).append(base)
    # flow arrows: one s → t... → f chain per flow id, each event
    # bound to (same pid/tid/ts as) the slice that carries the id
    for fid, members in sorted(flow_members.items()):
        if len(members) < 2:
            continue
        members.sort(key=lambda b: b["ts"])
        for i, b in enumerate(members):
            ph = "s" if i == 0 else ("f" if i == len(members) - 1 else "t")
            fev = {
                "name": b["name"],
                "cat": b["cat"],
                "ph": ph,
                "id": fid,
                "pid": b["pid"],
                "tid": b["tid"],
                "ts": b["ts"],
            }
            if ph == "f":
                fev["bp"] = "e"  # bind to enclosing slice
            events.append(fev)
    if extra:
        apid = len(workers) + 1
        events.append(
            {
                "ph": "M", "name": "process_name", "pid": apid,
                "tid": 0, "args": {"name": "campaign"},
            }
        )
        for e in extra:
            events.append(
                {
                    "name": e.get("name", "?"),
                    "cat": e.get("cat", "campaign"),
                    "ph": "i",
                    "s": "p",
                    "pid": apid,
                    "tid": "autoscale",
                    "ts": round(
                        (float(e.get("ts_unix", t0)) - t0) * 1e6, 1
                    ),
                    "args": dict(e.get("args") or {}),
                }
            )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": TRACE_SCHEMA,
            "version": TRACE_VERSION,
            "trace_ids": sorted({s.get("trace_id", "") for s in spans}),
            "t0_unix": t0,
        },
    }
