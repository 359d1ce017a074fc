"""Tracing and phase timing: the port's one span-and-counter recorder.

Reference: NVTX ranges via PUSH_NVTX_RANGE/POP_NVTX_RANGE macros
(include/utils/nvtx.hpp:8-24) around the "Dedisperse", "DM-Loop",
"Acceleration-Loop" and "Harmonic summing" spans, plus a gettimeofday
``Stopwatch`` accumulator (include/utils/stopwatch.hpp:9-144) feeding
the overview.xml <execution_times> table.

``trace_span`` names a part of a run. While no ``torch.profiler``
session records (``torch._C._autograd._profiler_enabled()``, the default)
it costs one flag check: it enters no ``record_function``, reads no clock
beyond its optional ``Stopwatch`` and records nothing, and
``trace_count`` does nothing. While a session records (the benchmark's
``--trace 1``, a CLI's ``--capture-device-trace``) a span opens a
``record_function`` scope under its name (a range in the trace, which
tools/scope_trace.py attributes device time to) and, when it closes, adds
to the table of the root span it lies in (``root=True``; each
``PeasoupSearch.run`` opens the root ``Search``, so a table is one
observation's): its calls, host wall seconds (``perf_counter``), thread
CPU seconds (``thread_time``), each call's start and end on the
profiler's clock (unix nanoseconds, ``time.time_ns``: the clock of
``prof.events()`` plus the trace's start), the counts ``trace_count``
added while it was the innermost open span, and, for a span opened with
a CUDA ``device=``, the card's stream seconds from its start to its end, read
from two CUDA events when the table closes (after the run's own stage
syncs). :func:`run_tables` keeps the last :data:`RUN_TABLES_KEPT` tables.

``Stopwatch`` keeps the reference's accumulate-across-starts semantics
for the XML timing table. :func:`union_length`, :func:`gaps` and
:class:`Innermost` are the interval arithmetic that names a trace's idle
gaps by the innermost span open in each part of them.
"""

from __future__ import annotations

import bisect
import threading
import time
from array import array
from collections import deque

import torch
from torch.profiler import record_function

# true while a torch.profiler session records (one call into torch's C core)
_recording = torch._C._autograd._profiler_enabled

RUN_TABLES_KEPT = 256
_tables: deque = deque(maxlen=RUN_TABLES_KEPT)
_n_tables = 0
_local = threading.local()


class Stopwatch:
    """Accumulating monotonic timer (stopwatch.hpp:9-144 semantics:
    stop() adds to the running total; reset() clears). Durations come
    from ``perf_counter``, not the wall clock.

    Also a context manager: ``with sw:`` is start()/stop(). An optional
    ``name`` labels the span in error messages — stopping a stopwatch
    that is not running (e.g. a second stop()) raises naming it, so a
    mispaired timer points at the span that broke, not a bare
    traceback."""

    def __init__(self, name: str | None = None) -> None:
        self.name = name
        self._total = 0.0
        self._t0: float | None = None

    def _label(self) -> str:
        return f" {self.name!r}" if self.name else ""

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            raise RuntimeError(
                f"Stopwatch{self._label()} stopped while not running: "
                "start() it first (each stop() needs its own start(); "
                "a second stop() on the same span is a bug)"
            )
        self._total += time.perf_counter() - self._t0
        self._t0 = None

    def reset(self) -> None:
        self._total = 0.0
        self._t0 = None

    def getTime(self) -> float:  # noqa: N802 - reference method name
        return self._total

    @property
    def elapsed(self) -> float:
        return self._total

    def __enter__(self) -> "Stopwatch":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class SpanStats:
    """One span's totals in a run's table, under one parent."""

    __slots__ = ("name", "parent", "calls", "wall_s", "cpu_s", "device_s", "counters",
                 "starts", "ends", "_events")

    def __init__(self, name: str, parent: str | None) -> None:
        self.name, self.parent = name, parent
        self.calls = 0
        self.wall_s = self.cpu_s = 0.0
        self.device_s: float | None = None  # read at the table's close
        self.counters: dict[str, int] = {}
        self.starts, self.ends = array("q"), array("q")  # each call's, unix ns
        self._events: list = []  # (start, end) CUDA events of a device span

    def as_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent, "calls": self.calls,
                "wall_s": self.wall_s, "cpu_s": self.cpu_s, "device_s": self.device_s,
                "counters": dict(self.counters),
                "start_ns": self.starts[0], "end_ns": self.ends[-1]}


class RunTable:
    """The spans and counters of one root span (one observation's search):
    :class:`SpanStats` by (name, parent). The accessors sum a name over its
    parents and return None where the table has no such span."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.spans: dict[tuple[str, str | None], SpanStats] = {}
        self.start_ns = self.end_ns = 0

    def _of(self, name: str) -> list[SpanStats]:
        return [s for (n, _), s in self.spans.items() if n == name]

    def _sum(self, name: str, field: str):
        vals = [getattr(s, field) for s in self._of(name)]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    def calls(self, name: str) -> int:
        return sum(s.calls for s in self._of(name))

    def wall_s(self, name: str) -> float | None:
        return self._sum(name, "wall_s")

    def cpu_s(self, name: str) -> float | None:
        return self._sum(name, "cpu_s")

    def device_s(self, name: str) -> float | None:
        """The card's stream seconds of a span opened with ``device=``;
        None off the card."""
        return self._sum(name, "device_s")

    def count(self, counter: str) -> int:
        """A counter's total over every span."""
        return sum(s.counters.get(counter, 0) for s in self.spans.values())

    def counters(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for s in self.spans.values():
            for k, v in s.counters.items():
                out[k] = out.get(k, 0) + v
        return out

    def intervals(self) -> list[tuple[int, int, str]]:
        """Every call of every span as (start ns, end ns, name)."""
        return [(a, b, s.name) for s in self.spans.values()
                for a, b in zip(s.starts, s.ends)]

    def as_dict(self) -> dict:
        return {"root": self.root, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "spans": [s.as_dict() for s in self.spans.values()],
                "counters": self.counters()}

    def _add(self, span: "_Span", wall: float, cpu: float, end_ns: int) -> None:
        key = (span.name, span.parent)
        st = self.spans.get(key)
        if st is None:
            st = self.spans[key] = SpanStats(span.name, span.parent)
        st.calls += 1
        st.wall_s += wall
        st.cpu_s += cpu
        st.starts.append(span.start_ns)
        st.ends.append(end_ns)
        for k, v in span.counters.items():
            st.counters[k] = st.counters.get(k, 0) + v
        if span.events is not None:
            st._events.append(span.events)

    def _close(self, start_ns: int, end_ns: int) -> None:
        """Read the device spans' CUDA events: each ended before a stage
        sync of the run, so none waits here."""
        self.start_ns, self.end_ns = start_ns, end_ns
        for st in self.spans.values():
            if st._events:
                for _, end in st._events:
                    if not end.query():
                        end.synchronize()
                st.device_s = sum(a.elapsed_time(b) for a, b in st._events) / 1e3
                st._events = []


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    """An open span while a profiler records (see the module docstring)."""

    __slots__ = ("name", "stopwatch", "device", "root", "parent", "table", "counters",
                 "events", "stream", "rf", "start_ns", "cpu0", "wall0")

    def __init__(self, name, stopwatch, device, root) -> None:
        self.name, self.stopwatch, self.device, self.root = name, stopwatch, device, root

    def __enter__(self) -> RunTable | None:
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.name if up is not None else None
        self.table = RunTable(self.name) if self.root else (up.table if up else None)
        self.counters = {}
        self.events = None
        if self.stopwatch is not None:
            self.stopwatch.start()
        self.rf = record_function(self.name)
        self.rf.__enter__()
        # next to the record_function event's own start
        self.start_ns = time.time_ns()
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        stack.append(self)
        self.cpu0 = time.thread_time()
        self.wall0 = time.perf_counter()
        return self.table

    def __exit__(self, exc_type, exc, tb) -> None:
        wall = time.perf_counter() - self.wall0
        cpu = time.thread_time() - self.cpu0
        end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        _stack().pop()
        self.rf.__exit__(exc_type, exc, tb)
        if self.stopwatch is not None:
            self.stopwatch.stop()
        if self.table is not None:
            self.table._add(self, wall, cpu, end_ns)
            if self.root and exc_type is None:
                global _n_tables
                self.table._close(self.start_ns, end_ns)
                _tables.append(self.table)
                _n_tables += 1


class _Off:
    """A span while no profiler records: nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


class _OffTimed:
    """A span while no profiler records: its stopwatch alone."""

    __slots__ = ("stopwatch",)

    def __init__(self, stopwatch: Stopwatch) -> None:
        self.stopwatch = stopwatch

    def __enter__(self) -> None:
        self.stopwatch.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stopwatch.stop()


_OFF = _Off()


def trace_span(name: str, stopwatch: Stopwatch | None = None, *,
               device: torch.device | None = None, root: bool = False):
    """A span named like the reference's NVTX ranges (a context manager),
    optionally accumulating into a Stopwatch for the XML timing table.
    ``device``: the torch.device whose current stream the span's device
    seconds are read on (none are read off a CUDA device). ``root``: the span opens a run's table; ``with`` yields it
    (None while no profiler records), complete once the block has closed."""
    if stopwatch is not None and stopwatch.name is None:
        stopwatch.name = name  # label mispair errors with the span
    if not _recording():
        return _OFF if stopwatch is None else _OffTimed(stopwatch)
    return _Span(name, stopwatch, device, root)


def trace_count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (nothing
    while no profiler records)."""
    if not _recording():
        return
    stack = _stack()
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + int(n)


def run_tables() -> list[RunTable]:
    """The tables of the last :data:`RUN_TABLES_KEPT` runs recorded (root
    spans closed under a profiler without an error), oldest first."""
    return list(_tables)


def recorded_runs() -> int:
    """How many runs' tables were recorded in this process so far."""
    return _n_tables


def union_length(intervals) -> float:
    """Length of the union of [start, end) intervals: overlaps count once."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi) -> list[tuple]:
    """The parts of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Innermost:
    """The innermost span open at any time of a set of (start, end, name)
    spans: ``at(t)`` is its name, or None where none is open."""

    def __init__(self, spans) -> None:
        edges = sorted([(s, 1, n) for s, _, n in spans] + [(e, 0, n) for _, e, n in spans],
                       key=lambda x: (x[0], x[1]))
        self.times, self.labels, stack = [], [], []
        for t, opening, name in edges:
            if opening:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            self.times.append(t)
            self.labels.append(stack[-1] if stack else None)

    def at(self, t) -> str | None:
        i = bisect.bisect_right(self.times, t) - 1
        return self.labels[i] if i >= 0 else None

    def split(self, lo, hi) -> list[tuple]:
        """[lo, hi) cut where the innermost span changes: (start, end, name)."""
        out, at = [], lo
        for i in range(bisect.bisect_right(self.times, lo), len(self.times)):
            t = self.times[i]
            if t >= hi:
                break
            if t > at:
                out.append((at, t, self.at(at)))
                at = t
        out.append((at, hi, self.at(at)))
        return out
