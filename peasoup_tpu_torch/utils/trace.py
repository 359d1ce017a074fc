"""Tracing and phase timing.

Reference: NVTX ranges via PUSH_NVTX_RANGE/POP_NVTX_RANGE macros
(include/utils/nvtx.hpp:8-24) around the "Dedisperse", "DM-Loop",
"Acceleration-Loop" and "Harmonic summing" spans, plus a gettimeofday
``Stopwatch`` accumulator (include/utils/stopwatch.hpp:9-144) feeding
the overview.xml <execution_times> table.

Here ``trace_span`` opens a ``torch.profiler.record_function`` scope (a
range in a torch.profiler trace, which tools/scope_trace.py attributes
device time to) under the names the search drivers use; ``Stopwatch``
keeps the reference's accumulate-across-starts semantics for the XML
timing table.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from torch.profiler import record_function


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


@contextmanager
def trace_span(name: str, stopwatch: Stopwatch | None = None):
    """Profiler span named like the reference's NVTX ranges, optionally
    accumulating into a Stopwatch for the XML timing table."""
    if stopwatch is not None:
        if stopwatch.name is None:
            stopwatch.name = name  # label mispair errors with the span
        with record_function(name), stopwatch:
            yield
    else:
        with record_function(name):
            yield
