"""Search progress reporting.

Reference: ``ProgressBar`` spawns a detached pthread that polls a shared
completion fraction every 100 ms and prints percentage + ETA
(include/utils/progress_bar.hpp:7-44), fed by the DMDispenser
(src/pipeline_multi.cu:57-68).

Here progress is event-driven instead of polled: the search driver owns
the loop over DM blocks, so it can update the bar after each device
step without a thread. Output format (percent + ETA) matches the
reference's. Frames go to **stderr** by default — the reference writes
``\\r`` frames to stdout, which corrupts piped/machine-readable output;
stdout stays reserved for data.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, stream=None, min_interval: float = 0.1) -> None:
        self._stream = stream if stream is not None else sys.stderr
        self._min_interval = min_interval
        self._t0 = 0.0
        self._last = 0.0
        self._active = False
        self._done = False

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._last = 0.0
        self._active = True
        self._done = False

    def update(self, fraction: float) -> None:
        """fraction in [0, 1]; rate-limited like the 100 ms poll. The
        final (100%) frame bypasses the rate limit — it must always
        render — but renders exactly once however many times completion
        is reported."""
        if not self._active:
            return
        now = time.perf_counter()
        if fraction >= 1.0:
            if self._done:
                return
            self._done = True
        elif now - self._last < self._min_interval:
            return
        self._last = now
        elapsed = now - self._t0
        if fraction > 0:
            eta = elapsed / fraction * (1.0 - fraction)
            eta_str = f"{eta:.1f} s"
        else:
            eta_str = "..."
        self._stream.write(
            f"\rComplete: {100.0 * fraction:.1f}%  ETA: {eta_str}   "
        )
        self._stream.flush()

    def stop(self) -> None:
        if not self._active:
            return
        self.update(1.0)
        self._stream.write("\n")
        self._stream.flush()
        self._active = False
