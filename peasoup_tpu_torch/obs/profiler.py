"""On-demand device profiling of a live worker (the port's copy of the JAX
package's obs/profiler.py, under ``torch.profiler``).

"Which kernel is this worker stuck in" is a question operators ask about
a process they did not start with profiling enabled. The request is a
``profile.request`` file beside a campaign worker's registry entry
(``peasoup-campaign profile``); this module is the worker-side capture: a **bounded**
``torch.profiler`` trace of the process's CUDA work, written as a Chrome
trace into ``outdir`` and announced in the worker's metrics and telemetry,
so the capture itself is observable.

On a host without a card there is no device profile to take, so the
request is acknowledged as a structured no-op unless ``allow_cpu``
forces a trace of the CPU operators.
"""

from __future__ import annotations

import os
import threading
import time

from .log import get_logger

log = get_logger("obs.profiler")

# hard ceiling on a requested capture: profiling costs memory and wall
# time, and a fat-fingered request must not profile for hours
MAX_CAPTURE_S = 60.0
DEFAULT_CAPTURE_S = 5.0


def capture_device_profile(outdir: str, duration_s: float = DEFAULT_CAPTURE_S,
                           allow_cpu: bool = False, telemetry=None) -> dict:
    """Run one bounded ``torch.profiler`` capture into ``outdir``.

    Returns a structured outcome (always: failures are reported, never
    raised, so a broken profiler cannot take the worker down):
    ``{"captured": bool, "skipped": reason|None, "seconds": float,
    "outdir": path|None, "backend": str, "requested_s": float}``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    duration_s = max(0.1, min(float(duration_s), MAX_CAPTURE_S))
    t0 = time.perf_counter()
    backend = "cuda" if torch.cuda.is_available() else "cpu"
    outcome: dict = {"captured": False, "skipped": None, "seconds": 0.0,
                     "outdir": None, "backend": backend, "requested_s": duration_s}
    if backend == "cpu" and not allow_cpu:
        # guarded no-op: the protocol completes, the cost is not paid
        outcome["skipped"] = "cpu backend (no device profile to take)"
        log.info("profile request acknowledged as a no-op on the CPU backend")
        return _announce(outcome, telemetry)
    try:
        os.makedirs(outdir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if backend == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            time.sleep(duration_s)
        # audit: ignore[PSA006] -- an epoch stamp in the trace's file name, not a duration
        path = os.path.join(outdir, f"profile-{os.getpid()}-{int(time.time())}.json")
        prof.export_chrome_trace(path)
        outcome["captured"] = True
        outcome["outdir"] = os.path.abspath(outdir)
        log.info("device profile captured: %.3gs into %s", duration_s, path)
    except Exception as exc:
        outcome["skipped"] = f"{type(exc).__name__}: {exc!s:.200}"
        log.warning("device profile capture failed: %s", exc)
    outcome["seconds"] = round(time.perf_counter() - t0, 3)
    return _announce(outcome, telemetry)


def start_profile_capture(outdir: str, duration_s: float, metrics=None, telemetry=None,
                          allow_cpu: bool = False):
    """Run :func:`capture_device_profile` on a daemon helper thread (under
    the resilience crash guard) so the caller's loop never blocks on the
    capture; announces the outcome in ``metrics`` (an
    obs.metrics.MetricsRecorder). Returns the started thread."""

    def _capture() -> None:
        outcome = capture_device_profile(outdir, duration_s=duration_s,
                                         telemetry=telemetry, allow_cpu=allow_cpu)
        if metrics is not None:
            metrics.counter(
                "profile_captures_total",
                outcome="captured" if outcome.get("captured") else "skipped",
            )
            metrics.gauge("profile_capture_seconds", outcome.get("seconds", 0.0))

    def _guarded() -> None:
        from ..resilience import guard_thread

        guard_thread("campaign-profile", _capture, telemetry=telemetry)

    thread = threading.Thread(target=_guarded, name="campaign-profile", daemon=True)
    thread.start()
    return thread


def _announce(outcome: dict, telemetry) -> dict:
    if telemetry is not None:
        try:
            telemetry.event("device_profile", **outcome)
        except Exception:
            pass
    return outcome
