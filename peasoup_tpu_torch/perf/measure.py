"""The port's measurement primitives (the JAX package's perf/measure.py):
the one path by which the tuner (perf/tuning.py) and the microbenchmarks
(perf/microbench.py) take a time.

* :func:`median` - the true median (the mean of the middle pair for an
  even count);
* :func:`timed_samples` - k host-clock samples of ``call()``, each ending
  with ``torch.cuda.synchronize(device)`` on a CUDA device (the JAX
  package's ``block_until_ready``), with an optional ``prepare()`` outside
  the timed window;
* :func:`event_samples` - k device-anchored samples of ``call()`` between
  two CUDA events on the device's current stream;
* :func:`event_run_samples` - k device-anchored samples, each one event
  pair around a run of back-to-back calls after a warm-up, reported per
  call (the microbenchmarks' timer);
* :func:`device_busy_seconds` - the seconds in which the device ran the
  kernels and copies of one ``run()``, from ``torch.profiler``: the union
  of their intervals (:func:`busy_us`), where the JAX version sums
  durations. Where the JAX version logs and returns 0.0 when its trace
  fails, this one raises.
"""

from __future__ import annotations

import time

import torch


def median(xs) -> float:
    """True median; 0.0 for an empty sample set."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_samples(call, reps: int, prepare=None, device=None) -> list[float]:
    """``reps`` wall-clock samples of ``call()`` in seconds, sorted
    ascending. ``prepare()`` runs before each sample outside the timed
    window. With a CUDA ``device`` each sample ends with
    ``torch.cuda.synchronize(device)``, so it holds the device's work and
    not only its enqueue (the device is synchronised before the first
    sample too)."""
    _sync(device)
    samples = []
    for _ in range(max(1, int(reps))):
        if prepare is not None:
            prepare()
        t0 = time.perf_counter()
        call()
        _sync(device)
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples


def event_samples(call, reps: int, device, prepare=None) -> list[float]:
    """``reps`` device-anchored samples of ``call()`` in seconds, sorted
    ascending: CUDA events recorded on the device's current stream before
    and after each call. Raises ValueError for a device that is not a
    CUDA device: no host clock stands in for the card's."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA events time a CUDA device, not {device}")
    torch.cuda.synchronize(device)
    samples = []
    with torch.cuda.device(device):
        for _ in range(max(1, int(reps))):
            if prepare is not None:
                prepare()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
    samples.sort()
    return samples


def event_run_samples(call, reps: int, device, warmup: int = 3,
                      span_s: float = 2e-3, max_calls: int = 256) -> tuple[list[float], int]:
    """(samples, calls): ``reps`` per-call times of ``call()`` in seconds,
    sorted ascending, each one pair of CUDA events around ``calls``
    back-to-back calls divided by ``calls``. ``warmup`` untimed calls come
    first; ``calls`` is sized from one more timed call so that a sample
    spans about ``span_s`` (at most ``max_calls``). A lone call's event
    pair holds the wrapper's host part and any stall of the host between
    the two records; back to back, the card runs one call while the host
    enqueues the next, so a sample reads the slower of the two per call
    and a stall is shared by every call of the run. Raises ValueError for a
    device that is not a CUDA device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA events time a CUDA device, not {device}")
    with torch.cuda.device(device):
        for _ in range(max(0, int(warmup))):
            call()
        one = event_samples(call, 1, device)[0]
        calls = int(min(max_calls, max(1, -(-span_s // max(one, 1e-9)))))
        torch.cuda.synchronize(device)
        samples = []
        for _ in range(max(1, int(reps))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                call()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / calls)
    samples.sort()
    return samples, calls


def summarize(samples: list[float]) -> dict:
    """The record fields every timing table shares."""
    n = len(samples)
    return {
        "execute_median_s": round(median(samples), 9),
        "execute_min_s": round(samples[0], 9) if samples else 0.0,
        "execute_mean_s": round(sum(samples) / n, 9) if n else 0.0,
        "execute_all_s": [round(s, 9) for s in samples],
        "reps": n,
    }


def busy_us(events) -> float:
    """Microseconds in which the device ran a kernel or a copy, from a
    ``torch.profiler`` trace's FunctionEvents: the union of their
    intervals, so work that overlaps (kernels on other streams, a copy
    beside a kernel) counts once. The ranges of ``record_function``
    scopes, which the trace also holds on the device's timeline, are not
    device work and are left out."""
    from torch.autograd import DeviceType

    from ..utils.trace import union_length

    return float(union_length(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation))


def device_busy_seconds(run, device) -> float:
    """Seconds in which the device ran a kernel or a copy during one
    ``run()`` (:func:`busy_us` of a ``torch.profiler`` trace of it).
    Raises RuntimeError where the trace holds no device time (the
    profiler could not trace the card), and ValueError for a device that
    is not a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device busy time is a CUDA device's, not {device}")
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    busy = busy_us(prof.events())
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time for the run")
    return busy / 1e6
