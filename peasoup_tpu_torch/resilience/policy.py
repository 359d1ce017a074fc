"""Retry, degradation and corrupt-artifact policy (the port's copy of the
JAX package's resilience/policy.py): the one place recovery semantics
live.

- :class:`RetryPolicy`: bounded attempts, exponential backoff with
  deterministic jitter (seeded per site and attempt, so two identical
  runs sleep the same schedule), an optional wall-clock deadline, and a
  telemetry event per decision (``resilience_retry`` /
  ``resilience_recovered`` / ``resilience_giveup``).
- :class:`DegradationLadder`: ordered, observable fallback steps (card
  out of memory -> halve the DM block -> ...). A ladder never climbs back
  up, each step emits a ``degradation`` event with its rung index, and
  exhaustion is explicit (``degradation_exhausted``).
- :func:`load_or_recover`: the single corrupt-artifact recovery: warn,
  quarantine the damaged file to ``<path>.corrupt`` (rename, not
  delete), return a default.
- :func:`guard_thread`: a background thread's body under a crash guard
  that emits ``thread_crashed`` and marks the process degraded.

Every decision is booked twice: a telemetry event (per-run attribution)
and a process-global counter (:data:`~.stats.STATS`, the ``resilience``
status section).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Any, Callable

from ..obs.log import get_logger
from .errors import FATAL, TRANSIENT, classify
from .stats import STATS

log = get_logger("resilience")


def _tel():
    from ..obs.telemetry import current

    return current()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter.

    ``retry_on`` lists the taxonomy classes worth retrying (transient
    only, by default: retrying an out-of-memory error at the same shape
    runs out again, and corrupt artifacts have their own recovery)."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25  # +- fraction of the computed delay
    deadline_s: float | None = None
    retry_on: tuple[str, ...] = (TRANSIENT,)

    def delay(self, attempt: int, site: str = "") -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1)))
        if self.jitter:
            r = random.Random(f"{site}#{attempt}")
            d *= 1.0 + self.jitter * (2.0 * r.random() - 1.0)
        return max(0.0, d)

    def call(self, fn: Callable[..., Any], *args: Any, site: str = "unnamed",
             context: str = "", **kwargs: Any) -> Any:
        """Run ``fn(*args, **kwargs)`` under this policy; re-raises the last
        exception when the budget (attempts or deadline) is spent or the
        failure's class is not retried."""
        t0 = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                out = fn(*args, **kwargs)
            except BaseException as exc:
                cls = classify(exc) if isinstance(exc, Exception) else FATAL
                out_of_budget = attempt >= self.max_attempts or (
                    self.deadline_s is not None
                    and time.monotonic() - t0 >= self.deadline_s
                )
                if cls not in self.retry_on or out_of_budget:
                    if cls in self.retry_on:
                        STATS.giveup(site)
                        _tel().event(
                            "resilience_giveup", site=site, attempts=attempt,
                            error_class=cls, context=context,
                            error=f"{type(exc).__name__}: {exc!s:.200}",
                        )
                        log.warning("%s: giving up after %d attempt(s): %.200s",
                                    site, attempt, exc)
                    raise
                d = self.delay(attempt, site)
                STATS.retry(site)
                _tel().event(
                    "resilience_retry", site=site, attempt=attempt,
                    delay_s=round(d, 4), error_class=cls, context=context,
                    error=f"{type(exc).__name__}: {exc!s:.200}",
                )
                log.warning("%s failed (attempt %d/%d, retry in %.3gs)%s: %.200s",
                            site, attempt, self.max_attempts, d,
                            f" [{context}]" if context else "", exc)
                if d:
                    time.sleep(d)
                continue
            if attempt > 1:
                STATS.recovered(site)
                _tel().event("resilience_recovered", site=site, attempts=attempt,
                             context=context)
            return out

    def wrap(self, site: str):
        """Decorator form of :meth:`call`."""

        def deco(fn):
            def inner(*args, **kwargs):
                return self.call(fn, *args, site=site, **kwargs)

            inner.__name__ = getattr(fn, "__name__", site)
            return inner

        return deco


# the shared defaults: filesystem reads and writes, and sqlite contention
# (at least five attempts, 0.02 s doubling to at most 0.5 s apart);
# PEASOUP_RETRY_MAX sets the budget
_MAX = int(os.environ.get("PEASOUP_RETRY_MAX", "3") or 3)
IO_RETRY = RetryPolicy(max_attempts=_MAX, base_delay_s=0.05)
DB_RETRY = RetryPolicy(max_attempts=max(5, _MAX), base_delay_s=0.02, max_delay_s=0.5)


class DegradationLadder:
    """Ordered fallback steps for one driver run.

    ``rungs`` is the full ordered fallback sequence (top = preferred).
    :meth:`step` records descending to (or repeating) a rung: a ladder can
    step one rung many times (halving the DM block again and again is one
    rung) but never climbs back up. Every step emits a ``degradation``
    event with the ladder's name, the rung, its index and the site's own
    fields, and bumps the global counter; :meth:`exhausted` marks the
    bottom falling through."""

    def __init__(self, name: str, rungs: tuple[str, ...]) -> None:
        self.name = name
        self.rungs = tuple(rungs)
        self._idx = -1  # no degradation yet
        self.steps: list[str] = []

    def step(self, rung: str, **fields) -> None:
        i = self.rungs.index(rung)  # unknown rung: programming error
        if i < self._idx:
            raise ValueError(
                f"ladder {self.name}: cannot climb back up to "
                f"{rung!r} from {self.rungs[self._idx]!r}"
            )
        self._idx = i
        self.steps.append(rung)
        STATS.degradation(self.name, rung)
        _tel().event("degradation", ladder=self.name, rung=rung, rung_index=i,
                     step=len(self.steps), **fields)
        log.warning("degradation %s -> %s (rung %d/%d)",
                    self.name, rung, i + 1, len(self.rungs))

    def exhausted(self, **fields) -> None:
        STATS.giveup(self.name)
        _tel().event(
            "degradation_exhausted", ladder=self.name,
            rung=self.rungs[self._idx] if self._idx >= 0 else None,
            steps=len(self.steps), **fields,
        )

    @property
    def current_rung(self) -> str | None:
        return self.rungs[self._idx] if self._idx >= 0 else None


def quarantine_artifact(path: str) -> str | None:
    """Move a damaged artifact aside to ``<path>.corrupt`` (rename, never
    delete: the torn bytes are the post-mortem). Returns the quarantine
    path, or None when the rename itself failed."""
    qpath = path + ".corrupt"
    try:
        os.replace(path, qpath)
        return qpath
    except OSError:
        return None


def load_or_recover(path: str, loader: Callable[[str], Any], *, default: Any = None,
                    kind: str = "artifact", action: str = "regenerating",
                    quarantine: bool = True, logger=None):
    """``loader(path)``, or ``default``: silently where the file is
    missing (a normal first-run state); after any other failure with a
    warning, the file quarantined to ``*.corrupt`` (where ``quarantine``)
    and a ``corrupt_artifact`` event. A damaged artifact degrades to
    "start over", never to a crash."""
    lg = logger or log
    try:
        return loader(path)
    except FileNotFoundError:
        return default
    except Exception as exc:
        qpath = quarantine_artifact(path) if quarantine else None
        STATS.corrupt_artifact(kind)
        _tel().event(
            "corrupt_artifact", artifact=kind, path=path, quarantined_to=qpath,
            error=f"{type(exc).__name__}: {exc!s:.200}",
        )
        lg.warning("discarding unreadable %s %s (%s: %.200s)%s; %s",
                   kind, path, type(exc).__name__, exc,
                   f"; quarantined to {qpath}" if qpath else "", action)
        return default


def guard_thread(name: str, fn: Callable[[], Any], telemetry=None):
    """Run a background thread's body under a crash guard: an escaping
    exception emits ``thread_crashed`` (on ``telemetry`` where given: the
    ambient telemetry does not cross threads), bumps the global crash
    counter (``degraded`` in every status.json) and logs the traceback.
    Returns the exception (or None), so joiners can surface it."""
    try:
        fn()
        return None
    except Exception as exc:
        STATS.thread_crashed(name)
        tel = telemetry if telemetry is not None else _tel()
        try:
            tel.event("thread_crashed", thread=name,
                      error=f"{type(exc).__name__}: {exc!s:.300}")
        except Exception:
            pass  # a dead telemetry sink must not mask the crash log
        log.error("background thread %r crashed (run continues degraded)",
                  name, exc_info=True)
        return exc
