"""Bounded retry with backoff: the retry part of the JAX package's
resilience/policy.py, which the candidate database's transactions need
(concurrent writers can meet sqlite's ``database is locked`` past its busy
timeout, and each transaction is idempotent, so it is retried whole).

Ported here: :class:`RetryPolicy` (attempts, exponential backoff with
jitter seeded by site and attempt; sqlite contention, timeouts and
transient OSErrors are retried, anything else raised at once) and
:data:`DB_RETRY`, with the ``PEASOUP_RETRY_MAX`` knob. The rest of the JAX
module (``DegradationLadder``, ``IO_RETRY``, corrupt-artifact recovery,
thread guards, the telemetry events and counters each decision records,
the fault-injection seams) is ROADMAP item A.10; a retry is logged on the
``peasoup_tpu_torch.resilience`` logger.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import time
from typing import Any, Callable

from .errors import is_transient

log = logging.getLogger("peasoup_tpu_torch.resilience")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry of transient failures with exponential backoff and
    deterministic jitter (seeded from site and attempt, so two identical
    runs sleep the same schedule)."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25  # +- fraction of the computed delay

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
        exception when the attempts are spent or the failure is not
        transient."""
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except Exception as exc:
                transient = is_transient(exc)
                if not transient or attempt >= self.max_attempts:
                    if transient:
                        log.warning("%s: giving up after %d attempt(s): %.200s",
                                    site, attempt, exc)
                    raise
                d = self.delay(attempt, site)
                log.warning("%s failed (attempt %d/%d, retry in %.3gs)%s: %.200s",
                            site, attempt, self.max_attempts, d,
                            f" [{context}]" if context else "", exc)
                if d:
                    time.sleep(d)


# the JAX package's shared sqlite policy: at least five attempts, 0.02 s
# doubling to at most 0.5 s apart; PEASOUP_RETRY_MAX raises the budget
_MAX = int(os.environ.get("PEASOUP_RETRY_MAX", "3") or 3)
DB_RETRY = RetryPolicy(max_attempts=max(5, _MAX), base_delay_s=0.02, max_delay_s=0.5)
