"""The resilience layer (the port's copy of the JAX package's
resilience/): the error taxonomy, the retry and degradation policy,
corrupt-artifact recovery, deterministic fault injection, revoke tokens
and the process-global ``resilience`` status accounting.

- :mod:`.errors`: transient / resource_exhausted / corrupt / fatal.
- :mod:`.policy`: :class:`RetryPolicy`, :class:`DegradationLadder`,
  :func:`load_or_recover`, :func:`guard_thread`.
- :mod:`.faults`: named fault sites driven by a seeded ``PEASOUP_FAULTS``
  schedule (no cost when disabled).
- :mod:`.revoke`: checkpointed preemption (:func:`check_revoke`).
- :mod:`.stats`: the counters behind the ``resilience`` section of
  status.json and the telemetry manifest.
"""

from . import faults
from .errors import (
    CORRUPT,
    FATAL,
    RESOURCE_EXHAUSTED,
    TRANSIENT,
    CorruptArtifactError,
    TransientIOError,
    WorkerKilled,
    classify,
    is_corrupt,
    is_resource_exhausted,
    is_transient,
)
from .policy import (
    DB_RETRY,
    IO_RETRY,
    DegradationLadder,
    RetryPolicy,
    guard_thread,
    load_or_recover,
    quarantine_artifact,
)
from .revoke import (
    RevokeToken,
    SearchPreempted,
    activate_token,
    check_revoke,
    current_token,
)
from .stats import STATS

__all__ = [
    "RevokeToken",
    "SearchPreempted",
    "activate_token",
    "check_revoke",
    "current_token",
    "CORRUPT",
    "FATAL",
    "RESOURCE_EXHAUSTED",
    "TRANSIENT",
    "CorruptArtifactError",
    "TransientIOError",
    "WorkerKilled",
    "classify",
    "is_corrupt",
    "is_resource_exhausted",
    "is_transient",
    "DB_RETRY",
    "IO_RETRY",
    "DegradationLadder",
    "RetryPolicy",
    "guard_thread",
    "load_or_recover",
    "quarantine_artifact",
    "STATS",
    "faults",
]
