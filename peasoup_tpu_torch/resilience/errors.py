"""The transient class of the JAX package's error taxonomy
(resilience/errors.py): the part the candidate database's retries and the
multi-process exchange need.

A transient failure is a flaky filesystem or network moment: sqlite's
``database is locked``/``busy`` under contention, a timeout, an OSError
with a retryable errno, or an explicit :class:`TransientIOError` (a peer
that died at a collective, a gang member that never arrived). Policy: a
bounded retry (:class:`~peasoup_tpu_torch.resilience.policy.RetryPolicy`),
or a failed step that a campaign's attempt budget retries whole.
"""

from __future__ import annotations

import errno as _errno
import sqlite3


class TransientIOError(OSError):
    """An explicitly transient I/O failure. Always classified transient."""


# errnos of a retryable filesystem or network hiccup
_TRANSIENT_ERRNOS = frozenset(
    x for x in (
        _errno.EIO, _errno.EAGAIN, _errno.EINTR, _errno.EBUSY, _errno.ETIMEDOUT,
        getattr(_errno, "ESTALE", None), getattr(_errno, "ECONNRESET", None),
    )
    if x is not None
)


def is_transient(exc: BaseException) -> bool:
    """A TransientIOError, sqlite contention (``locked``/``busy``), a
    timeout, or an OSError with a transient errno. A missing file or a
    denied permission is a protocol state, not a hiccup."""
    if isinstance(exc, TransientIOError):
        return True
    if isinstance(exc, sqlite3.OperationalError):
        msg = str(exc).lower()
        return "locked" in msg or "busy" in msg
    if isinstance(exc, (FileNotFoundError, PermissionError)):
        return False
    if isinstance(exc, TimeoutError):
        return True
    return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS
