"""The error taxonomy every recovery decision routes through (the port's
copy of the JAX package's resilience/errors.py).

Four classes, each with its policy:

- **transient**: flaky I/O (EIO/EAGAIN/short read mid-append), sqlite
  ``database is locked``/``busy`` under contention, filesystem races, a
  peer that died at a collective. Policy: bounded retry with backoff
  (:class:`~peasoup_tpu_torch.resilience.policy.RetryPolicy`).
- **resource_exhausted**: the card out of memory. Policy:
  descend the degradation ladder
  (:class:`~peasoup_tpu_torch.resilience.policy.DegradationLadder`);
  retrying the same shape would run out again.
- **corrupt**: a torn, truncated or garbage artifact (checkpoint, tuning
  cache). Policy: warn, quarantine the file (``*.corrupt``) and
  regenerate (:func:`~peasoup_tpu_torch.resilience.policy.load_or_recover`).
- **fatal**: everything else. Policy: raise.

The card's out-of-memory forms are torch's: the caching allocator's
:class:`torch.OutOfMemoryError`, and cuFFT failing to allocate a plan's
work area (a RuntimeError naming ``CUFFT_ALLOC_FAILED``); the drivers'
memory ladders step on them (pipeline/search.py:_is_oom is this
module's :func:`is_resource_exhausted`). Unlike the JAX package's, a
host MemoryError is not one of them: halving the card's blocks frees no
host memory, so it stays fatal.
"""

from __future__ import annotations

import errno as _errno
import json
import sqlite3

import torch

TRANSIENT = "transient"
RESOURCE_EXHAUSTED = "resource_exhausted"
CORRUPT = "corrupt"
FATAL = "fatal"


class TransientIOError(OSError):
    """An explicitly transient I/O failure (short read of a growing file,
    injected flaky read, a peer that died at a collective). Always
    classified TRANSIENT."""


class CorruptArtifactError(Exception):
    """A loader detected a torn/invalid artifact. Always CORRUPT."""


class WorkerKilled(BaseException):
    """Simulated SIGKILL for fault injection: derives from BaseException
    so no ``except Exception`` recovery path can observe it, exactly like
    a real kill."""


# errnos of a retryable filesystem or network hiccup, not a broken
# program or a genuinely missing resource
_TRANSIENT_ERRNOS = frozenset(
    x for x in (
        _errno.EIO, _errno.EAGAIN, _errno.EINTR, _errno.EBUSY, _errno.ETIMEDOUT,
        getattr(_errno, "ESTALE", None), getattr(_errno, "ECONNRESET", None),
    )
    if x is not None
)

_CORRUPT_TYPES = (json.JSONDecodeError, EOFError, UnicodeDecodeError)


def is_resource_exhausted(exc: BaseException) -> bool:
    """The card ran out of memory: torch.OutOfMemoryError, or cuFFT's
    CUFFT_ALLOC_FAILED."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and "CUFFT_ALLOC_FAILED" in str(exc)


def _is_sqlite_contention(exc: BaseException) -> bool:
    if not isinstance(exc, sqlite3.OperationalError):
        return False
    msg = str(exc).lower()
    return "locked" in msg or "busy" in msg


def is_corrupt(exc: BaseException) -> bool:
    if isinstance(exc, (CorruptArtifactError, *_CORRUPT_TYPES)):
        return True
    # zipfile/np.load damage without importing zipfile eagerly
    if type(exc).__name__ in ("BadZipFile", "BadZipfile", "UnpicklingError"):
        return True
    from ..obs.schema import SchemaError

    return isinstance(exc, SchemaError)


def is_transient(exc: BaseException) -> bool:
    """A TransientIOError, sqlite contention (``locked``/``busy``), a
    timeout, or an OSError with a transient errno. A missing file or a
    denied permission is a protocol state, not a hiccup."""
    if isinstance(exc, TransientIOError):
        return True
    if _is_sqlite_contention(exc):
        return True
    if isinstance(exc, (FileNotFoundError, PermissionError)):
        return False
    if isinstance(exc, TimeoutError):  # OSError subclass: check first
        return True
    return isinstance(exc, OSError) and exc.errno in _TRANSIENT_ERRNOS


def classify(exc: BaseException) -> str:
    """Map an exception to its taxonomy class (out-of-memory first, as in
    the JAX package)."""
    if is_resource_exhausted(exc):
        return RESOURCE_EXHAUSTED
    if is_transient(exc):
        return TRANSIENT
    if is_corrupt(exc):
        return CORRUPT
    return FATAL
