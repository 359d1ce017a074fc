"""Structured library logging (the port's copy of the JAX package's
obs/log.py).

The library's informational and warning messages go through children of
the ``peasoup_tpu_torch`` logger (``get_logger("search")`` is
``peasoup_tpu_torch.search``). Importing the package installs a
``NullHandler`` only, so embedded users are silent by default and wire
the logger however their application does; the CLI entry points call
:func:`configure` with the level resolved from ``-v`` / ``--log-level``
(``resolve_level``), which installs a single stderr handler.

Messages always go to **stderr**: stdout is reserved for the CLIs' own
output.
"""

from __future__ import annotations

import logging
import os
import sys

ROOT_LOGGER = "peasoup_tpu_torch"

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

class _StderrHandler(logging.StreamHandler):
    """A stream handler that writes to the stream it was given, or else to
    whatever ``sys.stderr`` is when a record is emitted (so a handler made
    while stderr was redirected never writes to a closed stream)."""

    def __init__(self, stream=None) -> None:
        super().__init__(stream or sys.stderr)
        self._fixed = stream

    @property
    def stream(self):
        return self._fixed or sys.stderr

    @stream.setter
    def stream(self, value) -> None:
        self._fixed = value


# one library-owned handler, reused across configure() calls so repeated
# CLI invocations in one process (tests) never stack duplicate handlers
_handler: logging.StreamHandler | None = None

logging.getLogger(ROOT_LOGGER).addHandler(logging.NullHandler())


def get_logger(name: str | None = None) -> logging.Logger:
    """The library logger, or a dotted child (``get_logger("pipeline")``
    -> ``peasoup_tpu_torch.pipeline``)."""
    return logging.getLogger(
        ROOT_LOGGER if not name else f"{ROOT_LOGGER}.{name}"
    )


def resolve_level(
    log_level: str | int | None, verbose: bool = False
) -> int:
    """Level precedence: explicit ``--log-level`` > ``-v`` (INFO) >
    PEASOUP_LOG_LEVEL env > WARNING."""
    if log_level is None:
        log_level = (
            "info" if verbose else os.environ.get("PEASOUP_LOG_LEVEL")
        )
    if log_level is None:
        return logging.WARNING
    if isinstance(log_level, int):
        return log_level
    try:
        return _LEVELS[str(log_level).strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown log level {log_level!r}; "
            f"expected one of {sorted(_LEVELS)}"
        ) from None


def configure(
    level: str | int | None = None,
    verbose: bool = False,
    stream=None,
) -> logging.Logger:
    """Install (or retune) the stderr handler on the library logger and
    set its threshold. Idempotent: calling again adjusts the level and
    stream on the existing handler instead of stacking a new one."""
    global _handler
    logger = get_logger()
    resolved = resolve_level(level, verbose)
    if _handler is None:
        _handler = _StderrHandler(stream)
        _handler.setFormatter(
            logging.Formatter("[%(levelname)s] %(name)s: %(message)s")
        )
        logger.addHandler(_handler)
    elif stream is not None:
        _handler.setStream(stream)
    logger.setLevel(resolved)
    return logger
