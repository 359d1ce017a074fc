"""The port's command-line entry points, and the JAX CLIs' observability
flags, which the port's FDAS and streaming CLIs take and refuse: the run
telemetry they drive is ROADMAP item A.10."""

from __future__ import annotations

import argparse

# the JAX package's cli/__init__.py:add_observability_args, flag by flag
_OBSERVABILITY = (
    ("--log-level", dict(default=None, choices=["debug", "info", "warning", "error"])),
    ("--metrics-json", dict(default=None)),
    ("--capture-device-trace", dict(action="store_true")),
    ("--status-json", dict(default=None)),
    ("--heartbeat-interval", dict(type=float, default=5.0)),
    ("--no-flight-recorder", dict(action="store_true")),
)


def _dest(flag: str) -> str:
    """argparse's attribute name for a long flag, as every flag here uses."""
    return flag.lstrip("-").replace("-", "_")


def add_observability_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLIs' observability flags; :func:`refuse_observability`
    refuses any that is given."""
    g = p.add_argument_group("observability (ROADMAP A.10, not ported yet)")
    for flag, kw in _OBSERVABILITY:
        g.add_argument(flag, **kw)


def refuse_observability(args: argparse.Namespace, p: argparse.ArgumentParser,
                         *extra: str) -> None:
    """Raise NotImplementedError naming ROADMAP A.10 if an observability
    flag, or one of the ``extra`` flags, was given a value other than its
    default in ``p``."""
    flags = [flag for flag, _ in _OBSERVABILITY] + list(extra)
    given = [f for f in flags
             if getattr(args, _dest(f)) != p.get_default(_dest(f))]
    if given:
        raise NotImplementedError(
            f"not ported yet: {', '.join(given)} (run telemetry is ROADMAP item A.10)"
        )
