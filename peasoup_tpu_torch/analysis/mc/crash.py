"""Crash-point bookkeeping.

Kill tokens (``K<i>``) ride the ordinary decision machinery — a
killable task parked at *any* FS op can be granted a kill instead,
which models SIGKILL between any two filesystem operations — so the
explorer needs no special crash pass. This module only quantifies
the injection surface for the report and the tests.
"""

from __future__ import annotations

from .explorer import Scenario, run_schedule


def is_kill(token: str) -> bool:
    return token.startswith("K")


def kill_target(token: str) -> int:
    return int(token[1:])


def enumerate_crash_points(scenario: Scenario) -> int:
    """How many distinct kill injection points the scenario exposes:
    every FS op a killable task executes in the crash-free baseline
    run is a state the explorer can kill it in instead."""
    killable = {name for name, _, k in scenario.tasks if k}
    if not killable or scenario.max_kills <= 0:
        return 0
    base = run_schedule(scenario, ())
    n = 0
    for entry in base.trace:
        who, _, rest = entry.partition(":")
        if who in killable and not rest.startswith("KILLED:"):
            n += 1
    return n
