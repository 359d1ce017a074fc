"""Protocol model checking (audit engine 5).

Runs the *real* file-backed protocol code — ``campaign/queue.py``,
``campaign/registry.py``, ``campaign/tenants.py``, ``obs/alerts.py``
— against a deterministic in-memory filesystem interposed at the
``os``/``open`` seam, with a cooperative scheduler that
context-switches simulated workers at every filesystem operation and
systematically explores interleavings (DFS with state-hash
deduplication and conflict-based partial-order reduction) plus
crash-point injection (``WorkerKilled`` between any two FS ops,
modelling SIGKILL mid-protocol).

Invariant violations surface as PSM3xx findings through the standard
findings/baseline framework, each carrying a minimized schedule
string that replays bit-identically (:func:`explorer.replay`).
"""

from .explorer import Scenario, explore, replay, run_schedule
from .invariants import InvariantViolation, MCContext
from .scenarios import MCReport, run_mc, scenario_names, scenarios
from .vfs import MCEnv, VirtualFS, interpose

__all__ = [
    "InvariantViolation",
    "MCContext",
    "MCEnv",
    "MCReport",
    "Scenario",
    "VirtualFS",
    "explore",
    "interpose",
    "replay",
    "run_mc",
    "run_schedule",
    "scenario_names",
    "scenarios",
]
