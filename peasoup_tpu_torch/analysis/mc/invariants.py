"""Scenario-side context and invariant helpers.

Scenario task bodies run *interposed* — their module-under-test calls
hit the virtual filesystem — but the scenario file itself is not
patched, so task code must go through :class:`MCContext` (``now`` /
``advance`` / ``mark`` / ``read_json``) or the module APIs, never raw
``os``/``time``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

from .vfs import MCEnv, OpDesc


class InvariantViolation(AssertionError):
    """A scenario invariant failed; the message becomes the finding."""


def require(cond: object, msg: str) -> None:
    if not cond:
        raise InvariantViolation(msg)


@dataclass
class MCContext:
    """What a scenario sees: the env, the campaign root, and ``out`` —
    a scratch dict tasks deposit results into for the invariant.
    (``out`` is safe shared state: only one task thread is ever
    runnable, and task results are deterministic functions of the op
    history the state hash already covers.)"""

    env: MCEnv
    root: str = "/camp"
    out: dict[str, Any] = field(default_factory=dict)

    # -- virtual time --------------------------------------------------
    def now(self) -> float:
        return self.env.clock

    def advance(self, dt: float) -> None:
        """Advance the virtual clock — an explicit scheduling op that
        conflicts with everything (time is ambient)."""
        env = self.env

        def fn() -> None:
            env.clock += dt

        env.op(OpDesc("advance", f"+{dt:g}"), fn)

    def mark(self, label: str) -> None:
        """Drop a trace marker (critical-section boundaries etc.) —
        also a scheduling op, stamped with the current clock."""
        env = self.env
        env.op(OpDesc("mark", f"{label}@{env.clock:g}"), lambda: None)

    # -- direct (invariant-phase) filesystem reads ---------------------
    def read_json(self, path: str) -> Any:
        try:
            return json.loads(self.env.fs.read(path))
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def listdir(self, path: str) -> list[str]:
        return self.env.fs.listdir(path)

    def exists(self, path: str) -> bool:
        return self.env.fs.exists(path)

    def read(self, path: str) -> str | None:
        try:
            return self.env.fs.read(path)
        except FileNotFoundError:
            return None


# -- trace queries ------------------------------------------------------


def count_ops(trace: list[str], kind: str, path: str) -> int:
    """How many times ``kind`` *succeeded* on exactly ``path``."""
    want = f"{kind}:{path}"
    n = 0
    for e in trace:
        _, _, rest = e.partition(":")
        if rest == want:
            n += 1
    return n


def marks(trace: list[str], label: str) -> list[tuple[str, float]]:
    """``(task, clock)`` for every ``mark`` whose label matches."""
    out = []
    for e in trace:
        who, _, rest = e.partition(":")
        if not rest.startswith("mark:"):
            continue
        body = rest[len("mark:") :]
        name, _, clock = body.rpartition("@")
        if name == label:
            out.append((who, float(clock)))
    return out


def cs_intervals(
    trace: list[str], enter: str, exit_: str
) -> list[tuple[str, float, float | None]]:
    """Critical-section intervals from enter/exit marks: ``(task,
    t_enter, t_exit)`` with ``t_exit=None`` for sections never exited
    (killed inside)."""
    open_: dict[str, float] = {}
    out: list[tuple[str, float, float | None]] = []
    for e in trace:
        who, _, rest = e.partition(":")
        if not rest.startswith("mark:"):
            continue
        body = rest[len("mark:") :]
        name, _, clock = body.rpartition("@")
        if name == enter:
            open_[who] = float(clock)
        elif name == exit_ and who in open_:
            out.append((who, open_.pop(who), float(clock)))
    for who, t0 in open_.items():
        out.append((who, t0, None))
    return out
